"""Declarative node/edge-objective graph optimization API.

Capability parity with the reference SnapVX demo
(``/root/reference/Decentral_WQ_admm.py:7-61``), which builds a ``TGraphVX``
with ``AddNode(i, 0.5||A_i x - b_i||^2 + 0.5 x^T W_i x)`` and
``AddEdge(i, j, 0.5 (x_i - x_j)^T Q (x_i - x_j))`` and calls
``Solve(UseADMM=True)``. This module exposes the same declarative shape —
quadratic/LS node objectives with optional TV, diagonal-quadratic edge
objectives — and lowers it onto the TPU consensus-ADMM runtime.

Math note: edge objectives are *soft* quadratic penalties (no hard consensus
constraint). ADMM edge-splitting introduces copies z_ij = (z_i, z_j) with
constraints x_i = z_i, x_j = z_j; for the diagonal quadratic edge function
0.5 (z_i - z_j)^T diag(q) (z_i - z_j) the edge minimization has the
per-pixel closed form

    z_i = (a_i + a_j)/2 + rho/(2q + rho) * (a_i - a_j)/2,   a_i = x_i + y_i,

a damped midpoint that reduces to exact consensus as q -> inf — the
edge-split ADMM of the flagship loop is literally this solver's q -> inf
limit.

Example
-------
    gp = GraphProblem(n_side=8)
    for i in range(P):
        gp.add_node(A=A_i, b=b_i, diag_quad=w_i)
    gp.add_edge(0, 1, q_diag)
    x = gp.solve(rho=1.0, max_iters=50)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dip_admm_tpu.config import NodeSolverConfig
from dip_admm_tpu.core import node_solver

_HIGHEST = jax.lax.Precision.HIGHEST  # f32 dense operators, not TF32


@dataclasses.dataclass
class _Node:
    A: Optional[np.ndarray]  # [m_i, n] (None for matrix-free problems)
    b: np.ndarray  # [m_i]
    diag_quad: Optional[np.ndarray]  # [n] -> + 0.5 x^T diag(w) x
    lam_tv: float


class GraphProblem:
    """Build a graph optimization problem node-by-node, edge-by-edge.

    ``operators=(fwd, adj, opnorms)`` switches the node data terms to a
    batched matrix-free measurement operator family (fwd: [P, n] -> [P, m],
    adj its exact adjoint, opnorms [P] bounds on ||A_i^T A_i||) — e.g. the
    radon projector family from ``data.loader.make_node_ops`` — in which
    case ``add_node`` takes only the per-node data ``b`` (+ diag/TV terms).
    """

    def __init__(self, n_side: int, operators=None):
        self.N = n_side
        self.n = n_side * n_side
        self._nodes: list[_Node] = []
        self._edges: dict[tuple[int, int], np.ndarray] = {}
        self._ops = operators

    def add_node(
        self,
        A: Optional[np.ndarray] = None,
        b: np.ndarray = None,
        diag_quad: Optional[np.ndarray] = None,
        lam_tv: float = 0.0,
    ) -> int:
        """Node objective: 0.5||A x - b||^2 + 0.5 x^T diag(w) x + lam_tv TV(x)
        (the reference demo's node objective at ``Decentral_WQ_admm.py:37-45``,
        extended with the TV option and per-node TV weights). With
        ``operators=`` set on the problem, omit ``A``."""
        assert b is not None
        if self._ops is None:
            assert A is not None and A.shape[1] == self.n
            assert A.shape[0] == b.shape[0]
            A = np.asarray(A)
        else:
            assert A is None, "matrix-free GraphProblem: nodes take only b"
        self._nodes.append(_Node(A, np.asarray(b), diag_quad, lam_tv))
        return len(self._nodes) - 1

    def add_edge(self, i: int, j: int, q_diag: np.ndarray | float = 1.0) -> None:
        """Edge objective 0.5 (x_i - x_j)^T diag(q) (x_i - x_j)
        (ref ``Decentral_WQ_admm.py:47-53``)."""
        q = np.broadcast_to(np.asarray(q_diag, dtype=np.float32), (self.n,))
        key = (min(i, j), max(i, j))
        self._edges[key] = q

    def solve(
        self,
        rho: float = 1.0,
        max_iters: int = 50,
        eps_pri: float = 1e-6,
        eps_dual: float = 1e-6,
        inner: NodeSolverConfig | None = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Run consensus ADMM (ref ``Solve(UseADMM=True, MaxIters=50,
        Rho=1.0)``, ``Decentral_WQ_admm.py:56``). Returns (x [P, n], history).
        """
        P = len(self._nodes)
        if P == 0:
            raise ValueError("no nodes declared")
        n = self.n
        inner = inner or NodeSolverConfig(max_inner=200, check_every=25)

        m_max = max(nd.b.shape[0] for nd in self._nodes)
        b = np.zeros((P, m_max), np.float32)
        diag = np.zeros((P, n), np.float32)
        lam = np.zeros((P,), np.float32)
        for i, nd in enumerate(self._nodes):
            b[i, : nd.b.shape[0]] = nd.b
            lam[i] = nd.lam_tv
            if nd.diag_quad is not None:
                diag[i] = nd.diag_quad

        Q = np.zeros((P, P, n), np.float32)
        adjm = np.zeros((P, P), np.float32)
        for (i, j), q in self._edges.items():
            Q[i, j] = Q[j, i] = q
            adjm[i, j] = adjm[j, i] = 1.0

        if self._ops is None:
            A = np.zeros((P, m_max, n), np.float32)
            for i, nd in enumerate(self._nodes):
                A[i, : nd.A.shape[0]] = nd.A
            gram_norm = np.asarray(
                [np.linalg.norm(Ai.T @ Ai, 2) for Ai in A], np.float32
            )
            A_arg, mf_ops = jnp.asarray(A), None
        else:
            fwd_mf, adj_mf, opn = self._ops
            gram_norm = np.asarray(opn, np.float32)
            A_arg, mf_ops = jnp.zeros((P, 1, 1), jnp.float32), (fwd_mf, adj_mf)

        st, hist = _solve_jit(
            A_arg, mf_ops, jnp.asarray(b), jnp.asarray(diag),
            jnp.asarray(Q), jnp.asarray(adjm), jnp.asarray(lam),
            jnp.asarray(gram_norm), rho, eps_pri, eps_dual,
            N=self.N, max_iters=max_iters, inner_cfg=inner,
        )
        return st.x, {kk: np.asarray(v) for kk, v in hist.items()}


@functools.partial(
    jax.jit, static_argnames=("mf_ops", "N", "max_iters", "inner_cfg")
)
def _solve_jit(
    A, mf_ops, b, diag, Q, adjm, lam, gram_norm, rho, eps_pri, eps_dual,
    N: int, max_iters: int, inner_cfg: NodeSolverConfig,
):
    """Jitted soft-edge consensus ADMM. All device data enters as arguments
    (never closed over — closures bake multi-GB constants into the lowered
    module); one compilation is shared across ``solve`` calls of the same
    static shape/config. ``mf_ops`` (hashable static): optional batched
    matrix-free (fwd, adj) replacing the dense stack ``A``."""
    P, n = b.shape[0], diag.shape[1]
    dtype = jnp.float32
    m_max = b.shape[1]

    # Node smooth part: 0.5||Ax-b||^2 + 0.5 x^T diag x — the diagonal
    # quadratic rides along as sqrt(diag) rows stacked under the
    # measurement operator, so one fwd/adj pair serves the whole term.
    sq = jnp.sqrt(diag)  # [P, n]
    base_fwd = (
        (lambda x: jnp.einsum("pmn,pn->pm", A, x, precision=_HIGHEST))
        if mf_ops is None
        else mf_ops[0]
    )
    base_adj = (
        (lambda r: jnp.einsum("pmn,pm->pn", A, r, precision=_HIGHEST))
        if mf_ops is None
        else mf_ops[1]
    )

    def fwd(x):
        return jnp.concatenate([base_fwd(x), sq * x], axis=1)

    def adj(r):
        return base_adj(r[:, :m_max]) + sq * r[:, m_max:]

    b_full = jnp.concatenate([b, jnp.zeros((P, n), dtype)], axis=1)

    # Lipschitz bound: ||A^T A|| + max(diag) + rho * degree (the copy
    # constraints add rho*I per incident edge).
    degree = jnp.sum(adjm, axis=1)
    L = gram_norm + jnp.max(diag, axis=1) + rho * degree

    # Node penalty metric: identity per incident edge (copy constraints
    # x_i = z_ij,i), realized through the D/b_cons interface of the
    # batched node solver.
    D_vec = jnp.broadcast_to(degree[:, None], (P, n))

    # Soft-fusion damping factor per (i, j, pixel).
    damp = rho / (2.0 * Q + rho) * adjm[:, :, None]
    am = adjm[:, :, None]

    fprecond = None
    if inner_cfg.algorithm == "fcv":
        # Circulant metric over the stacked operator [A; sqrt(diag)] —
        # built once (D_vec is constant across outer iterations).
        fprecond = node_solver.build_fourier_precond(
            fwd, adj, D_vec, rho, inner_cfg, N
        )

    def body(carry):
        st, Z, Y, k, _, h = carry
        V = (Z - Y) * am
        b_cons = jnp.sum(V, axis=1)
        c_quad = jnp.sum(V * V, axis=(1, 2))
        eps_k = jnp.asarray(1e-3, dtype) / (k.astype(dtype) + 1.0)
        res = node_solver.solve_nodes(
            fwd, adj, b_full, D_vec, b_cons, c_quad,
            lam, rho, L, st, eps_k, inner_cfg, N, fprecond=fprecond,
        )
        X = res.state.x
        A_prop = X[:, None, :] + Y
        A_T = jnp.swapaxes(A_prop, 0, 1)
        mid = 0.5 * (A_prop + A_T)
        Zn = (mid + 0.5 * damp * (A_prop - A_T)) * am
        Yn = (Y + X[:, None, :] - Zn) * am
        dpri = (X[:, None, :] - Zn) * am
        r2 = jnp.sum(dpri * dpri)
        dz = (Zn - Z) * am
        s2 = rho**2 * jnp.sum(dz * dz)
        h = {
            "primal": h["primal"].at[k].set(jnp.sqrt(r2)),
            "dual": h["dual"].at[k].set(jnp.sqrt(s2)),
            "objective": h["objective"].at[k].set(jnp.sum(res.objective)),
        }
        stop = (jnp.sqrt(r2) < eps_pri) & (jnp.sqrt(s2) < eps_dual)
        return res.state, Zn, Yn, k + 1, stop, h

    def cond(carry):
        _, _, _, k, stop, _ = carry
        return (k < max_iters) & ~stop

    st0 = node_solver.init_state(P, N, b_full.shape[1], dtype)
    Z0 = jnp.zeros((P, P, n), dtype)
    Y0 = jnp.zeros((P, P, n), dtype)
    h0 = {
        "primal": jnp.full((max_iters,), jnp.nan, dtype),
        "dual": jnp.full((max_iters,), jnp.nan, dtype),
        "objective": jnp.full((max_iters,), jnp.nan, dtype),
    }
    st, Z, Y, k, stop, hist = jax.lax.while_loop(
        cond, body, (st0, Z0, Y0, jnp.int32(0), jnp.asarray(False), h0)
    )
    return st, hist
