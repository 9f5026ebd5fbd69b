"""Decentralized edge-consensus ADMM — the core runtime.

JAX rebuild of ``/root/reference/block_6_admm_loop_ver2.py:15-326``.
The reference's per-node Python loop (``:81``) becomes one batched node solve
(``core.node_solver``); its per-edge dict loops (``:210-230``) become dense
masked tensor updates over ``z[i, j, :]`` / ``y[i, j, :]``; the sequential
outer loop with early stopping (``:69``, ``:286-289``) becomes a
``lax.while_loop`` writing preallocated history arrays.

Update equations (ADMM_Algo.pdf eqs. 1-6):
  node update  : argmin 0.5||A_i x - b_i||^2 + lam*TV + (rho/2)sum_j ||x-v_ij||^2_Q
                 with v_ij = z_ij - y_ij,i              (eq. 1)
  edge fusion  : z_ij = (W_i a_i + W_j a_j) / (W_i + W_j), a_i = x_i + y_ij,i
                 (eq. 2 "weighted"; the reference *executes* the unweighted
                 midpoint (a_i+a_j)/2, ``ver2:221-222`` — both are exposed,
                 default matches the executed midpoint)
  dual update  : y_ij,i += x_i - z_ij                   (eq. 3)
  residuals    : r^2 = sum_edges ||x_i - z||^2 + ||x_j - z||^2,
                 s^2 = rho^2 sum_edges ||z+ - z||^2     (eqs. 4-5)
  stop         : pri < eps_pri and dual < eps_dual      (eq. 6)

The per-pixel masks enter exactly as in the reference: they zero Q in the
node subproblem, while z/y/residual updates run on full vectors over the
*union* graph edges (SURVEY §5 communication-pattern note).

The iteration body is written against a tiny ``CommOps`` abstraction so the
single-device path (axis transposes) and the sharded path
(``parallel.admm_sharded``: all_to_all + psum over the node mesh axis) share
one implementation.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dip_admm_tpu.config import AdmmConfig
from dip_admm_tpu.core import node_solver
from dip_admm_tpu.core.node_solver import NodeState
from dip_admm_tpu.data.loader import Problem


_identity = lambda v: v  # noqa: E731


class CommOps(NamedTuple):
    """Collective hooks shared by the single-device and sharded loops.

    The iteration body is written against these so one implementation serves
    three layouts: local (all identities), a 1-D node mesh, and a 2-D
    node x pixel mesh where the [P_loc, P, n_loc] edge state (Z/Y/Q — the
    device-memory ceiling at many nodes) is additionally sharded along the pixel axis
    while node solves keep full images.

    - ``pair_transpose``: [P_loc, P, n_loc] -> value at the swapped (j, i)
      pair (all_to_all over the node axis).
    - ``psum``: total reduction of pixel-PARTIAL quantities (node [+ pixel]).
    - ``any_reduce``: cross-shard boolean OR (inner-solve trip lockstep).
    - ``psum_repl``: node-axis reduction of pixel-REPLICATED quantities
      (node-solve outputs: objectives, measurement/image MSE).
    - ``pmax_repl``: node-axis max of pixel-replicated quantities (the
      scalar ``eps_target`` history slot is the max over ALL nodes' targets
      — under eps_rel the targets are per node, and a shard-local max fed
      to a replicated out-spec would leave shards disagreeing).
    - ``psum_pixel``: pixel-axis completion of per-node partial sums.
    - ``gather_pixels``: [..., n_loc] -> [..., n] (all_gather, pixel axis).
    - ``my_pixels``: [..., n] -> [..., n_loc] (this shard's pixel block).
    """

    pair_transpose: Callable[[jnp.ndarray], jnp.ndarray]
    psum: Callable[[jnp.ndarray], jnp.ndarray]
    any_reduce: Callable[[jnp.ndarray], jnp.ndarray]
    psum_repl: Callable[[jnp.ndarray], jnp.ndarray] = _identity
    pmax_repl: Callable[[jnp.ndarray], jnp.ndarray] = _identity
    psum_pixel: Callable[[jnp.ndarray], jnp.ndarray] = _identity
    gather_pixels: Callable[[jnp.ndarray], jnp.ndarray] = _identity
    my_pixels: Callable[[jnp.ndarray], jnp.ndarray] = _identity


LOCAL_COMM = CommOps(
    pair_transpose=lambda M: jnp.swapaxes(M, 0, 1),
    psum=_identity,
    any_reduce=_identity,
)


class AdmmState(NamedTuple):
    node: NodeState  # x [P_loc, n] + TV duals (warm start)
    Z: jnp.ndarray  # [P_loc, P, n] edge consensus variables
    Y: jnp.ndarray  # [P_loc, P, n] scaled duals y_{(ij), i}
    k: jnp.ndarray  # outer iteration counter
    stop: jnp.ndarray  # convergence flag
    # Effective rho as a MULTIPLIER of cfg.rho (residual balancing,
    # cfg.adapt_rho). 1.0 when off — kept as a multiplier so old
    # checkpoints (which lack the field) resume exactly, and the off path
    # stays bit-identical (rho_k = cfg.rho, no scaling applied).
    rho_scale: jnp.ndarray


class NodeBlockData(NamedTuple):
    """Per-shard problem slice consumed by the iteration body."""

    fwd: Callable  # [P_loc, n] -> [P_loc, m]
    adj: Callable  # [P_loc, m] -> [P_loc, n]
    b: jnp.ndarray  # [P_loc, m]
    Q: jnp.ndarray  # [P_loc, P, n] masked precisions
    adjm: jnp.ndarray  # [P_loc, P] union adjacency (float mask)
    W_own: jnp.ndarray  # [P_loc, n] own fusion weights
    W_all: jnp.ndarray  # [P, n] all nodes' weights (replicated)
    L: jnp.ndarray  # [P_loc] Lipschitz bounds
    x_true: jnp.ndarray  # [n]
    N: int
    g_scale: jnp.ndarray = None  # [P_loc] ||A_i^T b_i|| (eps_rel anchor)
    # Circulant metric for algorithm="fcv" (built once per run outside the
    # while_loop — the symbol/steps depend only on the operator and Q).
    fprecond: node_solver.FourierPrecond = None


HISTORY_FIELDS = (
    # name, per-node?
    ("primal", False),
    ("dual", False),
    ("pri_per_node", True),
    ("dual_per_node", True),
    ("obj_per_node", True),
    ("obj_total", False),
    ("mse_sino_per_node", True),
    ("mse_sino_total", False),
    ("img_mse_per_node", True),
    ("img_mse_total", False),
    ("g_norm", True),
    ("eps_target", False),
    ("eps_per_node", True),
    ("inner_iters", True),
    # per-node acceptance code: 0 = accepted at eps_k, 1 = plateau exit,
    # 2 = budget exhausted (the reference's accept/tighten/retry
    # accounting, block_6_admm_loop_ver2.py:155-176 — see
    # node_solver.NodeSolveResult.accept_code)
    ("accept_code", True),
    # effective rho this iteration (constant cfg.rho unless adapt_rho)
    ("rho", False),
)


def make_history(T: int, P_loc: int, dtype=jnp.float32) -> dict:
    hist = {}
    for name, per_node in HISTORY_FIELDS:
        shape = (T, P_loc) if per_node else (T,)
        hist[name] = jnp.full(shape, jnp.nan, dtype)
    return hist


def grow_history(hist: dict, max_iters: int) -> dict:
    """NaN-pad history buffers along the iteration axis to ``max_iters``
    (resuming a checkpoint written under a config with fewer outer
    iterations). Buffers already at least that long pass through."""
    out = {}
    for name, v in hist.items():
        cur = v.shape[0]
        if cur >= max_iters:
            out[name] = v
        else:
            pad = jnp.full((max_iters - cur,) + v.shape[1:], jnp.nan, v.dtype)
            out[name] = jnp.concatenate([v, pad], axis=0)
    # (Fields added after a checkpoint was written are backfilled by
    # serialization._upgrade_history at load time.)
    return out


def consensus_update(X, Z, Y, adjm, W_own, W_all, cfg: AdmmConfig,
                     pair_transpose):
    """Edge fusion, dual update and residual parts (eqs. 2-5).

    X [P_loc, n_loc]: this shard's pixel block of the new node iterates;
    Z, Y [P_loc, P, n_loc]; adjm [P_loc, P] union-adjacency mask; W_own
    [P_loc, n_loc] / W_all [P, n_loc] fusion weights. Returns (Zn, Yn,
    pri_part, dz2_part) with the squared-residual parts [P_loc] summed over
    this shard's pixels only. XLA fuses the chain into a few passes over
    the edge state.
    """
    am = adjm[:, :, None]
    # --- edge fusion z-update (eq. 2 / ref ver2:210-223) ---
    # Over-relaxation (Boyd sec. 3.4.3): x̂_ij = alpha*x_i + (1-alpha)*z_ij
    # replaces x_i in the z/y updates and residuals; alpha=1 is the
    # reference algorithm. a_i = x̂_ij + y_ij,i laid out [i_loc, j, n_loc].
    if cfg.relax_alpha != 1.0:
        Xh = cfg.relax_alpha * X[:, None, :] + (1.0 - cfg.relax_alpha) * Z
        A_prop = Xh + Y
    else:
        A_prop = X[:, None, :] + Y
    A_T = pair_transpose(A_prop)  # [i_loc, j, n] -> a_j = x̂_j + y_ij,j
    if cfg.z_fusion == "weighted":
        Wi = W_own[:, None, :]
        Wj = W_all[None, :, :]
        Zn = (Wi * A_prop + Wj * A_T) / (Wi + Wj)
    elif cfg.z_fusion == "midpoint":
        Zn = 0.5 * (A_prop + A_T)
    else:
        raise ValueError("z_fusion must be 'midpoint' or 'weighted'")
    Zn = Zn * am

    # --- dual update (eq. 3 / ref ver2:225-230): y + x̂ - z = a - z ---
    Yn = (A_prop - Zn) * am

    # --- residuals (eqs. 4-5 / ref ver2:232-264): x̂ - z = a - y - z ---
    dpri = (A_prop - Y - Zn) * am
    dz = (Zn - Z) * am
    return (
        Zn, Yn, jnp.sum(dpri * dpri, axis=(1, 2)), jnp.sum(dz * dz, axis=(1, 2))
    )


def admm_iteration(
    data: NodeBlockData,
    cfg: AdmmConfig,
    comm: CommOps,
    state: AdmmState,
    hist: dict,
) -> tuple[AdmmState, dict]:
    """One outer consensus iteration over this shard's node block.

    Edge-state tensors (Z/Y/Q) may carry only this shard's pixel block
    (n_loc = n on the local and 1-D node-mesh paths); node-solve tensors
    always carry full images — ``comm`` bridges the two layouts.
    """
    P_loc = data.Q.shape[0]
    k = state.k
    X, Z, Y = state.node.x, state.Z, state.Y

    # Effective rho this iteration (residual balancing, cfg.adapt_rho).
    # The off branch is STATIC python: rho_k is the config constant and no
    # scaling ops enter the graph — bit-identical to fixed-rho builds.
    if cfg.adapt_rho:
        rho_k = cfg.rho * state.rho_scale
    else:
        rho_k = cfg.rho

    # --- neighbor terms for the node subproblems (ref ver2:85-95) ---
    V = Z - Y  # v_ij = z_ij - y_ij,i
    D_vec = comm.gather_pixels(jnp.sum(data.Q, axis=1))  # [P_loc, n]
    b_cons = comm.gather_pixels(jnp.sum(data.Q * V, axis=1))
    c_quad = comm.psum_pixel(jnp.sum(data.Q * V * V, axis=(1, 2)))

    # Node-solve constants under a drifted rho: the Lipschitz bound gains
    # (rho_k - rho0) * max_p D, and the fcv certified step scales by
    # min(1, rho0/rho_k) — S(rho) = H_A/2 + rho D/2 + sigma K^T K satisfies
    # lam_max(M^-1 S(rho)) <= lam_max(M^-1 S(rho0)) * max(1, rho/rho0)
    # (the rho term is at most the whole of S(rho0) scaled), so the scaled
    # step stays certified without re-running Lanczos in the loop.
    L_k = data.L
    fprecond_k = data.fprecond
    if cfg.adapt_rho:
        L_k = data.L + (rho_k - cfg.rho) * jnp.max(D_vec, axis=1)
        if fprecond_k is not None:
            fprecond_k = fprecond_k._replace(
                step=fprecond_k.step
                * jnp.minimum(1.0, cfg.rho / rho_k).astype(
                    fprecond_k.step.dtype
                )
            )

    # --- inexact node solve with adaptive target (ref ver2:100-176) ---
    decay = (k.astype(X.dtype) + 1.0) ** (1.0 + cfg.node.gamma_decay)
    eps_k = cfg.node.eps0 / decay
    if cfg.node.eps_rel > 0:
        # Data-scale-relative schedule: eps0 is an absolute constant the
        # reference tuned at 64^2 — unreachable at 256^2+, so
        # acceptance never fires and the budget rules. Anchoring the target
        # at eps_rel * ||A_i^T b_i|| per node gives a scale-free schedule
        # that fires at every problem size; the looser of the two targets
        # applies (the absolute one preserves small-scale reference
        # behavior).
        eps_k = jnp.maximum(eps_k, cfg.node.eps_rel * data.g_scale / decay)
    nstate = state.node if cfg.node.warm_start else node_solver.init_state(
        P_loc, data.N, data.b.shape[1], X.dtype
    )._replace(x=state.node.x)
    if cfg.adapt_rho and fprecond_k is not None:
        # The fcv solver folds min(tk, certified step) into the warm-carried
        # tk, so a rho-scaled (smaller) step would RATCHET: after a high-rho
        # excursion the carried tk stays small even when rho returns to
        # baseline. Reset tk to the fresh sentinel each outer iteration —
        # the current iteration's scaled certified step applies cleanly, and
        # the in-solve divergence monitor still protects within the solve.
        nstate = nstate._replace(
            tk=jnp.full_like(nstate.tk, jnp.inf)
        )
    res = node_solver.solve_nodes(
        data.fwd, data.adj, data.b, D_vec, b_cons, c_quad,
        cfg.lam_tv, rho_k, L_k, nstate, eps_k, cfg.node, data.N,
        any_reduce=comm.any_reduce,
        fprecond=fprecond_k,
    )
    Xn = res.state.x

    # --- metrics in measurement and image space (ref ver2:189-206) ---
    r_meas = data.fwd(Xn) - data.b
    mse_sino = jnp.sum(r_meas * r_meas, axis=1)  # squared norms, like ref
    err = Xn - data.x_true[None, :]
    img_mse = jnp.sum(err * err, axis=1)

    Zn, Yn, pri_part, dz2_part = consensus_update(
        comm.my_pixels(Xn), Z, Y, data.adjm, comm.my_pixels(data.W_own),
        comm.my_pixels(data.W_all), cfg, comm.pair_transpose,
    )
    r2 = comm.psum(jnp.sum(pri_part))
    s2 = 0.5 * rho_k**2 * comm.psum(jnp.sum(dz2_part))
    # Per-node history values need the pixel-axis completion of the
    # partial sums (identity on the local / node-mesh paths).
    pri_node = comm.psum_pixel(pri_part)
    dual_node = rho_k**2 * comm.psum_pixel(dz2_part)
    pri_norm = jnp.sqrt(r2)
    dual_norm = jnp.sqrt(s2)

    # Node-solve outputs are replicated along the pixel axis: reduce over
    # the node axis only (== comm.psum everywhere except the 2-D mesh).
    obj_total = comm.psum_repl(jnp.sum(res.objective))
    mse_sino_total = comm.psum_repl(jnp.sum(mse_sino))
    img_mse_total = comm.psum_repl(jnp.sum(img_mse))

    updates = {
        "primal": pri_norm,
        "dual": dual_norm,
        "pri_per_node": jnp.sqrt(pri_node),
        "dual_per_node": jnp.sqrt(dual_node),
        "obj_per_node": res.objective,
        "obj_total": obj_total,
        "mse_sino_per_node": mse_sino,
        "mse_sino_total": mse_sino_total,
        "img_mse_per_node": img_mse,
        "img_mse_total": img_mse_total,
        "g_norm": res.g_norm,
        # scalar slot: the loosest target over ALL nodes (cross-shard max —
        # the slot's out-spec is replicated, so every shard must write the
        # same value); eps_per_node: the eps actually applied to each node
        # (differs under eps_rel) — the reference stores per-node eps used,
        # block_6_admm_loop_ver2.py:310-326.
        "eps_target": comm.pmax_repl(jnp.max(jnp.atleast_1d(eps_k))),
        "eps_per_node": jnp.broadcast_to(
            jnp.atleast_1d(eps_k).astype(X.dtype), (P_loc,)
        ),
        # per-node iterations to first acceptance (check_every granularity;
        # reference per-node SCS counts, block_6_admm_loop_ver2.py:130-132)
        "inner_iters": res.inner_iters.astype(X.dtype),
        "accept_code": res.accept_code.astype(X.dtype),
        "rho": jnp.asarray(rho_k, X.dtype),
    }
    hist = {
        name: arr.at[k].set(updates[name].astype(arr.dtype))
        for name, arr in hist.items()
    }

    stop = (pri_norm < cfg.eps_pri) & (dual_norm < cfg.eps_dual)

    # --- residual balancing (Boyd sec. 3.4.1), AFTER this iteration's
    # residuals: grow rho when primal dominates, shrink when dual does;
    # the scaled duals Y absorb the inverse factor (y = lambda/rho).
    # r2/s2 are psummed, so every shard computes the same factor.
    rho_scale = state.rho_scale
    if cfg.adapt_rho:
        if cfg.adapt_rho_mode == "stall":
            # Quality-signal policy: raise rho when the primal residual has
            # plateaued over the last ``rho_stall_window`` outers (checked
            # at that cadence; never lowered). The primal slot at k was
            # written above, and the k-w row is live history on every path
            # (local, sharded — the slot is psummed, hence replicated), so
            # no extra loop-carry state is needed and checkpoints resume
            # exactly through the carried history.
            w = cfg.rho_stall_window
            due = ((k + 1) % w == 0) & (k + 1 >= 2 * w)
            prev = hist["primal"][jnp.maximum(k - w, 0)].astype(
                pri_norm.dtype
            )
            stalled = pri_norm > (1.0 - cfg.rho_stall_tol) * prev
            factor = jnp.where(due & stalled, cfg.rho_tau, 1.0).astype(
                rho_scale.dtype
            )
        elif cfg.adapt_rho_mode == "balance":
            factor = jnp.where(
                pri_norm > cfg.rho_mu * dual_norm, cfg.rho_tau,
                jnp.where(
                    dual_norm > cfg.rho_mu * pri_norm, 1.0 / cfg.rho_tau, 1.0
                ),
            ).astype(rho_scale.dtype)
        else:
            raise ValueError(
                "adapt_rho_mode must be 'balance' or 'stall'"
            )
        new_scale = jnp.clip(
            rho_scale * factor, 1.0 / cfg.rho_clamp, cfg.rho_clamp
        )
        Yn = Yn * (rho_scale / new_scale)
        rho_scale = new_scale

    new_state = AdmmState(
        node=res.state, Z=Zn, Y=Yn, k=k + 1, stop=stop, rho_scale=rho_scale
    )
    return new_state, hist


def _block_data(problem: Problem, cfg: AdmmConfig, dtype) -> NodeBlockData:
    # Lipschitz bound for the node solves: ||A^T A|| + rho * max_p sum_j Q.
    L = problem.opnorm + cfg.rho * jnp.max(
        jnp.sum(problem.Q, axis=1), axis=-1
    )
    # Per-node data scale for the eps_rel schedule (hoisted out of the
    # while_loop: one adjoint application per run, not per iteration).
    g_scale = jnp.linalg.norm(problem.adjoint(problem.b), axis=1)
    fprecond = None
    if cfg.node.algorithm == "fcv":
        fprecond = node_solver.build_fourier_precond(
            problem.forward, problem.adjoint,
            jnp.sum(problem.Q, axis=1), cfg.rho, cfg.node, problem.N,
        )
    return NodeBlockData(
        fwd=problem.forward,
        adj=problem.adjoint,
        b=problem.b,
        Q=problem.Q,
        adjm=problem.adj.astype(dtype),
        W_own=problem.W,
        W_all=problem.W,
        L=L,
        x_true=problem.x_true,
        N=problem.N,
        g_scale=g_scale,
        fprecond=fprecond,
    )


class AdmmResult(NamedTuple):
    x: jnp.ndarray  # [P, n] final per-node reconstructions
    history: dict  # preallocated arrays; rows >= n_iters are NaN
    n_iters: jnp.ndarray
    state: AdmmState


def init_state(problem: Problem, cfg: AdmmConfig) -> tuple[AdmmState, dict]:
    """Fresh loop state + history buffers (also the checkpoint payload)."""
    dtype = problem.b.dtype
    P, n, N = problem.num_nodes, problem.n, problem.N
    state = AdmmState(
        node=node_solver.init_state(P, N, problem.m_flat, dtype),
        Z=jnp.zeros((P, P, n), dtype),
        Y=jnp.zeros((P, P, n), dtype),
        k=jnp.int32(0),
        stop=jnp.asarray(False),
        rho_scale=jnp.asarray(1.0, dtype),
    )
    return state, make_history(cfg.max_iters, P, dtype)


def run_admm(
    problem: Problem,
    cfg: AdmmConfig | None = None,
    state: AdmmState | None = None,
    hist: dict | None = None,
    until: int | None = None,
) -> AdmmResult:
    """Single-device (or single-shard) consensus ADMM driver.

    Resumable: pass the ``state``/``history`` of a previous (possibly
    partial) run to continue from iteration ``state.k`` — the JAX
    equivalent of the reference's chunked warm-started solves
    (``block_6_admm_loop.py:14-69``) and the basis for checkpoint/resume.
    ``until`` caps this call's final outer iteration (default
    ``cfg.max_iters``).
    """
    cfg = cfg if cfg is not None else problem.cfg.admm
    if state is None:
        state, hist = init_state(problem, cfg)
    assert hist is not None
    until = cfg.max_iters if until is None else min(until, cfg.max_iters)
    return _run_admm_jit(problem, cfg, state, hist, until)


@functools.partial(jax.jit, static_argnums=(1,))
def _run_admm_jit(
    problem: Problem, cfg: AdmmConfig, state: AdmmState, hist: dict, until
) -> AdmmResult:
    # ``until`` is traced (only compared against the iteration counter), so
    # segmented runs (snapshots, resume) share one compilation.
    dtype = problem.b.dtype
    data = _block_data(problem, cfg, dtype)

    def cond(carry):
        st, _ = carry
        return (st.k < until) & ~st.stop

    def body(carry):
        st, h = carry
        return admm_iteration(data, cfg, LOCAL_COMM, st, h)

    state, hist = jax.lax.while_loop(cond, body, (state, hist))
    return AdmmResult(x=state.node.x, history=hist, n_iters=state.k, state=state)


def run_admm_snapshots(
    problem: Problem,
    cfg: AdmmConfig | None = None,
    snapshot_dir: str | None = None,
    snapshot_every: int | None = None,
    snapshot_div: int = 10,
    mesh=None,
) -> AdmmResult:
    """Run with periodic host-side snapshots of every node's reconstruction
    (ref ``block_6_admm_loop_ver2.py:28-32``, ``:269-281``): the jitted loop
    executes in ``snapshot_every``-iteration segments and the images are
    written between segments (.npy + .png). With ``mesh`` the segments run
    through the sharded driver (same ``state/hist/until`` contract, one
    compilation across segments)."""
    from dip_admm_tpu.utils import artifacts

    cfg = cfg if cfg is not None else problem.cfg.admm
    if snapshot_every is None:
        snapshot_every = max(1, cfg.max_iters // snapshot_div)
    if mesh is not None:
        from dip_admm_tpu.parallel import admm_sharded

        runner = functools.partial(admm_sharded.run_admm_sharded, mesh=mesh)
    else:
        runner = run_admm
    state, hist = init_state(problem, cfg)
    res = None
    while True:
        upto = min(int(state.k) + snapshot_every, cfg.max_iters)
        res = runner(problem, cfg, state=state, hist=hist, until=upto)
        state, hist = res.state, res.history
        if snapshot_dir is not None:
            artifacts.save_recons(
                np.asarray(res.x), problem.N, snapshot_dir,
                f"iter_{int(state.k):04d}",
            )
        if bool(state.stop) or int(state.k) >= cfg.max_iters:
            break
    if snapshot_dir is not None:
        artifacts.flush_async()
    return res


def run_admm_batched(
    problem: Problem,
    b_batch: jnp.ndarray,
    x_true_batch: jnp.ndarray | None = None,
    cfg: AdmmConfig | None = None,
) -> AdmmResult:
    """Scenario batching: solve the same operator/graph against a batch of
    sinogram sets (vmapped whole-run; config 4, batched phantoms — the
    reference's multi-phantom lists are solved one at a time,
    ``block_2_load_odl_data.py:134-145``).

    b_batch: [B, P, m]; x_true_batch: [B, n] (defaults to the problem's).
    Returns an AdmmResult with a leading batch axis on every array.
    """
    cfg = cfg if cfg is not None else problem.cfg.admm
    if x_true_batch is None:
        x_true_batch = jnp.broadcast_to(
            problem.x_true[None], (b_batch.shape[0],) + problem.x_true.shape
        )
    return _run_admm_batched_jit(problem, cfg, b_batch, x_true_batch)


@functools.partial(jax.jit, static_argnums=1)
def _run_admm_batched_jit(problem, cfg, b_batch, x_true_batch):
    import dataclasses as _dc

    def one(b, x_true):
        prob = _dc.replace(problem, b=b, x_true=x_true)
        state, hist = init_state(prob, cfg)
        return _run_admm_jit(prob, cfg, state, hist, cfg.max_iters)

    return jax.vmap(one)(b_batch, x_true_batch)
