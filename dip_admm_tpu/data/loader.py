"""Problem construction: operators, phantoms, sinograms, weights, graphs.

JAX rebuild of the reference data layer
(``/root/reference/block_2_load_odl_data.py:99-253`` build-mode loader and
``block_2_test.py:15-167`` pickle-mode loader): instead of ODL operators and
pickled dense matrices, a ``Problem`` pytree carries padded per-node angle
sets for the batched Joseph projector, optionally a padded dense operator
stack ``A [P, m_max*D, n]`` (dense mode — the reference's native
representation, fastest for small N), per-pixel precision weights W/Q, the
per-pixel communication masks, and the noisy sinograms
``b_i = A_i x_true + sigma * eps`` (ref ``block_2_test.py:54-60``).

The measurement layout is angle-major like the reference's flattened
sinograms: row r = angle * n_det + det. Ragged per-node angle counts are
padded to ``m_max`` with zero rows (masked noise, zero operator rows), which
is exact — padded rows contribute nothing to A^T A or A^T b.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dip_admm_tpu.config import GeometryConfig, ProblemConfig
from dip_admm_tpu.graph import precisions, topology
from dip_admm_tpu.ops import phantoms, radon

# Dense-mode operators are f32; a tensor-core GPU would otherwise round
# their products to TF32.
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Problem:
    """All device-resident problem data (a pytree; ``cfg`` is static).

    ``mode`` selects the measurement-operator implementation:
      - "dense"    : padded dense stack A [P, m, n] — batched matrix
                     products (the reference's representation, N <= 128).
      - "joseph"   : matrix-free gather-based Joseph projector (exact 2-tap
                     kernel; the correctness oracle).
      - "fft"      : matrix-free FFT-shear projector with dense per-angle
                     phase tables (ops.radon_fft / ops.radon_fan).
      - "fft_skew" : the same operator with the phase tables factored into
                     row-block and detector-block tap products.
    """

    cfg: ProblemConfig = dataclasses.field(metadata=dict(static=True))
    mode: str = dataclasses.field(metadata=dict(static=True))
    angles: jnp.ndarray  # [P, m_max]
    angle_valid: jnp.ndarray  # [P, m_max] bool
    A: Optional[jnp.ndarray]  # [P, m_max * D, n] dense mode only
    b: jnp.ndarray  # [P, m_max * D] flattened noisy sinograms
    W: jnp.ndarray  # [P, n] column-norm weights
    Q: jnp.ndarray  # [P, P, n] per-pixel masked precisions
    keep: jnp.ndarray  # [P, P, n] bool per-pixel masks
    adj: jnp.ndarray  # [P, P] bool union adjacency
    x_true: jnp.ndarray  # [n]
    opnorm: jnp.ndarray  # [P] estimates of ||A_i^T A_i||_2
    # fft mode only: per-node geometry phase/evaluation tables (arrays with a
    # leading node axis; ~100 MB/node at 256^2) — precomputing them is the
    # difference between ~16 ms and ~2 ms per normal-operator application.
    fft_tables: Optional[dict] = None

    @property
    def num_nodes(self) -> int:
        return self.cfg.geometry.num_nodes

    @property
    def N(self) -> int:
        return self.cfg.geometry.N

    @property
    def n(self) -> int:
        return self.cfg.geometry.n

    @property
    def m_flat(self) -> int:
        return self.b.shape[1]

    @property
    def dense(self) -> bool:
        return self.mode == "dense"

    # -- batched forward / adjoint operators --------------------------------

    def forward(self, x: jnp.ndarray) -> jnp.ndarray:
        """[P, n] images -> [P, m_max * D] measurements."""
        fwd, _ = make_node_ops(
            self.mode, self.cfg.geometry, self.angles, self.angle_valid,
            self.A, self.fft_tables,
        )
        return fwd(x)

    def adjoint(self, r: jnp.ndarray) -> jnp.ndarray:
        """[P, m_max * D] residuals -> [P, n] backprojections."""
        _, adj = make_node_ops(
            self.mode, self.cfg.geometry, self.angles, self.angle_valid,
            self.A, self.fft_tables,
        )
        return adj(r)


def make_node_ops(
    mode: str, geo: GeometryConfig, angles, valid, A=None, tables=None
):
    """Batched per-node (forward, adjoint) callables for a projector mode.

    Shared by the Problem methods and the shard_map runtime (which passes
    per-shard angle/operator blocks).
    """
    N, D = geo.N, geo.n_det
    if mode == "dense":
        fwd = lambda x: jnp.einsum("pmn,pn->pm", A, x, precision=_HIGHEST)
        adj = lambda r: jnp.einsum("pmn,pm->pn", A, r, precision=_HIGHEST)
    elif mode == "joseph":
        fwd = lambda x: jax.vmap(
            lambda im, a, v: radon.project(geo, im, a, v)
        )(x.reshape(-1, N, N), angles, valid).reshape(x.shape[0], -1)
        adj = lambda r: jax.vmap(
            lambda s, a, v: radon.backproject(geo, s, a, v)
        )(r.reshape(r.shape[0], -1, D), angles, valid).reshape(r.shape[0], -1)
    elif mode == "fft_skew":
        if geo.fan_beam:
            from dip_admm_tpu.ops import radon_fan as proj_mod

            if tables is None:
                tables = proj_mod.precompute_fan_skew(geo, angles, valid)
            fwd = lambda x: proj_mod.project_nodes_fan_skew(
                geo, x.reshape(-1, N, N), tables
            ).reshape(x.shape[0], -1)
            adj = lambda r: proj_mod.backproject_nodes_fan_skew(
                geo, r.reshape(r.shape[0], -1, D), tables
            ).reshape(r.shape[0], -1)
        else:
            from dip_admm_tpu.ops import radon_fft as proj_mod

            if tables is None:
                tables = proj_mod.precompute_skew(geo, angles, valid)
            fwd = lambda x: proj_mod.project_nodes_skew(
                geo, x.reshape(-1, N, N), tables
            ).reshape(x.shape[0], -1)
            adj = lambda r: proj_mod.backproject_nodes_skew(
                geo, r.reshape(r.shape[0], -1, D), tables
            ).reshape(r.shape[0], -1)
    elif mode == "fft":
        if geo.fan_beam:
            from dip_admm_tpu.ops import radon_fan as proj_mod

            precompute = proj_mod.precompute_fan
        else:
            from dip_admm_tpu.ops import radon_fft as proj_mod

            precompute = proj_mod.precompute_phases
        if tables is None:
            tables = jax.vmap(lambda a, v: precompute(geo, a, v))(
                angles, valid
            )
        fwd = lambda x: jax.vmap(
            lambda im, a, v, t: proj_mod.project(geo, im, a, v, t)
        )(x.reshape(-1, N, N), angles, valid, tables).reshape(x.shape[0], -1)
        adj = lambda r: jax.vmap(
            lambda s, a, v, t: proj_mod.backproject(geo, s, a, v, t)
        )(r.reshape(r.shape[0], -1, D), angles, valid, tables).reshape(
            r.shape[0], -1
        )
    else:
        raise ValueError(f"unknown projector mode {mode!r}")
    return fwd, adj


def _node_colnorms(mode: str, cfg: GeometryConfig, angles, valid, A=None):
    """W[i, p] = ||A_i[:, p]||^2 for the *actual* operator in use
    (ref ``block_3_graph_and_precisions.py:21-24``)."""
    if mode == "dense":
        return precisions.weights_from_dense(A)
    if mode.startswith("fft") and not cfg.fan_beam:
        from dip_admm_tpu.ops import radon_fft

        W = jax.jit(
            jax.vmap(lambda a, v: radon_fft.colnorms_sq(cfg, a, v))
        )(angles, valid)
    elif mode.startswith("fft") and cfg.fan_beam:
        # Rebinned fan operator: EXACT per-pixel column norms including the
        # rebin-filter attenuation and the node's row mask (node-batched;
        # the per-angle weight blocks are shared across nodes).
        from dip_admm_tpu.ops import radon_fan

        W = radon_fan.colnorms_sq_nodes(cfg, angles, valid)
    else:
        # joseph/dense modes: exact 2-tap column norms for that operator.
        W = jax.vmap(lambda a, v: radon.colnorms_sq(cfg, a, v))(angles, valid)
    return jnp.maximum(W.reshape(W.shape[0], -1), precisions.EPS)


# NOTE on jit hygiene: every helper below takes the device arrays (A, tables,
# ...) as explicit jit *arguments*. Closing over them instead bakes them into
# the lowered module as constants — jax then fetches the full arrays to host
# during lowering, which at 256^2 means multi-GB tables.


@functools.partial(jax.jit, static_argnames=("mode", "geo"))
def _jit_forward(mode, geo, angles, valid, A, tables, x):
    fwd, _ = make_node_ops(mode, geo, angles, valid, A, tables)
    return fwd(x)


@functools.partial(
    jax.jit, static_argnames=("q_mode", "strategy", "k", "seed")
)
def _build_graph_layer(W, q_mode, strategy, k, seed):
    """Pairwise precisions + per-pixel masks + union adjacency as ONE
    program (eagerly these are ~10 dispatches on [P, P, n] tensors)."""
    q_full = precisions.pairwise_q(W, q_mode)
    keep = topology.build_pixel_masks(q_full, strategy=strategy, k=k, seed=seed)
    Q = q_full * keep  # masked provider semantics
    adj = topology.union_adjacency(keep)
    return Q, keep, adj


@jax.jit
def _make_b(clean, noise_level, seed, row_valid):
    """Noisy sinograms b = clean + sigma * N(0,1) on valid rows
    (ref ``block_2_test.py:54-60``), one program instead of ~5 dispatches."""
    noise = jax.random.normal(jax.random.PRNGKey(seed), clean.shape, clean.dtype)
    return clean + noise_level * noise * row_valid


@functools.partial(jax.jit, static_argnames=("mode", "geo", "iters"))
def _estimate_opnorms(mode, geo, angles, valid, A, tables, iters: int = 30):
    """Batched power-method estimates of ||A_i^T A_i|| for solver steps."""
    fwd, adj = make_node_ops(mode, geo, angles, valid, A, tables)
    P = angles.shape[0]
    n = geo.n

    v = jax.random.normal(jax.random.PRNGKey(7), (P, n), dtype=jnp.float32)
    v = v / jnp.linalg.norm(v, axis=1, keepdims=True)

    def body(_, carry):
        v, lam = carry
        w = adj(fwd(v))
        lam = jnp.linalg.norm(w, axis=1)
        v = w / jnp.maximum(lam[:, None], 1e-30)
        return v, lam

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.zeros(P)))
    return lam


def build_fft_tables(cfg: ProblemConfig, angles, valid, mode: str = "fft",
                     row_block: "int | None" = None):
    """Per-node geometry tables for the fft projector family.

    ``row_block`` overrides the skew factorization's row-block size nb
    (default 128) — the pixel-compute mesh axis shards tables along the
    NB = N/nb axis, so smaller blocks admit more pixel shards (and let
    tests exercise NB > 1 at small N)."""
    geo = cfg.geometry
    tdt = jnp.dtype(cfg.fft_table_dtype)
    nb = {} if row_block is None else dict(nb=row_block)
    if mode == "fft_skew":
        if geo.fan_beam:
            from dip_admm_tpu.ops import radon_fan

            return radon_fan.precompute_fan_skew(geo, angles, valid, tdt, **nb)
        from dip_admm_tpu.ops import radon_fft

        return radon_fft.precompute_skew(geo, angles, valid, tdt, **nb)
    if mode != "fft":
        raise ValueError(f"no fft tables for projector mode {mode!r}")
    if geo.fan_beam:
        from dip_admm_tpu.ops import radon_fan

        pre = lambda a, v: radon_fan.precompute_fan(geo, a, v, table_dtype=tdt)
    else:
        from dip_admm_tpu.ops import radon_fft

        pre = lambda a, v: radon_fft.precompute_phases(
            geo, a, v, table_dtype=tdt
        )
    return jax.jit(jax.vmap(pre))(angles, valid)


def auto_mode(N: int) -> str:
    """Default projector for an N x N image: the dense operator while it is
    small (N <= 128), above that the factored skew operator — measured
    fastest end to end on an H100 at 256^2/8 parallel and 512^2/32 fan
    beam, ahead of the dense-phase-table "fft" and the gather "joseph"
    (CHANGES.md)."""
    return "dense" if N <= 128 else "fft_skew"


def build_problem(
    cfg: ProblemConfig,
    dense: Optional[bool] = None,
    phantom_array: Optional[np.ndarray] = None,
    mode: Optional[str] = None,
    per_node_phantoms: bool = False,
    row_block: Optional[int] = None,
) -> Problem:
    """Assemble a :class:`Problem` from configuration.

    ``mode`` defaults to :func:`auto_mode`.
    ``dense=True/False`` is an alias for mode="dense"/"joseph".

    ``per_node_phantoms=True`` reproduces the reference build-mode loader's
    behavior of measuring a *different* randomized phantom per node
    (``block_2_load_odl_data.py:134-137``), with node 0's phantom as the
    ground-truth reference (``:170``); the default single shared phantom
    matches the flagship pipeline (``block_2_test.py:48-51``).
    ``phantom_array`` may be one [N, N] array or a list of P arrays.
    """
    geo = cfg.geometry
    N, P, D = geo.N, geo.num_nodes, geo.n_det
    n = geo.n
    if mode is None:
        if dense is not None:
            mode = "dense" if dense else "joseph"
        else:
            mode = auto_mode(N)
    dtype = jnp.dtype(cfg.dtype)

    angles_np, valid_np, _ = radon.node_angles(geo)
    angles = jnp.asarray(angles_np, dtype=dtype)
    valid = jnp.asarray(valid_np)

    # Phantoms: one shared ground truth (flagship pipeline,
    # ``block_2_test.py:48-51``) or one per node (build-mode loader,
    # ``block_2_load_odl_data.py:134-137``) with node 0 as the reference.
    if isinstance(phantom_array, (list, tuple)):
        assert len(phantom_array) == P
        node_phantoms = [np.asarray(a) for a in phantom_array]
    elif phantom_array is not None:
        node_phantoms = [np.asarray(phantom_array)] * P
    elif per_node_phantoms:
        node_phantoms = [
            phantoms.rand_im(N, seed=cfg.noise_seed + i) for i in range(P)
        ]
    else:
        node_phantoms = [
            phantoms.make_phantom(cfg.phantom, N, seed=cfg.noise_seed)
        ] * P
    x_true = jnp.asarray(node_phantoms[0], dtype=dtype).reshape(-1)

    # Dense operators if requested.
    A = None
    if mode == "dense":
        mats = [
            radon.dense_matrix(geo, angles[i], valid[i], dtype=dtype)
            for i in range(P)
        ]
        A = jnp.stack(mats)  # [P, m_max*D, n]

    # Geometry tables for the fft projector (precomputed once per problem).
    fft_tables = None
    if mode.startswith("fft"):
        fft_tables = build_fft_tables(cfg, angles, valid, mode,
                                      row_block=row_block)

    # Clean sinograms via the same operator the solver uses, each node
    # measuring its own phantom.
    imgs = jnp.stack(
        [jnp.asarray(ph, dtype=dtype).reshape(-1) for ph in node_phantoms]
    )
    clean = _jit_forward(mode, geo, angles, valid, A, fft_tables, imgs)

    # Noise only on valid measurement rows (sigma * N(0,1),
    # ref ``block_2_test.py:54-60``).
    row_valid = jnp.repeat(valid, D, axis=1).astype(dtype)
    b = _make_b(clean, cfg.noise_level, cfg.noise_seed, row_valid)

    # Precision weights and per-pixel graph.
    W = _node_colnorms(mode, geo, angles, valid, A).astype(dtype)
    Q, keep, adj = _build_graph_layer(
        W, cfg.graph.q_mode, cfg.graph.strategy, cfg.graph.k, cfg.graph.seed
    )

    opnorm = _estimate_opnorms(mode, geo, angles, valid, A, fft_tables)
    return Problem(
        cfg=cfg, mode=mode, angles=angles, angle_valid=valid, A=A, b=b,
        W=W, Q=Q, keep=keep, adj=adj, x_true=x_true,
        opnorm=opnorm.astype(dtype), fft_tables=fft_tables,
    )


def rebuild_graph(problem: Problem, graph_cfg) -> Problem:
    """New Problem with the same operators/data but a different per-pixel
    graph (the reference reruns block-3 per strategy on fixed pickled data,
    ``block_7_main_ver3.py:63-72``)."""
    cfg = dataclasses.replace(problem.cfg, graph=graph_cfg)
    Q, keep, adj = _build_graph_layer(
        problem.W, graph_cfg.q_mode, graph_cfg.strategy, graph_cfg.k,
        graph_cfg.seed,
    )
    return dataclasses.replace(problem, cfg=cfg, Q=Q, keep=keep, adj=adj)
