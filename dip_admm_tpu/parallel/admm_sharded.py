"""Multi-device consensus ADMM: shard_map over the node mesh axis.

The reference iterates nodes and edges sequentially in one process
(``/root/reference/block_6_admm_loop_ver2.py:81``, ``:212-230``); here each
device owns a block of graph nodes and the per-iteration edge consensus is
*one* ``all_to_all`` collective:

  each device holds proposals  a[i_loc, j] = x_i + y_{(ij), i}
  the edge fusion needs        a[j, i]     (the neighbor's proposal)
  -> all_to_all over the j axis transposes the (i, j) pair grid across the
     mesh, which is exactly the minimal neighbor exchange (P_loc * P * n
     payload per device, riding NVLink within a host and the network
     across hosts).

Residual norms and totals reduce with ``psum``, so every shard computes the
same convergence flag and the outer ``lax.while_loop`` stays in lockstep.
The inner node-solve loop's continue flag is OR-reduced over every mesh
axis, so all devices run the same inner trip count: on the node x pixel
mesh the projector's own collectives sit inside that loop, and a device
that left it early would wait forever in a collective its pixel-axis
partner never reaches.

The iteration body is shared with the single-device path
(``core.admm.admm_iteration``) — only the ``CommOps`` differ. The
``state=/hist=/until=`` segmentation contract also matches ``run_admm``
(checkpoint/resume and periodic snapshots, the sharded analogue of the
reference's chunked warm-started solves, ``block_6_admm_loop.py:14-69`` and
snapshot loop ``block_6_admm_loop_ver2.py:269-281``); segments share one
compilation because ``until`` is traced.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PS

from dip_admm_tpu.config import AdmmConfig
from dip_admm_tpu.core import admm as core_admm
from dip_admm_tpu.core import node_solver
from dip_admm_tpu.core.admm import AdmmResult, AdmmState, CommOps, NodeBlockData
from dip_admm_tpu.data.loader import Problem
from dip_admm_tpu.parallel.mesh import (
    NODE_AXIS,
    PIXEL_AXIS,
    make_mesh,
    shards_for,
    table_partition_specs,
)


def _pair_transpose(axis_name: str):
    def f(Ablk: jnp.ndarray) -> jnp.ndarray:
        # [i_loc, j, n] -> [i_loc, j, n] holding the (j, i) values:
        # tiled all_to_all scatters j-blocks to their owner devices and
        # concatenates received blocks along axis 0 in device order, giving
        # [j_global, i_loc, n]; swap back to [i_loc, j_global, n].
        t = jax.lax.all_to_all(
            Ablk, axis_name, split_axis=1, concat_axis=0, tiled=True
        )
        return jnp.swapaxes(t, 0, 1)

    return f


def _psum(axis_name: str):
    return lambda v: jax.lax.psum(v, axis_name)


def comm_ops(dp: int, n_loc: int) -> CommOps:
    """Collectives of the sharded iteration body on a node mesh (dp == 1)
    or a node x pixel mesh with dp pixel shards of n_loc pixels each.

    Pixel-replicated quantities (node-solve values: full images on every
    pixel shard) reduce over the node axis only (``psum_repl``/
    ``pmax_repl``). The inner loop's continue flag (``any_reduce``) is the
    exception: it reduces over every axis, because it steers control flow
    around collectives, and replicas on two cards need not agree to the
    last bit."""
    node_psum = _psum(NODE_AXIS)
    node_pmax = lambda v: jax.lax.pmax(v, NODE_AXIS)  # noqa: E731
    all_axes = (NODE_AXIS, PIXEL_AXIS) if dp > 1 else NODE_AXIS
    any_reduce = lambda v: jax.lax.pmax(  # noqa: E731
        v.astype(jnp.int32), all_axes
    ).astype(bool)
    if dp == 1:
        return CommOps(
            pair_transpose=_pair_transpose(NODE_AXIS),
            psum=node_psum,
            any_reduce=any_reduce,
            psum_repl=node_psum,
            pmax_repl=node_pmax,
        )
    return CommOps(
        pair_transpose=_pair_transpose(NODE_AXIS),
        psum=_psum((NODE_AXIS, PIXEL_AXIS)),
        any_reduce=any_reduce,
        psum_repl=node_psum,
        pmax_repl=node_pmax,
        psum_pixel=_psum(PIXEL_AXIS),
        gather_pixels=lambda v: jax.lax.all_gather(
            v, PIXEL_AXIS, axis=v.ndim - 1, tiled=True
        ),
        my_pixels=lambda v: jax.lax.dynamic_slice_in_dim(
            v, jax.lax.axis_index(PIXEL_AXIS) * n_loc, n_loc,
            axis=v.ndim - 1,
        ),
    )


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _run_sharded_jit(
    pcfg, cfg: AdmmConfig, mesh: Mesh, mode: str,
    angles, valid, A_arg, tables_arg, b, Q, adjm, W, L, x_true,
    state: AdmmState, hist: dict, until,
) -> AdmmResult:
    P = pcfg.geometry.num_nodes
    P_loc = shards_for(P, mesh)
    dtype = b.dtype
    N = pcfg.geometry.N
    # Optional pixel axis: shards the [P_loc, P, n] edge state (Z/Y/Q) along
    # the pixel dim — node solves keep full images (replicated compute along
    # this axis), the per-pixel consensus and its all_to_all payload split.
    dp = int(mesh.shape.get(PIXEL_AXIS, 1))
    n = pcfg.geometry.n
    if n % dp != 0:
        raise ValueError(f"n={n} must be divisible by pixel mesh size {dp}")
    n_loc = n // dp

    node = PS(NODE_AXIS)
    repl = PS()
    edge = PS(NODE_AXIS, None, PIXEL_AXIS) if dp > 1 else node

    # Pixel-axis COMPUTE sharding (fft_skew, parallel AND fan beam): the
    # factored row-stage tables additionally shard along their row-block
    # axis NB, and each pixel shard applies only its row blocks — the
    # projector's tap products divide by dp (the fan row tables live under
    # the node-SHARED ``shared.par`` subtree, so they shard along the pixel
    # axis only). Requires NB divisible by dp (nb=128 blocks: NB = N/128).
    fan = pcfg.geometry.fan_beam
    if fan and isinstance(tables_arg, dict) and "shared" in tables_arg:
        _row_tables = tables_arg["shared"].get("par")
    elif isinstance(tables_arg, dict):
        _row_tables = tables_arg
    else:
        _row_tables = None
    pixel_compute = (
        dp > 1 and mode == "fft_skew"
        and isinstance(_row_tables, dict) and "WtT" in _row_tables
        and _row_tables["WtT"].shape[1] % dp == 0
    )

    def shard_body(
        angles, valid, A, tables, b, Q, adjm, W_blk, W_all, L_blk, x_true,
        state, hist, until,
    ):
        from dip_admm_tpu.data.loader import make_node_ops

        if pixel_compute and fan:
            from dip_admm_tpu.ops import radon_fan

            geo = pcfg.geometry
            fwd = lambda x: radon_fan.project_nodes_fan_skew_rowshard(
                geo, x.reshape(-1, N, N), tables, PIXEL_AXIS
            ).reshape(x.shape[0], -1)
            adj = lambda r: radon_fan.backproject_nodes_fan_skew_rowshard(
                geo, r.reshape(r.shape[0], -1, geo.n_det), tables, PIXEL_AXIS
            ).reshape(r.shape[0], -1)
        elif pixel_compute:
            from dip_admm_tpu.ops import radon_fft

            geo = pcfg.geometry
            fwd = lambda x: radon_fft.project_nodes_skew_rowshard(
                geo, x.reshape(-1, N, N), tables, PIXEL_AXIS
            ).reshape(x.shape[0], -1)
            adj = lambda r: radon_fft.backproject_nodes_skew_rowshard(
                geo, r.reshape(r.shape[0], -1, geo.n_det), tables, PIXEL_AXIS
            ).reshape(r.shape[0], -1)
        else:
            fwd, adj = make_node_ops(
                mode, pcfg.geometry, angles, valid,
                A if mode == "dense" else None,
                tables if mode.startswith("fft") else None,
            )

        fprecond = None
        if cfg.node.algorithm == "fcv":
            # Per-shard local setup (one operator apply + power method per
            # run, no collectives): node solves see full images, so the
            # pixel-partial D completes by all_gather first when dp > 1.
            D_full = jnp.sum(Q, axis=1)
            if dp > 1:
                D_full = jax.lax.all_gather(
                    D_full, PIXEL_AXIS, axis=1, tiled=True
                )
            fprecond = node_solver.build_fourier_precond(
                fwd, adj, D_full, cfg.rho, cfg.node, N
            )
        data = NodeBlockData(
            fwd=fwd, adj=adj, b=b, Q=Q, adjm=adjm.astype(dtype),
            W_own=W_blk, W_all=W_all, L=L_blk, x_true=x_true, N=N,
            g_scale=jnp.linalg.norm(adj(b), axis=1),
            fprecond=fprecond,
        )
        comm = comm_ops(dp, n_loc)

        def cond(carry):
            st, _ = carry
            return (st.k < until) & ~st.stop

        def body(carry):
            st, h = carry
            return core_admm.admm_iteration(data, cfg, comm, st, h)

        state_f, hist_f = jax.lax.while_loop(cond, body, (state, hist))
        return AdmmResult(
            x=state_f.node.x, history=hist_f, n_iters=state_f.k, state=state_f
        )

    hist_specs = {
        name: PS(None, NODE_AXIS) if per_node else repl
        for name, per_node in core_admm.HISTORY_FIELDS
    }
    state_specs = AdmmState(
        node=node_solver.NodeState(
            x=node, ux=node, uy=node, ua=node, xp=node, tk=node
        ),
        Z=edge, Y=edge, k=repl, stop=repl, rho_scale=repl,
    )
    out_specs = AdmmResult(
        x=node, history=hist_specs, n_iters=repl, state=state_specs
    )
    # Single source of truth with multihost.problem_shardings: per-node
    # tables shard, node-shared geometry replicates (key- + shape-based).
    tables_spec = table_partition_specs(tables_arg, P)
    if pixel_compute and fan:
        # Fan: the row-stage tables are node-SHARED (one rebinned parallel
        # angle set under shared.par, leading dim 1) — shard their NB
        # row-block axis (dim 1) along the pixel axis only.
        tables_spec = dict(tables_spec)
        tables_spec["shared"] = dict(tables_spec["shared"])
        tables_spec["shared"]["par"] = dict(tables_spec["shared"]["par"])
        for key in ("WtT", "SEre", "SEim"):
            if key in tables_spec["shared"]["par"]:
                tables_spec["shared"]["par"][key] = PS(None, PIXEL_AXIS)
    elif pixel_compute:
        # Row-stage tables additionally shard along their NB row-block axis
        # (dim 1) — each pixel shard holds only its row blocks, dividing
        # both the tap FLOPs and the table memory by dp.
        tables_spec = dict(tables_spec)
        for key in ("WtT", "SEre", "SEim"):
            if key in tables_spec:
                tables_spec[key] = PS(NODE_AXIS, PIXEL_AXIS)
    in_specs = (
        node, node, node, tables_spec, node, edge, node, node, repl, node,
        repl, state_specs, hist_specs, repl,
    )
    f = jax.shard_map(
        shard_body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return f(
        angles, valid, A_arg, tables_arg, b, Q, adjm, W, W, L, x_true,
        state, hist, until,
    )


def run_admm_sharded(
    problem: Problem,
    cfg: Optional[AdmmConfig] = None,
    mesh: Optional[Mesh] = None,
    state: Optional[AdmmState] = None,
    hist: Optional[dict] = None,
    until: Optional[int] = None,
) -> AdmmResult:
    """Consensus ADMM with graph nodes sharded over ``mesh``'s node axis.

    Produces the same result/history/resume contract as
    ``core.admm.run_admm`` (verified by the cross-device parity and
    exact-resume tests on a virtual CPU mesh): pass the ``state``/``hist``
    of a previous partial run to continue from iteration ``state.k``;
    ``until`` caps this call's final outer iteration.
    """
    cfg = cfg if cfg is not None else problem.cfg.admm
    mesh = mesh if mesh is not None else make_mesh()
    if state is None:
        state, hist = core_admm.init_state(problem, cfg)
    assert hist is not None
    until = cfg.max_iters if until is None else min(until, cfg.max_iters)

    dtype = problem.b.dtype
    mode = problem.mode
    L = problem.opnorm + cfg.rho * jnp.max(
        jnp.sum(problem.Q, axis=1), axis=-1
    )
    P = problem.num_nodes
    A_arg = problem.A if mode == "dense" else jnp.zeros((P, 1), dtype)
    tables_arg = (
        problem.fft_tables
        if (mode.startswith("fft") and problem.fft_tables is not None)
        else jnp.zeros((P, 1), dtype)
    )
    return _run_sharded_jit(
        problem.cfg, cfg, mesh, mode,
        problem.angles, problem.angle_valid, A_arg, tables_arg, problem.b,
        problem.Q, problem.adj, problem.W, L, problem.x_true,
        state, hist, until,
    )
