"""Multi-device parity: the shard_map consensus loop must reproduce the
single-device loop exactly (same collectives math, different transport),
on a virtual 8-device CPU mesh (conftest forces 8 host devices)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dip_admm_tpu.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu.core import admm
from dip_admm_tpu.data import loader
from dip_admm_tpu.parallel import admm_sharded, mesh as meshlib


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 virtual devices"
)


def make_problem(P=4, N=12):
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=N, num_nodes=P, angles_total=4 * P),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=6,
            eps_pri=1e-8, eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=60, check_every=20),
        ),
        noise_level=0.005,
        phantom="const",
    )
    return loader.build_problem(cfg)


def test_pair_transpose_matches_local():
    problem = make_problem(P=8, N=8)
    m = meshlib.make_mesh(4)
    A = jnp.arange(8 * 8 * 3, dtype=jnp.float32).reshape(8, 8, 3)

    def body(blk):
        return admm_sharded._pair_transpose(meshlib.NODE_AXIS)(blk)

    from jax.sharding import PartitionSpec as PS

    out = jax.jit(
        jax.shard_map(
            body, mesh=m,
            in_specs=PS(meshlib.NODE_AXIS),
            out_specs=PS(meshlib.NODE_AXIS),
            check_vma=False,
        )
    )(A)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(A.swapaxes(0, 1)))


@pytest.mark.parametrize("n_node, pixel", [(4, 1), (2, 2), (4, 2)])
def test_inner_loop_flag_agrees_on_every_device(n_node, pixel):
    """The inner loop's continue flag steers control flow around the
    projector's pixel-axis collectives: one device still unconverged keeps
    every device of the mesh in the loop, pixel replicas included."""
    from jax.sharding import PartitionSpec as PS

    m = meshlib.make_mesh(n_node, pixel=pixel)
    spec = PS(*m.axis_names)
    comm = admm_sharded.comm_ops(pixel, n_loc=1)
    f = jax.jit(jax.shard_map(
        lambda v: comm.any_reduce(v.reshape(())).reshape((1,) * v.ndim),
        mesh=m, in_specs=spec, out_specs=spec, check_vma=False,
    ))
    shape = (n_node, pixel) if pixel > 1 else (n_node,)
    none = np.zeros(shape, bool)
    one = none.copy()
    one.flat[-1] = True  # the last pixel replica of the last node block
    assert not np.asarray(f(jnp.asarray(none))).any()
    assert np.asarray(f(jnp.asarray(one))).all()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_matches_single_device(n_dev):
    problem = make_problem(P=4)
    ref = admm.run_admm(problem)
    m = meshlib.make_mesh(n_dev)
    got = admm_sharded.run_admm_sharded(problem, mesh=m)
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )
    for name in ("primal", "dual", "obj_total", "img_mse_total"):
        np.testing.assert_allclose(
            np.asarray(got.history[name]),
            np.asarray(ref.history[name]),
            rtol=2e-3, atol=1e-5,
        )
    np.testing.assert_allclose(
        np.asarray(got.history["pri_per_node"]),
        np.asarray(ref.history["pri_per_node"]),
        rtol=2e-3, atol=1e-5,
    )


def test_sharded_eps_rel_history_parity():
    """With eps_rel > 0 the acceptance target is per node (data scales
    differ), so the scalar ``eps_target`` slot must be the cross-shard max
    — a shard-local max fed to the replicated out-spec would store whichever
    shard XLA happens to read (VERDICT r3 weak #3)."""
    problem = make_problem(P=4)
    # Per-node data scales must genuinely differ for the test to bite (with
    # a shared phantom and even angle splits, g_scale agrees to ~1e-5
    # relative): scale each node's sinogram by a different power of two.
    scale = jnp.asarray([1.0, 2.0, 4.0, 8.0], problem.b.dtype)
    problem = dataclasses.replace(problem, b=problem.b * scale[:, None])
    cfg = dataclasses.replace(
        problem.cfg.admm,
        node=dataclasses.replace(problem.cfg.admm.node, eps_rel=0.05),
    )
    ref = admm.run_admm(problem, cfg)
    eps_nodes = np.asarray(ref.history["eps_per_node"])[0]
    assert np.max(eps_nodes) > 1.5 * np.min(eps_nodes)
    # 4 shards: every device holds ONE node, so any local-max bug cannot
    # hide behind a shared block.
    got = admm_sharded.run_admm_sharded(problem, cfg, mesh=meshlib.make_mesh(4))
    assert int(got.n_iters) == int(ref.n_iters)
    for name in ("eps_target", "eps_per_node", "primal", "dual", "g_norm",
                 "inner_iters"):
        np.testing.assert_allclose(
            np.asarray(got.history[name]),
            np.asarray(ref.history[name]),
            rtol=2e-3, atol=1e-6, err_msg=name,
        )


def test_sharded_matrix_free():
    problem = make_problem(P=4)
    free = dataclasses.replace(problem, mode="joseph", A=None)
    m = meshlib.make_mesh(4)
    got = admm_sharded.run_admm_sharded(free, mesh=m)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=1e-3, atol=1e-3
    )


def test_sharded_exact_resume():
    """state/hist/until segmentation on the mesh: a run split at iteration 3
    must bit-equal the uninterrupted run (ref chunked-resume capability,
    block_6_admm_loop.py:14-69, on the sharded path)."""
    problem = make_problem(P=4)
    m = meshlib.make_mesh(4)
    full = admm_sharded.run_admm_sharded(problem, mesh=m)

    part = admm_sharded.run_admm_sharded(problem, mesh=m, until=3)
    assert int(part.n_iters) == 3
    resumed = admm_sharded.run_admm_sharded(
        problem, mesh=m, state=part.state, hist=part.history
    )
    assert int(resumed.n_iters) == int(full.n_iters)
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(full.x))
    for name, v in full.history.items():
        np.testing.assert_array_equal(
            np.asarray(resumed.history[name]), np.asarray(v), err_msg=name
        )


def test_sharded_snapshots(tmp_path):
    """snapshot_every on the mesh path writes per-segment snapshots and
    returns the same final result as the straight sharded run."""
    problem = make_problem(P=4)
    m = meshlib.make_mesh(4)
    full = admm_sharded.run_admm_sharded(problem, mesh=m)
    res = admm.run_admm_snapshots(
        problem, snapshot_dir=str(tmp_path), snapshot_every=2, mesh=m
    )
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(full.x))
    names = {p.name for p in tmp_path.iterdir()}
    assert "iter_0002_node_0.npy" in names
    assert "iter_0004_node_0.npy" in names


def test_sharded_fft_grouped_parity():
    """The dense-phase-table projector (fft) through the shard_map driver:
    its per-node tables shard on the node axis and reproduce the
    single-device run."""
    problem = make_problem(P=4)
    grp = loader.build_problem(problem.cfg, mode="fft")
    m = meshlib.make_mesh(4)
    got = admm_sharded.run_admm_sharded(grp, mesh=m)
    ref = admm.run_admm(grp)
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.history["primal"]),
        np.asarray(ref.history["primal"]), rtol=2e-3, atol=1e-5,
    )


def test_sharded_fft_shear_parity():
    """fft_skew tables with bf16 storage mix per-node leaves (WtT, SE, Wd,
    plan) with node-shared geometry (the DFT-back and twiddle tables): the
    table specs must shard the former and replicate the latter. The inner
    budget is fixed (no acceptance or plateau exit): bf16 rounding moves
    near-threshold acceptance decisions between the two batchings, and a
    flipped decision changes the trajectory, not the placement."""
    problem = make_problem(P=4)
    c = problem.cfg
    node = dataclasses.replace(c.admm.node, eps0=0.0, plateau_tol=0.0)
    bf16 = dataclasses.replace(
        c, fft_table_dtype="bfloat16",
        admm=dataclasses.replace(c.admm, node=node),
    )
    sh = loader.build_problem(bf16, mode="fft_skew")
    m = meshlib.make_mesh(4)
    got = admm_sharded.run_admm_sharded(sh, mesh=m)
    ref = admm.run_admm(sh)
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.history["primal"]),
        np.asarray(ref.history["primal"]), rtol=2e-3, atol=1e-5,
    )


def test_sharded_fft_skew_parity():
    """fft_skew on the node mesh: the node-shared skew DFT-back matrices
    replicate while WtT/SE/plan shard by node."""
    problem = make_problem(P=4)
    sk = loader.build_problem(problem.cfg, mode="fft_skew")
    m = meshlib.make_mesh(4)
    got = admm_sharded.run_admm_sharded(sk, mesh=m)
    ref = admm.run_admm(sk)
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )


def test_sharded_fan_grouped_parity():
    """Fan-beam fft (per-node rebin tables) on the mesh: every table leaf
    shards by node."""
    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=12, num_nodes=4, angles_total=32, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="complete", k=0, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=5, eps_pri=1e-8, eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=40, check_every=20),
        ),
        noise_level=0.002,
        phantom="const",
    )
    fan = loader.build_problem(cfg, mode="fft")
    m = meshlib.make_mesh(4)
    got = admm_sharded.run_admm_sharded(fan, mesh=m)
    ref = admm.run_admm(fan)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )


def test_pixel_axis_parity_2x4():
    # 2-D (node x pixel) mesh: Z/Y/Q shard along the pixel axis, node solves
    # keep full images — trajectories must match the single-device loop.
    problem = make_problem(P=8, N=12)
    m2 = meshlib.make_mesh(2, pixel=4)
    assert dict(m2.shape) == {"node": 2, "pixel": 4}
    got = admm_sharded.run_admm_sharded(problem, mesh=m2)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=3e-4, atol=3e-4
    )
    for key in ("primal", "dual", "obj_total", "eps_target"):
        np.testing.assert_allclose(
            np.asarray(got.history[key]), np.asarray(ref.history[key]),
            rtol=2e-3, atol=1e-5, err_msg=key,
        )
    np.testing.assert_allclose(
        np.asarray(got.history["pri_per_node"]),
        np.asarray(ref.history["pri_per_node"]),
        rtol=2e-3, atol=1e-5,
    )


def test_pixel_axis_parity_weighted_relaxed():
    # Weighted fusion + over-relaxation exercise the W_own/W_all pixel
    # slices and the Xh blend against pixel-local Z.
    problem = make_problem(P=4, N=12)
    cfg = dataclasses.replace(
        problem.cfg.admm, z_fusion="weighted", relax_alpha=1.6
    )
    m2 = meshlib.make_mesh(4, pixel=2)
    got = admm_sharded.run_admm_sharded(problem, cfg, mesh=m2)
    ref = admm.run_admm(problem, cfg)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=3e-4, atol=3e-4
    )


def test_pixel_axis_resume_exact():
    # The state/hist/until segmentation contract holds on the 2-D mesh.
    problem = make_problem(P=4, N=12)
    m2 = meshlib.make_mesh(4, pixel=2)
    full = admm_sharded.run_admm_sharded(problem, mesh=m2)
    part = admm_sharded.run_admm_sharded(problem, mesh=m2, until=3)
    resumed = admm_sharded.run_admm_sharded(
        problem, mesh=m2, state=part.state, hist=part.history
    )
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(full.x), rtol=1e-6, atol=1e-6
    )


def test_pixel_axis_fan_grouped():
    # 2-D mesh with the fan fft projector (no pixel-compute sharding): the
    # tables shard by node only while the edge state shards along pixels.
    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=16, num_nodes=4, angles_total=32, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=3, eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=20, check_every=10),
        ),
        phantom="const",
    )
    problem = loader.build_problem(cfg, mode="fft")
    m2 = meshlib.make_mesh(4, pixel=2)
    got = admm_sharded.run_admm_sharded(problem, mesh=m2)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=3e-4, atol=3e-4
    )


def test_sharded_fcv_parity():
    """fcv on the node mesh: the per-shard Fourier-precond setup (impulse
    probe + power method) must reproduce the single-device solve."""
    problem = make_problem(P=4)
    cfg = dataclasses.replace(
        problem.cfg.admm,
        node=dataclasses.replace(problem.cfg.admm.node, algorithm="fcv"),
    )
    ref = admm.run_admm(problem, cfg)
    got = admm_sharded.run_admm_sharded(problem, cfg, mesh=meshlib.make_mesh(4))
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )
    # rtol 5e-3: the Lanczos step certificate runs per shard, and XLA's
    # rfft2 gives very slightly different roundoff for batch 4 vs 1 —
    # the 25-step three-term recurrence amplifies that into ~1e-6 step
    # differences, visible at the g_norm floor (the 12-step power method
    # sat below 2e-3 by luck).
    for name in ("primal", "dual", "g_norm", "inner_iters"):
        np.testing.assert_allclose(
            np.asarray(got.history[name]), np.asarray(ref.history[name]),
            rtol=5e-3, atol=1e-5, err_msg=name,
        )


def test_pixel_mesh_fcv_parity():
    problem = make_problem(P=4, N=16)
    cfg = dataclasses.replace(
        problem.cfg.admm,
        node=dataclasses.replace(problem.cfg.admm.node, algorithm="fcv"),
    )
    ref = admm.run_admm(problem, cfg)
    m = meshlib.make_mesh(2, pixel=2)
    got = admm_sharded.run_admm_sharded(problem, cfg, mesh=m)
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )


def test_sharded_fan_skew_parity():
    """Fan-beam fft_skew on the mesh: the shared factored-shear parallel
    tables (nested under "shared") replicate, per-node row masks shard."""
    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=12, num_nodes=4, angles_total=32, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="complete", k=0, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=5, eps_pri=1e-8, eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=40, check_every=20),
        ),
        noise_level=0.002,
        phantom="const",
    )
    fan = loader.build_problem(cfg, mode="fft_skew")
    m = meshlib.make_mesh(4)
    got = admm_sharded.run_admm_sharded(fan, mesh=m)
    ref = admm.run_admm(fan)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )


def test_pixel_compute_rowshard_parity():
    """Pixel-axis COMPUTE sharding (VERDICT r3 #4): with mode=fft_skew on a
    node x pixel mesh, the row-stage tables shard along their row-block
    axis and each pixel shard applies only its rows (psum'd spectra /
    all_gathered backprojection). Must reproduce the single-device run and
    must actually take the row-sharded path."""
    import dip_admm_tpu.ops.radon_fft as radon_fft

    cfg = ProblemConfig(
        geometry=GeometryConfig(N=16, num_nodes=4, angles_total=16),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=4, eps_pri=1e-8, eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=40, check_every=20),
        ),
        noise_level=0.005, phantom="const",
    )
    # row_block=8 -> NB=2 row blocks, shardable over 2 pixel devices.
    problem = loader.build_problem(cfg, mode="fft_skew", row_block=8)
    assert problem.fft_tables["WtT"].shape[1] == 2
    ref = admm.run_admm(problem)

    calls = {"n": 0}
    orig = radon_fft.project_nodes_skew_rowshard

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    radon_fft.project_nodes_skew_rowshard = counting
    try:
        m = meshlib.make_mesh(2, pixel=2)
        got = admm_sharded.run_admm_sharded(problem, mesh=m)
    finally:
        radon_fft.project_nodes_skew_rowshard = orig
    assert calls["n"] > 0, "row-sharded projector path not engaged"
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )
    for name in ("primal", "dual", "obj_total", "g_norm"):
        np.testing.assert_allclose(
            np.asarray(got.history[name]), np.asarray(ref.history[name]),
            rtol=2e-3, atol=1e-5, err_msg=name,
        )


def test_pixel_compute_rowshard_fcv_parity():
    """Row-sharded projector composes with the fcv inner solver (the
    Fourier-precond build runs the sharded fwd/adj, collectives included)."""
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=16, num_nodes=4, angles_total=16),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=3, eps_pri=1e-8, eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=40, check_every=20,
                                  algorithm="fcv"),
        ),
        noise_level=0.005, phantom="const",
    )
    problem = loader.build_problem(cfg, mode="fft_skew", row_block=8)
    ref = admm.run_admm(problem)
    m = meshlib.make_mesh(2, pixel=2)
    got = admm_sharded.run_admm_sharded(problem, mesh=m)
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )


def test_sharded_adapt_rho_parity():
    """Residual balancing on the node mesh: the balancing factor derives
    from psummed residuals, so every shard adapts in lockstep and the
    sharded trajectory (including the rho history and Y rescaling) matches
    the single-device one."""
    problem = make_problem(P=4)
    cfg = dataclasses.replace(
        problem.cfg.admm, adapt_rho=True, rho_mu=1.5, rho=0.2
    )
    ref = admm.run_admm(problem, cfg)
    got = admm_sharded.run_admm_sharded(
        problem, cfg, mesh=meshlib.make_mesh(4)
    )
    rho_ref = np.asarray(ref.history["rho"])
    assert np.nanmax(rho_ref) > 0.2  # the balancing actually fired
    np.testing.assert_allclose(
        np.asarray(got.history["rho"]), rho_ref, rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )
    for name in ("primal", "dual"):
        np.testing.assert_allclose(
            np.asarray(got.history[name]), np.asarray(ref.history[name]),
            rtol=2e-3, atol=1e-5, err_msg=name,
        )


def test_sharded_adapt_rho_stall_parity():
    """Stall-mode rho adaptation on the node mesh: the policy reads the
    scalar primal-history slot, which is written from psummed residuals
    and therefore replicated — every shard must step rho in lockstep and
    match the single-device trajectory exactly."""
    problem = make_problem(P=4)
    cfg = dataclasses.replace(
        problem.cfg.admm, adapt_rho=True, adapt_rho_mode="stall",
        rho_stall_window=3, rho_stall_tol=2.0,  # always stalled: forced steps
        max_iters=10,  # first check fires at k+1 = 2*window = 6
    )
    ref = admm.run_admm(problem, cfg)
    got = admm_sharded.run_admm_sharded(
        problem, cfg, mesh=meshlib.make_mesh(4)
    )
    rho_ref = np.asarray(ref.history["rho"])
    assert np.nanmax(rho_ref) > cfg.rho  # the stall steps actually fired
    np.testing.assert_allclose(
        np.asarray(got.history["rho"]), rho_ref, rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )


def test_pixel_compute_rowshard_fan_parity():
    """Fan-beam pixel-COMPUTE sharding: the fan path rides the same
    row-sharded skew stage through its shared parallel stage
    (tables under shared.par shard along NB over the pixel axis; the
    angular rebin tail stays replicated). Must reproduce the single-device
    run and actually engage the fan row-sharded path."""
    import dip_admm_tpu.ops.radon_fan as radon_fan

    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=16, num_nodes=4, angles_total=32, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=4, eps_pri=1e-8, eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=40, check_every=20),
        ),
        noise_level=0.002, phantom="const",
    )
    # row_block=8 -> NB=2 row blocks in the shared parallel-stage tables.
    problem = loader.build_problem(cfg, mode="fft_skew", row_block=8)
    assert problem.fft_tables["shared"]["par"]["WtT"].shape[1] == 2
    ref = admm.run_admm(problem)

    calls = {"n": 0}
    orig = radon_fan.project_nodes_fan_skew_rowshard

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    radon_fan.project_nodes_fan_skew_rowshard = counting
    try:
        m = meshlib.make_mesh(2, pixel=2)
        got = admm_sharded.run_admm_sharded(problem, mesh=m)
    finally:
        radon_fan.project_nodes_fan_skew_rowshard = orig
    assert calls["n"] > 0, "fan row-sharded projector path not engaged"
    assert int(got.n_iters) == int(ref.n_iters)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )
    for name in ("primal", "dual", "obj_total", "g_norm"):
        np.testing.assert_allclose(
            np.asarray(got.history[name]), np.asarray(ref.history[name]),
            rtol=2e-3, atol=1e-5, err_msg=name,
        )
