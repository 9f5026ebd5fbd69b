"""Multi-host plumbing on the virtual device mesh: sharded placement of the
Problem pytree and execution from pre-distributed arrays."""

import jax
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
from dip_admm_tpu.parallel import admm_sharded, multihost

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 virtual devices"
)


def _problem(P=8, N=8, mode=None):
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=N, num_nodes=P, angles_total=2 * P),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=4, eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=40, check_every=20),
        ),
        phantom="const",
    )
    return loader.build_problem(cfg, mode=mode)


def test_distribute_problem_shards_node_axis():
    problem = _problem(P=8, mode="fft")
    mesh = multihost.global_mesh(4)
    dist = multihost.distribute_problem(problem, mesh)
    # Node-axis arrays land sharded, replicated arrays whole.
    assert len(dist.b.sharding.device_set) == 4
    assert len(dist.x_true.sharding.device_set) in (1, 4)  # replicated
    for leaf in jax.tree.leaves(dist.fft_tables):
        assert len(leaf.sharding.device_set) == 4


def test_sharded_run_from_distributed_arrays():
    problem = _problem(P=8)
    mesh = multihost.global_mesh(4)
    dist = multihost.distribute_problem(problem, mesh)
    got = admm_sharded.run_admm_sharded(dist, mesh=mesh)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=2e-4, atol=2e-4
    )


def test_initialize_single_process_noop():
    multihost.initialize()  # must not raise without a coordinator


def test_sixteen_nodes_on_eight_devices():
    problem = _problem(P=16, N=8)
    mesh = multihost.global_mesh(8)
    got = admm_sharded.run_admm_sharded(problem, mesh=mesh)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.history["primal"]),
        np.asarray(ref.history["primal"]),
        rtol=1e-3,
    )


def test_config5_shape_fan_32nodes():
    # BASELINE.json config 5 topology at test scale: 32 fan-beam nodes,
    # matrix-free rebinned projector, sharded over 8 devices (4 nodes each).
    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=16, num_nodes=32, angles_total=128, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="knn", k=2, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=3, eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=20, check_every=10),
        ),
        phantom="const",
    )
    problem = loader.build_problem(cfg, mode="fft")
    mesh = multihost.global_mesh(8)
    dist = multihost.distribute_problem(problem, mesh)
    res = admm_sharded.run_admm_sharded(dist, mesh=mesh)
    assert res.x.shape == (32, 256)
    pri = np.asarray(res.history["primal"])[:3]
    assert np.isfinite(pri).all()


def test_distribute_fft_shear_placement_and_parity():
    # The factored parallel-beam projector (fft_skew) has node-SHARED
    # leaves (the DFT-back D* [L, F] and tail twiddles PhiD* [D2p, F]);
    # distribute_problem must replicate them (same rule as the runtime's
    # in_specs) and the sharded run from the distributed arrays must match
    # single-device.
    problem = _problem(P=8, N=16, mode="fft_skew")
    mesh = multihost.global_mesh(4)
    dist = multihost.distribute_problem(problem, mesh)
    for key in ("Dre", "Dim", "PhiDre", "PhiDim"):
        assert dist.fft_tables["shared"][key].sharding.is_fully_replicated, key
    for key in ("WtT", "SEre", "plane"):
        assert not dist.fft_tables[key].sharding.is_fully_replicated, key
    got = admm_sharded.run_admm_sharded(dist, mesh=mesh)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=3e-4, atol=3e-4
    )


def test_distribute_fan_grouped_placement_and_parity():
    # The fan projector (fft_skew): the single-set parallel tables ("par"
    # subtree) and rebin/DFT filters are node-shared.
    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=16, num_nodes=8, angles_total=64, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=3, eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=20, check_every=10),
        ),
        phantom="const",
    )
    problem = loader.build_problem(cfg, mode="fft_skew")
    mesh = multihost.global_mesh(4)
    dist = multihost.distribute_problem(problem, mesh)
    import jax as _jax

    for leaf in _jax.tree.leaves(dist.fft_tables["shared"]):
        assert leaf.sharding.is_fully_replicated
    assert not dist.fft_tables["fan_valid"].sharding.is_fully_replicated
    got = admm_sharded.run_admm_sharded(dist, mesh=mesh)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=3e-4, atol=3e-4
    )


def test_shared_leaf_leading_dim_collision():
    # A 16-node graph makes the fft_skew tail twiddles' leading dim (D2p=16
    # at small N) EQUAL to the node count — the shape heuristic alone would
    # shard them. The key-based rule must still replicate.
    problem = _problem(P=16, N=8, mode="fft_skew")
    assert problem.fft_tables["shared"]["PhiDre"].shape[0] == 16  # collision
    mesh = multihost.global_mesh(8)
    dist = multihost.distribute_problem(problem, mesh)
    assert dist.fft_tables["shared"]["PhiDre"].sharding.is_fully_replicated
    got = admm_sharded.run_admm_sharded(dist, mesh=mesh)
    ref = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=3e-4, atol=3e-4
    )
