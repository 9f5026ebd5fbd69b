"""``fft_skew`` projector mode: the factored skew operator (plain jnp, row
stage + evaluation tail) must implement exactly the dense-phase-table
operator of mode ``fft`` (``radon_fft.project``), with a hand-composed
adjoint, vmap batching and row-sharded variants that agree with it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

from dip_admm_tpu.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu.core import admm
from dip_admm_tpu.data import loader
from dip_admm_tpu.ops import radon, radon_fft
from dip_admm_tpu.parallel import mesh as meshlib

# Relative max error against the f32 reference. f32 tables: the factoring
# is exact, so only f32 rounding of the DFT products remains. bf16 tables:
# taps, DFT and twiddles are rounded to 8 mantissa bits (~4e-3 each).
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel(got, ref):
    return float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))


@functools.lru_cache(maxsize=None)
def _case(N, dtype):
    geo = GeometryConfig(N=N, num_nodes=2, angles_total=16)
    angles_np, valid_np, _ = radon.node_angles(geo)
    angles = jnp.asarray(angles_np, jnp.float32)
    valid = jnp.asarray(valid_np)
    ref_t = jax.vmap(lambda a, v: radon_fft.precompute_phases(geo, a, v))(
        angles, valid
    )
    t = radon_fft.precompute_skew(geo, angles, valid, table_dtype=dtype)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, N, N))
    y = jax.random.normal(jax.random.PRNGKey(1), (2, angles.shape[1], N))
    ref_fwd = jax.vmap(
        lambda im, a, v, tt: radon_fft.project(geo, im, a, v, tt)
    )(x, angles, valid, ref_t)
    ref_adj = jax.vmap(
        lambda s, a, v, tt: radon_fft.backproject(geo, s, a, v, tt)
    )(y, angles, valid, ref_t)
    fwd = jax.jit(lambda x, t: radon_fft.project_nodes_skew(geo, x, t))(x, t)
    adj = jax.jit(lambda y, t: radon_fft.backproject_nodes_skew(geo, y, t))(
        y, t
    )
    return dict(x=x, y=y, ref_fwd=ref_fwd, ref_adj=ref_adj, fwd=fwd, adj=adj)


GRID = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
SIZES = pytest.mark.parametrize("N", [16, 40, 136])


@GRID
@SIZES
def test_skew_matches_fft_projection(N, dtype):
    c = _case(N, dtype)
    assert _rel(c["fwd"], c["ref_fwd"]) <= TOL[dtype]


@GRID
@SIZES
def test_skew_adjoint_matches_fft(N, dtype):
    c = _case(N, dtype)
    assert _rel(c["adj"], c["ref_adj"]) <= TOL[dtype]


@GRID
@SIZES
def test_skew_adjoint_is_exact_transpose(N, dtype):
    """<Ax, y> = <x, A^T y>, relative to ||Ax|| ||y||."""
    c = _case(N, dtype)
    lhs = float(jnp.sum(c["fwd"] * c["y"]))
    rhs = float(jnp.sum(c["x"] * c["adj"]))
    scale = float(jnp.linalg.norm(c["fwd"]) * jnp.linalg.norm(c["y"]))
    assert abs(lhs - rhs) <= TOL[dtype] * 1e-2 * scale


def test_skew_vmap_matches_scenario_loop():
    """vmap over a scenario axis (the batched-run path) equals one call per
    scenario, forward and adjoint."""
    geo = GeometryConfig(N=16, num_nodes=3, angles_total=24)
    angles_np, valid_np, _ = radon.node_angles(geo)
    t = radon_fft.precompute_skew(
        geo, jnp.asarray(angles_np, jnp.float32), jnp.asarray(valid_np)
    )
    xs = jax.random.normal(jax.random.PRNGKey(2), (4, 3, 16, 16))
    ys = jax.random.normal(jax.random.PRNGKey(3), (4, 3, 8, 16))
    fwd = jax.vmap(lambda x: radon_fft.project_nodes_skew(geo, x, t))(xs)
    adj = jax.vmap(lambda y: radon_fft.backproject_nodes_skew(geo, y, t))(ys)
    for b in range(4):
        np.testing.assert_allclose(
            np.asarray(fwd[b]),
            np.asarray(radon_fft.project_nodes_skew(geo, xs[b], t)),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(adj[b]),
            np.asarray(radon_fft.backproject_nodes_skew(geo, ys[b], t)),
            rtol=1e-5, atol=1e-5,
        )


def test_skew_rowshard_matches_full_on_mesh():
    """Row-sharded forward/adjoint on a 4x2 (node x pixel) mesh of the 8
    virtual devices: each pixel shard applies its row blocks, and the psum /
    all_gather complete the full operator."""
    geo = GeometryConfig(N=16, num_nodes=4, angles_total=32)
    angles_np, valid_np, _ = radon.node_angles(geo)
    t = radon_fft.precompute_skew(
        geo, jnp.asarray(angles_np, jnp.float32), jnp.asarray(valid_np), nb=8
    )
    assert t["WtT"].shape[1] == 2  # NB = 2 row blocks, one per pixel shard
    mesh = meshlib.make_mesh(4, pixel=2)
    spec = dict(meshlib.table_partition_specs(t, 4))
    for key in ("WtT", "SEre", "SEim"):
        spec[key] = PS(meshlib.NODE_AXIS, meshlib.PIXEL_AXIS)
    node = PS(meshlib.NODE_AXIS)

    def sharded(f):
        return jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(node, spec), out_specs=node,
            check_vma=False,
        ))

    x = jax.random.normal(jax.random.PRNGKey(4), (4, 16, 16))
    y = jax.random.normal(jax.random.PRNGKey(5), (4, 8, 16))
    fwd = sharded(lambda x, t: radon_fft.project_nodes_skew_rowshard(
        geo, x, t, meshlib.PIXEL_AXIS))(x, t)
    adj = sharded(lambda y, t: radon_fft.backproject_nodes_skew_rowshard(
        geo, y, t, meshlib.PIXEL_AXIS))(y, t)
    np.testing.assert_allclose(
        np.asarray(fwd), np.asarray(radon_fft.project_nodes_skew(geo, x, t)),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(adj),
        np.asarray(radon_fft.backproject_nodes_skew(geo, y, t)),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize(
    "use_c, valid, tt, Tp",
    [
        # One branch, 40 angles: 8-blocks pad nothing (48 -> 48 slots).
        ([[0] * 40], [[1] * 40], 8, 40),
        # Split 16/32: 48-blocks need 96 slots, 32 -> 64, 16 and 8 -> 48;
        # the tie goes to the larger block.
        ([[0] * 16 + [1] * 32], [[1] * 48], 16, 48),
    ],
)
def test_plan_branch_groups_least_padding(use_c, valid, tt, Tp):
    plan = radon_fft.plan_branch_groups(np.asarray(use_c, bool),
                                        np.asarray(valid, bool))
    assert (plan["tt"], plan["Tp"]) == (tt, Tp)
    P, T = np.asarray(use_c).shape
    # posfull/invposfull are inverse bijections; every block reads the
    # plane of the angles it holds.
    np.testing.assert_array_equal(
        np.take_along_axis(plan["posfull"], plan["invposfull"], axis=1),
        np.tile(np.arange(Tp), (P, 1)),
    )
    src = plan["src_slot"]
    for i in range(P):
        for b in range(Tp // tt):
            blk = src[i, b * tt:(b + 1) * tt]
            live = blk[blk >= 0]
            assert (np.asarray(use_c)[i, live] == plan["plane"][i, b]).all()


def test_plan_branch_groups_invariants():
    rng = np.random.default_rng(0)
    use_c = rng.random((4, 37)) > 0.4
    valid = rng.random((4, 37)) > 0.2
    plan = radon_fft.plan_branch_groups(use_c, valid)
    P, T = use_c.shape
    tt, Tp = plan["tt"], plan["Tp"]
    assert Tp % tt == 0 and Tp >= T
    for i in range(P):
        pos = plan["posfull"][i]
        # bijection and inverse
        assert sorted(pos.tolist()) == list(range(Tp))
        assert (np.argsort(pos) == plan["invposfull"][i]).all()
        src = plan["src_slot"][i]
        # src_slot inverts posfull on real angles
        for t in range(T):
            assert src[pos[t]] == t or not (valid[i, t])
        # every block is single-branch among its valid members
        for tb in range(Tp // tt):
            sl = src[tb * tt:(tb + 1) * tt]
            planes = {
                int(use_c[i, s]) for s in sl if s >= 0 and valid[i, s]
            }
            assert len(planes) <= 1
            if planes:
                assert planes == {int(plan["plane"][i, tb])}
        # invalid angles land on slack (zeroed) slots
        for t in range(T):
            if not valid[i, t]:
                assert src[pos[t]] == -1 or src[pos[t]] == t


def test_permute_rows_inverse_gather_is_adjoint():
    k = jax.random.PRNGKey(3)
    P, Tp, F = 2, 12, 8
    g = jax.random.normal(k, (P, Tp, F))
    pos = jnp.stack(
        [jnp.asarray(np.random.default_rng(i).permutation(Tp))
         for i in range(P)]
    ).astype(jnp.int32)
    inv = jnp.argsort(pos, axis=1).astype(jnp.int32)
    y = radon_fft.permute_rows(g, pos)
    yb = jax.random.normal(k, y.shape)
    gb = radon_fft.permute_rows(yb, inv)
    np.testing.assert_allclose(
        float(jnp.sum(y * yb)), float(jnp.sum(g * gb)), rtol=1e-5
    )


def _cfg(N=16, P=3):
    return ProblemConfig(
        geometry=GeometryConfig(N=N, num_nodes=P, angles_total=24),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            max_iters=4, eps_pri=1e-8, eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=50, check_every=25),
        ),
    )


def test_skew_mode_admm_trajectory_matches_shear():
    """The ADMM trajectory on fft_skew matches the one on the fft
    reference projector."""
    cfg = _cfg()
    r_ref = admm.run_admm(loader.build_problem(cfg, mode="fft"))
    r_sk = admm.run_admm(loader.build_problem(cfg, mode="fft_skew"))
    np.testing.assert_allclose(
        np.asarray(r_sk.x), np.asarray(r_ref.x), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(r_sk.history["primal"]),
        np.asarray(r_ref.history["primal"]), rtol=1e-3, atol=1e-5,
    )


def test_skew_scenario_batching_matches_per_run():
    cfg = _cfg()
    problem = loader.build_problem(cfg, mode="fft_skew")
    bb = jnp.stack([problem.b, problem.b * 1.15])
    res = admm.run_admm_batched(problem, bb)
    for i in range(2):
        single = admm.run_admm(
            dataclasses.replace(problem, b=bb[i]), cfg.admm
        )
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(single.x), rtol=2e-4, atol=2e-4
        )


def test_loader_keeps_one_tap_layout_per_mode():
    """The skew tables carry exactly ONE tap-table layout (the d-major WtT
    the row stage reads), parallel and fan."""
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=16, num_nodes=3, angles_total=18),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(max_iters=1,
                        node=NodeSolverConfig(max_inner=2, check_every=2)),
        phantom="const",
    )
    skew = loader.build_problem(cfg, mode="fft_skew").fft_tables
    assert "WtT" in skew and "Wt" not in skew
    fan_cfg = dataclasses.replace(
        cfg, geometry=dataclasses.replace(
            cfg.geometry, fan_beam=True, angles_total=24,
            det_width_factor=2.0,
        ),
    )
    fan = loader.build_problem(fan_cfg, mode="fft_skew").fft_tables
    par = fan["shared"]["par"]
    assert "WtT" in par and "Wt" not in par
