"""Fan-beam ``fft_skew``: the node-batched rebinned projector (shared
factored parallel stage + DFT rebin) must implement the per-node reference
fan operator (``radon_fan.project``, dense phase tables), with a
hand-composed adjoint, vmap batching and a row-sharded variant."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

from dip_admm_tpu.config import GeometryConfig
from dip_admm_tpu.ops import radon, radon_fan
from dip_admm_tpu.parallel import mesh as meshlib

# Same bounds and reasons as the parallel-beam grid (tests/test_fft_skew.py).
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _geo(N, P=2, angles_total=32):
    return GeometryConfig(
        N=N, num_nodes=P, angles_total=angles_total, fan_beam=True,
        det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
    )


def _angles(geo):
    angles_np, valid_np, _ = radon.node_angles(geo)
    return jnp.asarray(angles_np, jnp.float32), jnp.asarray(valid_np)


def _rel(got, ref):
    return float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))


@functools.lru_cache(maxsize=None)
def _case(N, dtype):
    geo = _geo(N)
    beta, valid = _angles(geo)
    ref_t = jax.vmap(lambda a, v: radon_fan.precompute_fan(geo, a, v))(
        beta, valid
    )
    t = radon_fan.precompute_fan_skew(geo, beta, valid, table_dtype=dtype)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, N, N))
    y = jax.random.normal(jax.random.PRNGKey(1), (2, beta.shape[1], N))
    ref_fwd = jax.vmap(
        lambda im, a, v, tt: radon_fan.project(geo, im, a, v, tt)
    )(x, beta, valid, ref_t)
    ref_adj = jax.vmap(
        lambda s, a, v, tt: radon_fan.backproject(geo, s, a, v, tt)
    )(y, beta, valid, ref_t)
    fwd = jax.jit(lambda x, t: radon_fan.project_nodes_fan_skew(geo, x, t))(
        x, t
    )
    adj = jax.jit(
        lambda y, t: radon_fan.backproject_nodes_fan_skew(geo, y, t)
    )(y, t)
    return dict(x=x, y=y, ref_fwd=ref_fwd, ref_adj=ref_adj, fwd=fwd, adj=adj)


GRID = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
SIZES = pytest.mark.parametrize("N", [16, 40, 136])


@GRID
@SIZES
def test_fan_skew_forward_matches_fft(N, dtype):
    c = _case(N, dtype)
    assert _rel(c["fwd"], c["ref_fwd"]) <= TOL[dtype]


@GRID
@SIZES
def test_fan_skew_adjoint_matches_fft(N, dtype):
    c = _case(N, dtype)
    assert _rel(c["adj"], c["ref_adj"]) <= TOL[dtype]


@GRID
@SIZES
def test_fan_skew_adjoint_identity(N, dtype):
    """<Ax, y> = <x, A^T y>, relative to ||Ax|| ||y||."""
    c = _case(N, dtype)
    lhs = float(jnp.sum(c["fwd"] * c["y"]))
    rhs = float(jnp.sum(c["x"] * c["adj"]))
    scale = float(jnp.linalg.norm(c["fwd"]) * jnp.linalg.norm(c["y"]))
    assert abs(lhs - rhs) <= TOL[dtype] * 1e-2 * scale


def test_fan_skew_vmap_matches_scenario_loop():
    geo = _geo(16)
    beta, valid = _angles(geo)
    t = radon_fan.precompute_fan_skew(geo, beta, valid)
    xs = jax.random.normal(jax.random.PRNGKey(2), (3, 2, 16, 16))
    ys = jax.random.normal(jax.random.PRNGKey(3), (3, 2, 16, 16))
    fwd = jax.vmap(lambda x: radon_fan.project_nodes_fan_skew(geo, x, t))(xs)
    adj = jax.vmap(
        lambda y: radon_fan.backproject_nodes_fan_skew(geo, y, t)
    )(ys)
    for b in range(3):
        np.testing.assert_allclose(
            np.asarray(fwd[b]),
            np.asarray(radon_fan.project_nodes_fan_skew(geo, xs[b], t)),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(adj[b]),
            np.asarray(radon_fan.backproject_nodes_fan_skew(geo, ys[b], t)),
            rtol=1e-5, atol=1e-5,
        )


def test_fan_skew_rowshard_matches_full_on_mesh():
    """The shared parallel-stage row tables shard along NB over the pixel
    axis of a 4x2 mesh; per-node row masks shard over the node axis."""
    geo = _geo(16, P=4, angles_total=64)
    beta, valid = _angles(geo)
    t = radon_fan.precompute_fan_skew(geo, beta, valid, nb=8)
    assert t["shared"]["par"]["WtT"].shape[1] == 2
    mesh = meshlib.make_mesh(4, pixel=2)
    spec = meshlib.table_partition_specs(t, 4)
    spec["shared"] = dict(spec["shared"])
    spec["shared"]["par"] = dict(spec["shared"]["par"])
    for key in ("WtT", "SEre", "SEim"):
        spec["shared"]["par"][key] = PS(None, meshlib.PIXEL_AXIS)
    node = PS(meshlib.NODE_AXIS)

    def sharded(f):
        return jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(node, spec), out_specs=node,
            check_vma=False,
        ))

    x = jax.random.normal(jax.random.PRNGKey(4), (4, 16, 16))
    y = jax.random.normal(jax.random.PRNGKey(5), (4, 16, 16))
    fwd = sharded(lambda x, t: radon_fan.project_nodes_fan_skew_rowshard(
        geo, x, t, meshlib.PIXEL_AXIS))(x, t)
    adj = sharded(lambda y, t: radon_fan.backproject_nodes_fan_skew_rowshard(
        geo, y, t, meshlib.PIXEL_AXIS))(y, t)
    np.testing.assert_allclose(
        np.asarray(fwd),
        np.asarray(radon_fan.project_nodes_fan_skew(geo, x, t)),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(adj),
        np.asarray(radon_fan.backproject_nodes_fan_skew(geo, y, t)),
        rtol=1e-5, atol=1e-5,
    )
