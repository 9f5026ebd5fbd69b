"""Problem construction: the default projector rule and the precision the
projector operators state on their contractions."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from dip_admm_tpu.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu.data import loader
from dip_admm_tpu.ops import radon


def _cfg(N=16, P=3, angles_total=24):
    return ProblemConfig(
        geometry=GeometryConfig(N=N, num_nodes=P, angles_total=angles_total),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(max_iters=2,
                        node=NodeSolverConfig(max_inner=4, check_every=2)),
    )


def test_auto_mode_defaults_to_fastest_above_128():
    """Dense operator up to 128^2; above that the projector measured
    fastest on the GPU (fft_skew), for parallel and fan beam."""
    assert loader.build_problem(_cfg()).mode == "dense"
    big = _cfg(N=136, P=2, angles_total=8)
    assert loader.build_problem(big).mode == "fft_skew"
    fan = dataclasses.replace(
        big, geometry=dataclasses.replace(big.geometry, fan_beam=True)
    )
    assert loader.build_problem(fan).mode == "fft_skew"
    assert loader.auto_mode(128) == "dense"
    assert loader.auto_mode(129) == "fft_skew"


def test_build_fft_tables_rejects_other_modes():
    cfg = _cfg()
    angles_np, valid_np, _ = radon.node_angles(cfg.geometry)
    with pytest.raises(ValueError, match="joseph"):
        loader.build_fft_tables(cfg, jnp.asarray(angles_np),
                                jnp.asarray(valid_np), "joseph")


def _dots(jaxpr):
    """Every dot_general equation of a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dots(inner)


@pytest.mark.parametrize(
    "mode, fan, table_dtype",
    [
        ("dense", False, "float32"),
        ("fft", False, "float32"),
        ("fft_skew", False, "float32"),
        ("fft", True, "float32"),
        ("fft_skew", True, "float32"),
        ("fft_skew", False, "bfloat16"),
    ],
)
def test_contractions_state_their_precision(mode, fan, table_dtype):
    """Every f32 contraction of the forward and adjoint asks for
    Precision.HIGHEST (a tensor-core GPU would round it to TF32 otherwise);
    bf16-table contractions take bf16 operands and accumulate in f32."""
    geo = GeometryConfig(N=16, num_nodes=2, angles_total=32, fan_beam=fan,
                         det_width_factor=2.0 if fan else 1.0)
    cfg = dataclasses.replace(
        _cfg(), geometry=geo, fft_table_dtype=table_dtype
    )
    angles_np, valid_np, _ = radon.node_angles(geo)
    angles = jnp.asarray(angles_np, jnp.float32)
    valid = jnp.asarray(valid_np)
    A = tables = None
    if mode == "dense":
        A = jnp.stack([radon.dense_matrix(geo, angles[i], valid[i])
                       for i in range(2)])
    else:
        tables = loader.build_fft_tables(cfg, angles, valid, mode)
    fwd, adj = loader.make_node_ops(mode, geo, angles, valid, A, tables)
    x = jnp.ones((2, geo.n))
    y = jnp.ones((2, angles.shape[1] * geo.n_det))
    jaxpr = jax.make_jaxpr(lambda x, y: (fwd(x), adj(y)))(x, y).jaxpr
    dots = list(_dots(jaxpr))
    assert dots
    highest = (jax.lax.Precision.HIGHEST,) * 2
    n_bf16 = 0
    for eqn in dots:
        dtypes = {v.aval.dtype for v in eqn.invars}
        if dtypes == {jnp.dtype(jnp.float32)}:
            assert eqn.params["precision"] == highest, eqn
        else:
            assert dtypes == {jnp.dtype(jnp.bfloat16)}, eqn
            assert eqn.params["preferred_element_type"] == jnp.float32
            n_bf16 += 1
    assert (n_bf16 > 0) == (table_dtype == "bfloat16")
