"""Fan-beam rebinning projector vs the per-ray gather fan projector."""

import jax
import jax.numpy as jnp
import numpy as np

from dip_admm_tpu.config import GeometryConfig
from dip_admm_tpu.ops import radon, radon_fan


CFG = GeometryConfig(
    N=32, num_nodes=1, angles_total=64, fan_beam=True,
    det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
)


def _beta(m=64):
    return jnp.asarray((np.arange(m) + 0.5) * 2 * np.pi / m, jnp.float32)


def _smooth_img(N=32):
    c = np.linspace(-1, 1, N)
    X, Y = np.meshgrid(c, c, indexing="ij")
    return jnp.asarray(
        (np.exp(-((X - 0.15) ** 2 + (Y + 0.1) ** 2) / 0.1)
         + 0.7 * np.exp(-((X + 0.25) ** 2 + Y**2) / 0.2)).astype(np.float32)
    )


def test_matches_gather_fan():
    beta = _beta()
    img = _smooth_img()
    ref = np.asarray(radon.project(CFG, img, beta))
    got = np.asarray(radon_fan.project(CFG, img, beta))
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 0.03, rel


def test_adjoint_exact():
    beta = _beta()
    x = jax.random.normal(jax.random.PRNGKey(0), (32, 32))
    y = jax.random.normal(jax.random.PRNGKey(1), (64, CFG.n_det))
    ax = radon_fan.project(CFG, x, beta)
    aty = radon_fan.backproject(CFG, y, beta)
    np.testing.assert_allclose(
        float(jnp.sum(ax * y)), float(jnp.sum(x * aty)), rtol=1e-3
    )


def test_tables_path_equal():
    beta = _beta()
    img = _smooth_img()
    tabs = radon_fan.precompute_fan(CFG, beta)
    a = np.asarray(radon_fan.project(CFG, img, beta))
    b = np.asarray(radon_fan.project(CFG, img, beta, tables=tabs))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_valid_mask():
    m = 64
    beta = _beta(m)
    valid = jnp.asarray([True] * 60 + [False] * 4)
    img = _smooth_img()
    out = np.asarray(radon_fan.project(CFG, img, beta, valid))
    assert (out[60:] == 0).all()
    assert np.abs(out[:60]).max() > 0


def test_fan_colnorms_match_brute_force():
    # W[p] = ||A_fan[:, p]||^2 for the rebinned operator, against columns
    # materialized by projecting basis images (setup-scale oracle).
    import jax
    import jax.numpy as jnp

    from dip_admm_tpu.config import GeometryConfig
    from dip_admm_tpu.ops import radon_fan

    N = 16
    cfg = GeometryConfig(N=N, num_nodes=1, fan_beam=True, angles_total=24)
    beta = jnp.asarray(
        (jnp.arange(24, dtype=jnp.float32) + 0.5) * (2 * jnp.pi / 24)
    )
    tables = radon_fan.precompute_fan(cfg, beta)

    def col(p):
        e = jnp.zeros((N * N,)).at[p].set(1.0).reshape(N, N)
        s = radon_fan.project(cfg, e, beta, tables=tables)
        return jnp.sum(s * s)

    W_brute = np.asarray(jax.lax.map(col, jnp.arange(N * N)))
    W = np.asarray(radon_fan.colnorms_sq(cfg, beta)).reshape(-1)
    mask = W_brute > 0.05 * W_brute.max()
    ratio = W[mask] / W_brute[mask]
    # EXACT (the tridiagonal-circulant identity for the 2-tap rebin filter
    # makes the closed form the true diag(A^T A), replacing the old
    # norm-preserving approximation that overestimated edges by <=1.6x).
    np.testing.assert_allclose(ratio, 1.0, rtol=1e-4)


def test_fan_colnorms_exact_with_row_mask():
    # Per-node valid masks enter the exact column norms through the
    # shift-aligned q weights — check against brute force on a ragged mask.
    import jax
    import jax.numpy as jnp

    from dip_admm_tpu.config import GeometryConfig
    from dip_admm_tpu.ops import radon_fan

    N = 12
    m = 20
    cfg = GeometryConfig(N=N, num_nodes=1, fan_beam=True, angles_total=m)
    beta = jnp.asarray(
        (jnp.arange(m, dtype=jnp.float32) + 0.5) * (2 * jnp.pi / m)
    )
    valid = jnp.asarray(np.r_[np.ones(13, bool), np.zeros(7, bool)])
    tables = radon_fan.precompute_fan(cfg, beta, valid)

    def col(p):
        e = jnp.zeros((N * N,)).at[p].set(1.0).reshape(N, N)
        s = radon_fan.project(cfg, e, beta, valid, tables=tables)
        return jnp.sum(s * s)

    W_brute = np.asarray(jax.lax.map(col, jnp.arange(N * N)))
    W = np.asarray(radon_fan.colnorms_sq(cfg, beta, valid)).reshape(-1)
    mask = W_brute > 0.05 * W_brute.max()
    np.testing.assert_allclose(W[mask] / W_brute[mask], 1.0, rtol=1e-4)


def _fan_nodes(N=24):
    cfg = GeometryConfig(
        N=N, num_nodes=2, angles_total=64, fan_beam=True,
        det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
    )
    angles_np, valid_np, _ = radon.node_angles(cfg)
    beta = jnp.asarray(angles_np, jnp.float32)
    valid = jnp.asarray(valid_np)
    imgs = jax.random.normal(
        jax.random.PRNGKey(0), (beta.shape[0], cfg.N, cfg.N)
    )
    return cfg, beta, valid, imgs


def test_fan_grouped_matches_legacy_and_adjoint():
    """The node-batched fan path (shared factored parallel tables + DFT
    rebin) must match the per-node reference fan projector and be an exact
    adjoint pair."""
    cfg, beta, valid, imgs = _fan_nodes()
    ref = jax.vmap(lambda im, a, v: radon_fan.project(cfg, im, a, v))(
        imgs, beta, valid
    )
    t = radon_fan.precompute_fan_skew(cfg, beta, valid)
    got = radon_fan.project_nodes_fan_skew(cfg, imgs, t)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-5
    )

    y = jax.random.normal(jax.random.PRNGKey(1), got.shape)
    aty = radon_fan.backproject_nodes_fan_skew(cfg, y, t)
    lhs = float(jnp.sum(got * y))
    rhs = float(jnp.sum(imgs * aty))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


def test_fan_skew_matches_grouped_and_adjoint():
    """The hand-composed fan skew adjoint must match the reference adjoint
    (``jax.linear_transpose`` of the per-node fan projector)."""
    cfg, beta, valid, imgs = _fan_nodes()
    t = radon_fan.precompute_fan_skew(cfg, beta, valid)
    y = jax.random.normal(jax.random.PRNGKey(1), (beta.shape[0], 32, cfg.N))
    aty = radon_fan.backproject_nodes_fan_skew(cfg, y, t)
    ref = jax.vmap(lambda s, a, v: radon_fan.backproject(cfg, s, a, v))(
        y, beta, valid
    )
    np.testing.assert_allclose(
        np.asarray(aty), np.asarray(ref), rtol=1e-5, atol=1e-5
    )
