"""Gather-free fan-beam projector via parallel-beam rebinning.

Completes the matrix-free operator family for the fan-beam configuration
(config 5: 512^2 fan beam, 32 nodes) without gathers: a flat-detector
fan ray (source angle beta, detector offset d) is exactly the parallel-beam
ray at

    theta = beta + gamma - pi/2,     s = -R_src * sin(gamma),
    gamma = atan(d / (R_src + R_det)),

so the fan sinogram is an *angular resampling* of a parallel sinogram
evaluated on the nonuniform detector grid {s_l}:

  1. parallel-project with the FFT-shear projector (``ops.radon_fft``, which
     accepts explicit detector positions) at T_p = T_fan/2 uniform angles,
  2. extend to a 2*pi-periodic sinogram with the flip identity
     p(theta + pi, s) = p(theta, -s) (exact for the symmetric grid),
  3. shift each detector column along the angle axis by gamma_l/dbeta —
     an exact-linear-interp circular shift done with one rFFT/irFFT pair and
     a per-column phase filter (the same machinery as the row shears).

The composed operator is linear with an automatic exact adjoint; accuracy vs
the per-ray gather Joseph fan projector is a few percent (angular linear
interpolation + the composite in-row kernel), verified by tests. Requires an
even fan angle count per node (the flip identity pairs the half-turns).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dip_admm_tpu.config import GeometryConfig
from dip_admm_tpu.ops import radon, radon_fft


def _parallel_cfg(cfg: GeometryConfig) -> GeometryConfig:
    import dataclasses

    return dataclasses.replace(cfg, fan_beam=False)


def precompute_fan(
    cfg: GeometryConfig,
    beta: jnp.ndarray,
    valid=None,
    table_dtype=jnp.float32,
):
    """Tables for :func:`project`: the parallel-stage phase tables on the
    rebinned detector grid plus the per-column angular shift filter."""
    assert cfg.fan_beam
    m = beta.shape[0]
    if m % 2 != 0:
        raise ValueError("fan rebinning needs an even angle count per node")
    T_p = m // 2
    D = cfg.n_det
    dets = jnp.asarray(
        radon.detector_centers(D, cfg.det_width_factor * 2.0), jnp.float32
    )
    gamma = jnp.arctan(dets / (cfg.src_radius + cfg.det_radius))  # [D]
    s_l = -cfg.src_radius * jnp.sin(gamma)

    theta = (jnp.arange(T_p, dtype=jnp.float32) + 0.5) * (jnp.pi / T_p)
    par = radon_fft.precompute_phases(
        _parallel_cfg(cfg), theta, valid=None, table_dtype=table_dtype,
        dets=s_l,
    )

    # Column shift in beta-index units; the fan beta grid must be the
    # uniform (j+0.5)*2*pi/m grid (node_angles provides exactly that).
    dbeta = 2.0 * jnp.pi / m
    shift = (gamma - jnp.pi / 2.0) / dbeta  # [D]
    k = jnp.floor(shift)
    fr = shift - k
    F = T_p + 1  # rfft length of the 2*T_p-periodic angle axis
    f = jnp.arange(F, dtype=jnp.float32)
    ang = (2.0 * jnp.pi / m) * f
    base = jnp.exp(1j * ang[None, :] * k[:, None])  # [D, F]
    tap = (1.0 - fr)[:, None] + fr[:, None] * jnp.exp(1j * ang[None, :])
    R = (base * tap).astype(jnp.complex64)
    tables = dict(par)
    tables["rebin_re"] = jnp.real(R).astype(table_dtype)
    tables["rebin_im"] = jnp.imag(R).astype(table_dtype)
    if valid is not None:
        tables["fan_valid"] = valid.astype(jnp.float32)
    return tables


def colnorms_sq_nodes(cfg: GeometryConfig, beta: jnp.ndarray, valid=None):
    """EXACT W[i, p] = ||A_i[:, p]||^2 for the rebinned fan operator,
    batched over nodes (beta/valid [P, m] -> [P, N, N]).

    The fan operator factors as A = M_i Sh P2 A_par: the parallel stage
    (composite 2-tap kernel, exact per-pixel weights w_t[l, a, i]), the
    flip periodization P2, the per-detector-column circular shift Sh
    (integer shift k_l + fractional 2-tap fr_l), and the node's fan-row
    mask M_i. Because the fractional tap couples only ADJACENT angles,

        Sh^T M Sh  =  diag(q_tt) + offdiag_1(q_t1)   per column l,
        q_tt(t) = (1-fr)^2 M(t-k) + fr^2 M(t-k-1),
        q_t1(t) = fr (1-fr) M(t-k),

    so the exact column norm needs only the per-angle weight blocks and
    their adjacent-angle correlations on the periodized grid — no operator
    applications. Replaces the norm-preserving approximation (exact at the
    center, <=1.6x at edges); oracle-tested against brute-force columns.
    Setup-time cost: one [D, N, N] block per parallel angle, shared across
    nodes (per-node masks enter only through the q weights).
    (Reference weight semantics: ``block_3_graph_and_precisions.py:21-24``.)
    """
    assert cfg.fan_beam
    P, m = beta.shape
    V = (
        jnp.ones((P, m), jnp.float32)
        if valid is None
        else valid.astype(jnp.float32)
    )
    return _colnorms_sq_nodes_jit(cfg, m, P, V)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _colnorms_sq_nodes_jit(cfg: GeometryConfig, m: int, P: int, V):
    T_p = m // 2
    D, N = cfg.n_det, cfg.N
    theta, s_l, shift = _rebin_geometry(cfg, m)
    k = jnp.floor(shift).astype(jnp.int32)  # [D]
    fr = (shift - jnp.floor(shift)).astype(jnp.float32)
    t_idx = jnp.arange(m)[:, None]  # [m, 1]
    Vk = V[:, (t_idx - k[None, :]) % m]  # [P, m, D] = M(t - k_l)
    Vk1 = V[:, (t_idx - k[None, :] - 1) % m]
    q_tt = (1.0 - fr) ** 2 * Vk + fr**2 * Vk1  # [P, m, D]
    q_t1 = (fr * (1.0 - fr)) * Vk
    # Fold the periodized second half (y(t+T_p, l) = y(t, D-1-l)) back onto
    # t in [0, T_p): diagonal, interior-pair and seam-pair weights.
    e1 = q_tt[:, :T_p] + q_tt[:, T_p:, ::-1]  # [P, T_p, D]
    e2 = q_t1[:, : T_p - 1] + q_t1[:, T_p : m - 1, ::-1]  # [P, T_p-1, D]
    e3 = q_t1[:, T_p - 1] + q_t1[:, m - 1, ::-1]  # [P, D]

    cfgp = _parallel_cfg(cfg)
    (Pr, Br, Cr, sr), (Pc, Bc, Cc, sc), use_r = radon_fft._coeffs(
        cfgp, theta, dets=s_l
    )
    i_idx = jnp.arange(N, dtype=jnp.float32)
    a_idx = jnp.arange(N, dtype=jnp.float32)

    def wblock(t):
        """Exact per-pixel weights of parallel angle t: [D, N, N] on the
        image grid (branch C computes on the transposed image)."""

        def one(p, B, C, scale):
            v0 = jnp.floor(p)
            fp = p - v0
            sig = B * a_idx + C  # [N]

            def tap(v, wv):
                pos = v[:, None] + sig[None, :]  # [D, N]
                h = jnp.maximum(
                    0.0, 1.0 - jnp.abs(pos[:, :, None] - i_idx[None, None, :])
                )
                return wv[:, None, None] * h

            return scale * (tap(v0, 1.0 - fp) + tap(v0 + 1.0, fp))

        # Branch-select coefficients before the [D, N, N] block build (one
        # block per angle, not two); only the orientation needs the select.
        sel = use_r[t]
        w = one(
            jnp.where(sel, Pr[t], Pc[t]),
            jnp.where(sel, Br[t], Bc[t]),
            jnp.where(sel, Cr[t], Cc[t]),
            jnp.where(sel, sr[t], sc[t]),
        )
        return jnp.where(sel, w, w.transpose(0, 2, 1))

    ein = functools.partial(radon_fft._ein32, "pl,lai->pai")
    w0 = wblock(0)
    W = ein(e1[:, 0], w0 * w0)

    def body(carry, t):
        Wacc, w_prev = carry
        w = wblock(t)
        Wacc = Wacc + ein(e1[:, t], w * w)
        Wacc = Wacc + 2.0 * ein(e2[:, t - 1], w_prev * w)
        return (Wacc, w), None

    (W, w_last), _ = jax.lax.scan(body, (W, w0), jnp.arange(1, T_p))
    # Seam pairs (T_p-1 <-> T_p and m-1 <-> 0 on the periodized circle).
    W = W + 2.0 * ein(e3, w_last * w0[::-1])
    return W


def colnorms_sq(cfg: GeometryConfig, beta: jnp.ndarray, valid=None):
    """Single-node wrapper of :func:`colnorms_sq_nodes` (beta [m])."""
    v = None if valid is None else valid[None]
    return colnorms_sq_nodes(cfg, beta[None], v)[0]


def project(
    cfg: GeometryConfig,
    img: jnp.ndarray,
    beta: jnp.ndarray,
    valid=None,
    tables=None,
) -> jnp.ndarray:
    """Fan forward projection [N, N] x [T_fan] -> [T_fan, D]."""
    if tables is None:
        tables = precompute_fan(cfg, beta, valid)
    t = tables
    p = radon_fft._branch_apply(img, t["Hre_r"], t["Him_r"], t["p_r"], t["s_r"])
    p = p + radon_fft._branch_apply(
        img.T, t["Hre_c"], t["Him_c"], t["p_c"], t["s_c"]
    )  # [T_p, D]
    p2 = jnp.concatenate([p, p[:, ::-1]], axis=0)  # [2 T_p, D], 2*pi-periodic
    m = p2.shape[0]
    phat = jnp.fft.rfft(p2, axis=0)  # [F, D]
    Rre = t["rebin_re"].T.astype(jnp.float32)  # [F, D]
    Rim = t["rebin_im"].T.astype(jnp.float32)
    out_hat = jax.lax.complex(
        jnp.real(phat) * Rre - jnp.imag(phat) * Rim,
        jnp.real(phat) * Rim + jnp.imag(phat) * Rre,
    )
    out = jnp.fft.irfft(out_hat, n=m, axis=0).astype(img.dtype)  # [T_fan, D]
    if "fan_valid" in t:
        out = out * t["fan_valid"][:, None]
    elif valid is not None:
        out = jnp.where(valid[:, None], out, 0.0)
    return out


def backproject(
    cfg: GeometryConfig,
    sino: jnp.ndarray,
    beta: jnp.ndarray,
    valid=None,
    tables=None,
) -> jnp.ndarray:
    """Exact adjoint of :func:`project`."""
    N = cfg.N
    if tables is None:
        tables = precompute_fan(cfg, beta, valid)
    f = lambda x: project(cfg, x, beta, valid, tables)
    (out,) = jax.linear_transpose(f, jnp.zeros((N, N), sino.dtype))(sino)
    return out


def _rebin_geometry(cfg: GeometryConfig, m: int):
    D = cfg.n_det
    dets = jnp.asarray(
        radon.detector_centers(D, cfg.det_width_factor * 2.0), jnp.float32
    )
    gamma = jnp.arctan(dets / (cfg.src_radius + cfg.det_radius))  # [D]
    s_l = -cfg.src_radius * jnp.sin(gamma)
    T_p = m // 2
    theta = (jnp.arange(T_p, dtype=jnp.float32) + 0.5) * (jnp.pi / T_p)
    dbeta = 2.0 * jnp.pi / m
    shift = (gamma - jnp.pi / 2.0) / dbeta  # [D] in beta-index units
    return theta, s_l, shift


def _rebin_apply(p2, t):
    """[P, m, D] periodic parallel sinograms -> [P, m, D] fan sinograms:
    per-detector-column circular shift by the rebin phase filter, as real
    DFT matmuls."""
    ein = radon_fft._ein32
    ph_re = ein("pmd,mf->pfd", p2, t["Bre"])
    ph_im = ein("pmd,mf->pfd", p2, t["Bim"])
    Rre = t["rebin_re"].T[None]  # [1, F, D]
    Rim = t["rebin_im"].T[None]
    o_re = ph_re * Rre - ph_im * Rim
    o_im = ph_re * Rim + ph_im * Rre
    return ein("pfd,fm->pmd", o_re, t["Dre"]) + ein(
        "pfd,fm->pmd", o_im, t["Dim"]
    )


def _rebin_apply_t(bar, t):
    """Exact transpose of :func:`_rebin_apply`."""
    ein = radon_fft._ein32
    z_re = ein("pmd,fm->pfd", bar, t["Dre"])
    z_im = ein("pmd,fm->pfd", bar, t["Dim"])
    Rre = t["rebin_re"].T[None]
    Rim = t["rebin_im"].T[None]
    ph_re = z_re * Rre + z_im * Rim
    ph_im = -z_re * Rim + z_im * Rre
    return ein("pfd,mf->pmd", ph_re, t["Bre"]) + ein(
        "pfd,mf->pmd", ph_im, t["Bim"]
    )


def precompute_fan_skew(
    cfg: GeometryConfig,
    beta: jnp.ndarray,  # [P, m] uniform per-node grids (node_angles)
    valid=None,  # [P, m] bool
    table_dtype=jnp.float32,
    nb: int = 128,  # row-block size of the parallel-stage factorization
):
    """Tables for :func:`project_nodes_fan_skew`: the parallel rebin stage
    on the factored skew tables (``radon_fft.precompute_skew`` with the
    nonuniform rebinned detector grid) + the angular rebin phase filter +
    angle-axis DFT matrices + per-node row masks.

    The parallel-stage geometry (theta grid over [0, pi), rebinned detector
    positions s_l) is identical for every node, so all nodes share ONE
    single-set table (leading dim 1) and the per-image application vmaps
    over nodes. Everything but the per-node row masks is node-SHARED: the
    "shared" subtree is the placement contract with
    ``parallel.mesh.table_partition_specs``."""
    assert cfg.fan_beam
    P, m = beta.shape
    if m % 2 != 0:
        raise ValueError("fan rebinning needs an even angle count per node")
    T_p = m // 2
    theta, s_l, shift = _rebin_geometry(cfg, m)
    par = radon_fft.precompute_skew(
        _parallel_cfg(cfg), theta[None], valid=None,
        table_dtype=table_dtype, dets=s_l, nb=nb,
    )

    @jax.jit
    def rebin_filter(shift):
        k = jnp.floor(shift)
        fr = shift - k
        F = T_p + 1  # rfft length of the m-periodic angle axis
        f = jnp.arange(F, dtype=jnp.float32)
        ang = (2.0 * jnp.pi / m) * f
        bre = jnp.cos(ang[None, :] * k[:, None])  # [D, F]
        bim = jnp.sin(ang[None, :] * k[:, None])
        tre = (1.0 - fr)[:, None] + fr[:, None] * jnp.cos(ang)[None, :]
        tim = fr[:, None] * jnp.sin(ang)[None, :]
        return bre * tre - bim * tim, bre * tim + bim * tre

    Rre, Rim = rebin_filter(shift)
    Bre, Bim, Dre, Dim = jax.jit(radon_fft._dft_mats, static_argnums=(0, 1))(
        m, m
    )
    if valid is None:
        valid = jnp.ones((P, m), bool)
    return {
        "shared": {
            "par": par,
            "rebin_re": Rre.astype(jnp.float32),  # [D, F]
            "rebin_im": Rim.astype(jnp.float32),
            "Bre": Bre, "Bim": Bim,
            "Dre": Dre, "Dim": Dim,
        },
        "fan_valid": valid.astype(jnp.float32),  # [P, m]
    }


def project_nodes_fan_skew(cfg: GeometryConfig, imgs, tables):
    """Batched fan forward projection [P, N, N] -> [P, m, D]: the skew row
    stage + factored eval tail for the shared parallel stage, then the
    angular rebin as DFT matrix products."""
    t = tables
    cfg_par = _parallel_cfg(cfg)
    T_p = t["fan_valid"].shape[1] // 2

    def one(img):
        return radon_fft.project_nodes_skew(
            cfg_par, img[None], t["shared"]["par"], n_rows=T_p
        )[0]

    p = jax.vmap(one)(imgs)  # [P, T_p, D]
    p2 = jnp.concatenate([p, p[:, :, ::-1]], axis=1)  # [P, m, D]
    out = _rebin_apply(p2, t["shared"])
    return (out * t["fan_valid"][:, :, None]).astype(imgs.dtype)


def backproject_nodes_fan_skew(cfg: GeometryConfig, sinos, tables):
    """Exact adjoint of :func:`project_nodes_fan_skew`, composed by hand
    (verified against ``jax.linear_transpose`` in tests)."""
    t = tables
    cfg_par = _parallel_cfg(cfg)
    T_p = t["fan_valid"].shape[1] // 2
    ob = sinos.astype(jnp.float32) * t["fan_valid"][:, :, None]
    p2_bar = _rebin_apply_t(ob, t["shared"])
    p_bar = p2_bar[:, :T_p] + p2_bar[:, T_p:, ::-1]

    def one(pb):
        return radon_fft.backproject_nodes_skew(
            cfg_par, pb[None].astype(sinos.dtype), t["shared"]["par"]
        )[0]

    return jax.vmap(one)(p_bar).astype(sinos.dtype)


def project_nodes_fan_skew_rowshard(cfg: GeometryConfig, imgs, tables,
                                    axis_name: str):
    """Pixel-axis COMPUTE sharding of the fan skew projector: the shared
    parallel-stage row tables (``shared.par`` — ``WtT``/``SEre``/``SEim``,
    pre-sliced along their NB axis by the shard_map in_specs) apply only
    this shard's row blocks; one psum of the slot-spectrum pair completes
    the parallel stage, and the small angular rebin tail stays replicated
    (like the eval tail on the parallel path)."""
    t = tables
    cfg_par = _parallel_cfg(cfg)
    T_p = t["fan_valid"].shape[1] // 2

    def one(img):
        return radon_fft.project_nodes_skew_rowshard(
            cfg_par, img[None], t["shared"]["par"], axis_name, n_rows=T_p
        )[0]

    p = jax.vmap(one)(imgs)  # [P, T_p, D]
    p2 = jnp.concatenate([p, p[:, :, ::-1]], axis=1)  # [P, m, D]
    out = _rebin_apply(p2, t["shared"])
    return (out * t["fan_valid"][:, :, None]).astype(imgs.dtype)


def backproject_nodes_fan_skew_rowshard(cfg: GeometryConfig, sinos, tables,
                                        axis_name: str):
    """Exact adjoint of :func:`project_nodes_fan_skew_rowshard`: replicated
    rebin transpose, row-sharded tap-matmul transpose, pixel-axis
    all_gather inside the sharded skew adjoint."""
    t = tables
    cfg_par = _parallel_cfg(cfg)
    T_p = t["fan_valid"].shape[1] // 2
    ob = sinos.astype(jnp.float32) * t["fan_valid"][:, :, None]
    p2_bar = _rebin_apply_t(ob, t["shared"])
    p_bar = p2_bar[:, :T_p] + p2_bar[:, T_p:, ::-1]

    def one(pb):
        return radon_fft.backproject_nodes_skew_rowshard(
            cfg_par, pb[None].astype(sinos.dtype), t["shared"]["par"],
            axis_name,
        )[0]

    return jax.vmap(one)(p_bar).astype(sinos.dtype)
