"""End-to-end decentralized ADMM on a fan-beam problem (matrix-free rebinned
projector) — the BASELINE config-5 geometry at test scale."""

import numpy as np

from dip_admm_tpu.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu.core import admm
from dip_admm_tpu.data import loader
from dip_admm_tpu.utils.imaging import psnr


def test_fan_fft_mode_reconstructs():
    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=16, num_nodes=2, angles_total=64, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="complete", k=0, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=25, eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=300, check_every=25),
        ),
        noise_level=0.002,
        phantom="const",
    )
    problem = loader.build_problem(cfg, mode="fft")
    assert problem.fft_tables is not None and "rebin_re" in problem.fft_tables
    res = admm.run_admm(problem)
    x_true = np.asarray(problem.x_true)
    val = psnr(np.asarray(res.x).mean(axis=0), x_true, data_range=x_true.max())
    assert val > 17.0, val
    pri = np.asarray(res.history["primal"])
    assert pri[-1] < 0.1 * pri[:5].max()


def test_fan_skew_mode_matches_fft_mode():
    """mode=fft_skew on a fan problem (factored-shear parallel stage on the
    rebinned grid + rebin tail) reproduces the mode=fft fan trajectory."""
    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=16, num_nodes=2, angles_total=64, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="complete", k=0, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=8, eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=60, check_every=20),
        ),
        noise_level=0.002,
        phantom="const",
    )
    r_fft = admm.run_admm(loader.build_problem(cfg, mode="fft"))
    r_skw = admm.run_admm(loader.build_problem(cfg, mode="fft_skew"))
    np.testing.assert_allclose(
        np.asarray(r_skw.x), np.asarray(r_fft.x), rtol=2e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(r_skw.history["primal"]),
        np.asarray(r_fft.history["primal"]), rtol=2e-3, atol=1e-4,
    )


def test_fan_fcv_converges():
    """The circulant-metric inner solver composes with the rebinned fan
    operator (the impulse-probe transfer function + power-method step
    certificate cover the rebin's mild shift-variance)."""
    import dataclasses

    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=16, num_nodes=2, angles_total=64, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
        graph=GraphConfig(strategy="complete", k=0, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=12, eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=60, check_every=20,
                                  algorithm="fcv"),
        ),
        noise_level=0.002,
        phantom="const",
    )
    res = admm.run_admm(loader.build_problem(cfg, mode="fft_skew"))
    x_true = np.asarray(res.x).mean(axis=0)
    problem = loader.build_problem(cfg, mode="fft_skew")
    val = psnr(
        np.asarray(res.x).mean(axis=0), np.asarray(problem.x_true),
        data_range=float(np.asarray(problem.x_true).max()),
    )
    assert val > 17.0, val
    pri = np.asarray(res.history["primal"])
    assert pri[-1] < 0.1 * pri[:4].max()
