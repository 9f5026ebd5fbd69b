"""End-to-end decentralized consensus ADMM on a small tomography problem.

The minimum end-to-end slice of SURVEY §7.2 step 2: multi-node graph,
masked per-pixel Q, inexact node solves, midpoint/weighted fusion, residual
stopping — verifying convergence behavior, consensus, reconstruction quality
(PSNR against the phantom) and the history contract of the reference loop
(``/root/reference/block_6_admm_loop_ver2.py:310-326``).
"""

import dataclasses

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
from dip_admm_tpu.utils.imaging import psnr


def small_cfg(**admm_kw):
    return ProblemConfig(
        geometry=GeometryConfig(N=16, num_nodes=3, angles_total=24),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02,
            rho=2.0,
            max_iters=30,
            eps_pri=1e-8,  # don't stop early by default
            eps_dual=1e-8,
            node=NodeSolverConfig(max_inner=300, check_every=25),
            **admm_kw,
        ),
        noise_level=0.005,
        phantom="const",
    )


@pytest.fixture(scope="module")
def result():
    cfg = small_cfg()
    problem = loader.build_problem(cfg)
    return problem, admm.run_admm(problem)


def test_shapes_and_history(result):
    problem, res = result
    P, n = 3, 256
    assert res.x.shape == (P, n)
    assert int(res.n_iters) == 30
    h = res.history
    assert h["primal"].shape == (30,)
    assert h["pri_per_node"].shape == (30, P)
    assert np.isfinite(np.asarray(h["primal"])).all()
    assert np.isfinite(np.asarray(h["obj_per_node"])).all()


def test_residuals_decrease(result):
    _, res = result
    pri = np.asarray(res.history["primal"])
    # Primal residual decreases substantially from its early peak.
    assert pri[-1] < 0.05 * pri[:5].max()


def test_consensus_reached(result):
    _, res = result
    x = np.asarray(res.x)
    spread = np.abs(x - x.mean(axis=0)).max()
    scale = np.abs(x).max()
    assert spread < 0.05 * scale


def test_reconstruction_quality(result):
    problem, res = result
    x_true = np.asarray(problem.x_true)
    x_mean = np.asarray(res.x).mean(axis=0)
    # TV-LS on a piecewise-constant phantom: expect a decent reconstruction.
    val = psnr(x_mean, x_true, data_range=x_true.max())
    assert val > 18.0, f"PSNR too low: {val}"


def test_img_mse_monotone_trend(result):
    _, res = result
    mse = np.asarray(res.history["img_mse_total"])
    assert mse[-1] < mse[0]


def test_weighted_fusion_also_converges():
    cfg = small_cfg(z_fusion="weighted")
    problem = loader.build_problem(cfg)
    res = admm.run_admm(problem)
    pri = np.asarray(res.history["primal"])
    assert pri[-1] < 0.05 * pri[:5].max()
    x_true = np.asarray(problem.x_true)
    val = psnr(np.asarray(res.x).mean(axis=0), x_true, data_range=x_true.max())
    assert val > 18.0


def test_early_stopping():
    cfg = small_cfg()
    cfg = dataclasses.replace(
        cfg, admm=dataclasses.replace(cfg.admm, eps_pri=1e9, eps_dual=1e9)
    )
    problem = loader.build_problem(cfg)
    res = admm.run_admm(problem)
    # Loose tolerances: stops after the first iteration records residuals.
    assert int(res.n_iters) == 1
    assert np.isnan(np.asarray(res.history["primal"])[2:]).all()


def test_matrix_free_matches_dense():
    cfg = small_cfg()
    cfg = dataclasses.replace(
        cfg, admm=dataclasses.replace(cfg.admm, max_iters=5)
    )
    p_dense = loader.build_problem(cfg, dense=True)
    p_free = loader.build_problem(cfg, dense=False)
    r_dense = admm.run_admm(p_dense)
    r_free = admm.run_admm(p_free)
    np.testing.assert_allclose(
        np.asarray(r_dense.x), np.asarray(r_free.x), rtol=1e-3, atol=1e-3
    )


def test_over_relaxation_converges_and_default_matches():
    # alpha=1.0 must be the reference algorithm bit-for-bit (same code
    # path); alpha=1.6 must still converge on the same problem.
    cfg = small_cfg()
    problem = loader.build_problem(cfg)
    r_ref = admm.run_admm(problem)
    cfg_r = dataclasses.replace(cfg.admm, relax_alpha=1.6)
    r_relax = admm.run_admm(problem, cfg=cfg_r)
    pri = np.asarray(r_relax.history["primal"])
    assert pri[-1] < 0.05 * pri[:5].max()
    x_true = np.asarray(problem.x_true)
    val = psnr(
        np.asarray(r_relax.x).mean(axis=0), x_true, data_range=x_true.max()
    )
    assert val > 18.0
    # The relaxed trajectory is genuinely different...
    assert not np.allclose(
        np.asarray(r_relax.history["primal"]), np.asarray(r_ref.history["primal"])
    )


@pytest.mark.parametrize("relax", [1.0, 1.7])
@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_consensus_update_matches_numpy_oracle(fusion, relax):
    """The edge fusion / dual update / residual parts (eqs. 2-5) against a
    per-edge numpy loop over the reference's update formulas."""
    rng = np.random.default_rng(3)
    P, n = 4, 10
    X = rng.normal(size=(P, n)).astype(np.float32)
    Z = rng.normal(size=(P, P, n)).astype(np.float32)
    Y = rng.normal(size=(P, P, n)).astype(np.float32)
    adjm = (rng.random((P, P)) > 0.4).astype(np.float32)
    W = rng.uniform(0.5, 2.0, size=(P, n)).astype(np.float32)
    cfg = AdmmConfig(z_fusion=fusion, relax_alpha=relax)
    Zn, Yn, pri, dz2 = admm.consensus_update(
        jnp.asarray(X), jnp.asarray(Z), jnp.asarray(Y), jnp.asarray(adjm),
        jnp.asarray(W), jnp.asarray(W), cfg, admm.LOCAL_COMM.pair_transpose,
    )
    Zo, Yo = np.zeros_like(Z), np.zeros_like(Y)
    pri_o, dz2_o = np.zeros(P), np.zeros(P)
    for i in range(P):
        for j in range(P):
            if not adjm[i, j]:
                continue
            a_i = relax * X[i] + (1 - relax) * Z[i, j] + Y[i, j]
            a_j = relax * X[j] + (1 - relax) * Z[j, i] + Y[j, i]
            if fusion == "weighted":
                z = (W[i] * a_i + W[j] * a_j) / (W[i] + W[j])
            else:
                z = 0.5 * (a_i + a_j)
            Zo[i, j] = z
            Yo[i, j] = a_i - z
            pri_o[i] += np.sum((a_i - Y[i, j] - z) ** 2)
            dz2_o[i] += np.sum((z - Z[i, j]) ** 2)
    for got, want in ((Zn, Zo), (Yn, Yo), (pri, pri_o), (dz2, dz2_o)):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_per_node_phantoms():
    # Build-mode parity: each node measures its own randomized phantom
    # (ref block_2_load_odl_data.py:134-137); node 0 is the ground truth.
    cfg = small_cfg()
    problem = loader.build_problem(cfg, per_node_phantoms=True)
    # Sinograms differ across nodes beyond the angle-set differences:
    # project node 0's phantom with node 1's geometry and compare.
    import jax.numpy as jnp

    imgs0 = jnp.broadcast_to(problem.x_true[None, :], (3, 256))
    clean0 = problem.forward(imgs0)
    diff = np.abs(np.asarray(clean0[1]) - np.asarray(problem.b[1]))
    assert diff.max() > 1.0  # not just the 0.005 noise


def test_fcv_quality_parity_and_fewer_inner_iters():
    """The circulant-metric inner solver (fcv, VERDICT r3 #1) must hit the
    same reconstruction/residual trajectory as cv at the same acceptance
    contract while spending several-fold fewer inner iterations (the CT
    normal operator is near shift-invariant, so the Fourier metric matches
    its spectral decay; measured 104 -> 33 mean inner at 64^2)."""
    from dip_admm_tpu.utils.imaging import psnr

    cfg = small_cfg()
    problem = loader.build_problem(cfg)
    x_true = np.asarray(problem.x_true)
    results = {}
    for alg in ("cv", "fcv"):
        acfg = dataclasses.replace(
            cfg.admm,
            node=dataclasses.replace(cfg.admm.node, algorithm=alg),
        )
        res = admm.run_admm(problem, acfg)
        x = np.asarray(res.x)
        results[alg] = {
            "psnr": np.mean(
                [psnr(xi, x_true, data_range=x_true.max()) for xi in x]
            ),
            "primal": float(res.history["primal"][int(res.n_iters) - 1]),
            "inner": float(np.nanmean(res.history["inner_iters"])),
        }
    assert abs(results["fcv"]["psnr"] - results["cv"]["psnr"]) < 0.5
    assert results["fcv"]["primal"] <= 1.2 * results["cv"]["primal"] + 1e-3
    assert results["fcv"]["inner"] <= 0.7 * results["cv"]["inner"]


def test_adapt_rho_balances_residuals_and_resumes_exactly():
    """Residual balancing (cfg.adapt_rho, Boyd sec. 3.4.1 / VERDICT r4 #3):
    with a deliberately too-small rho the primal residual dominates, so the
    multiplier must GROW, the effective rho history must move, the run must
    still converge — and the state/hist resume contract must stay exact
    (rho_scale rides in AdmmState)."""
    cfg = small_cfg(adapt_rho=True, rho_mu=2.0)
    cfg = dataclasses.replace(
        cfg, admm=dataclasses.replace(cfg.admm, rho=0.05)
    )
    problem = loader.build_problem(cfg)
    res = admm.run_admm(problem)
    rho_hist = np.asarray(res.history["rho"])[: int(res.n_iters)]
    assert np.nanmax(rho_hist) > 0.05 * 1.9, rho_hist  # grew at least once
    assert not np.isnan(rho_hist).any()
    # Clamp respected.
    assert np.nanmax(rho_hist) <= 0.05 * cfg.admm.rho_clamp + 1e-6
    # Still converges to a sane reconstruction.
    x = np.asarray(res.x)
    assert np.isfinite(x).all()

    # Exact resume through the multiplier: split the run at iteration 10.
    part = admm.run_admm(problem, until=10)
    resumed = admm.run_admm(
        problem, problem.cfg.admm, state=part.state, hist=part.history
    )
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(res.x))
    np.testing.assert_array_equal(
        np.asarray(resumed.history["rho"]), np.asarray(res.history["rho"])
    )


def test_adapt_rho_off_matches_default_exactly():
    """adapt_rho=False must be BIT-identical to a build without the feature
    (the off branch is static python: no scaling ops enter the graph)."""
    cfg = small_cfg()
    problem = loader.build_problem(cfg)
    ref = admm.run_admm(problem)
    cfg2 = small_cfg(adapt_rho=False)
    res = admm.run_admm(loader.build_problem(cfg2))
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    rho_hist = np.asarray(res.history["rho"])[: int(res.n_iters)]
    np.testing.assert_array_equal(rho_hist, np.full_like(rho_hist, 2.0))


def test_adapt_rho_shrinks_on_dual_dominance():
    """With a too-LARGE rho the dual residual dominates and the multiplier
    must shrink below 1."""
    cfg = small_cfg(adapt_rho=True, rho_mu=2.0)
    cfg = dataclasses.replace(
        cfg, admm=dataclasses.replace(cfg.admm, rho=200.0)
    )
    problem = loader.build_problem(cfg)
    res = admm.run_admm(problem)
    rho_hist = np.asarray(res.history["rho"])[: int(res.n_iters)]
    assert np.nanmin(rho_hist) < 200.0 / 1.9, rho_hist


def test_adapt_rho_stall_raises_on_plateau_and_resumes_exactly():
    """Quality-signal policy (adapt_rho_mode="stall", NEXT r5 #6): with a
    zero improvement threshold the primal residual "stalls" at every
    window check, so rho must step up by rho_tau at each
    rho_stall_window cadence point (k+1 in {2w, 3w, ...}), never down —
    and the state/hist resume contract must stay exact (the policy reads
    the carried primal history, not new loop state)."""
    w = 5
    cfg = small_cfg(
        adapt_rho=True, adapt_rho_mode="stall", rho_stall_window=w,
        rho_stall_tol=2.0,  # threshold (1-tol)*prev < 0 <= pri: always stalled
        rho_tau=2.0,
    )
    problem = loader.build_problem(cfg)
    res = admm.run_admm(problem)
    n_it = int(res.n_iters)
    rho_hist = np.asarray(res.history["rho"])[:n_it]
    # Steps at k+1 = 10, 15, 20, 25, 30 -> rho doubles AFTER those iters
    # (the history row records the rho applied THAT iteration).
    assert rho_hist[9] == pytest.approx(2.0)  # still baseline at k=9
    assert rho_hist[10] == pytest.approx(4.0)
    assert rho_hist[15] == pytest.approx(8.0)
    # Monotone non-decreasing: stall mode never lowers rho.
    assert (np.diff(rho_hist) >= -1e-12).all()
    assert np.isfinite(np.asarray(res.x)).all()

    # Exact resume mid-window: the k-w history row must survive the split.
    part = admm.run_admm(problem, until=12)
    resumed = admm.run_admm(
        problem, problem.cfg.admm, state=part.state, hist=part.history
    )
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(res.x))
    np.testing.assert_array_equal(
        np.asarray(resumed.history["rho"]), np.asarray(res.history["rho"])
    )


def test_adapt_rho_stall_no_step_when_improving():
    """With a threshold far above any reachable residual growth
    (stalled iff pri > 11*prev), stall mode must leave rho untouched."""
    cfg = small_cfg(
        adapt_rho=True, adapt_rho_mode="stall", rho_stall_window=5,
        rho_stall_tol=-10.0,  # stalled only if primal GROWS 11x per window
    )
    problem = loader.build_problem(cfg)
    res = admm.run_admm(problem)
    rho_hist = np.asarray(res.history["rho"])[: int(res.n_iters)]
    np.testing.assert_array_equal(rho_hist, np.full_like(rho_hist, 2.0))


def test_harmonic_qmode_e2e_converges():
    """End-to-end convergence under q_mode="harmonic" (the reference ver1
    default, block_7_main_ver1.py:41-51) with TV on — closes the round-4
    coverage hole where harmonic was only exercised by the native-graph
    equivalence test (VERDICT r4 #5)."""
    cfg = small_cfg()
    cfg = dataclasses.replace(
        cfg, graph=dataclasses.replace(cfg.graph, q_mode="harmonic")
    )
    problem = loader.build_problem(cfg)
    res = admm.run_admm(problem)
    n_it = int(res.n_iters)
    pri = np.asarray(res.history["primal"])[:n_it]
    assert pri[-1] < 0.2 * pri[0]  # consensus actually tightens
    x = np.asarray(res.x)
    x_true = np.asarray(problem.x_true)
    ps = np.mean([
        psnr(jnp.asarray(xi), jnp.asarray(x_true),
             data_range=float(x_true.max()))
        for xi in x
    ])
    assert ps > 18.0, ps  # tiny 16^2/3-node problem; ~19.5 measured
    # Different precisions than arithmetic: the trajectories must differ
    # (guards against q_mode silently ignored anywhere in the pipeline).
    res_a = admm.run_admm(loader.build_problem(small_cfg()))
    assert not np.allclose(
        np.asarray(res.x), np.asarray(res_a.x), rtol=1e-4, atol=1e-6
    )


def test_accept_code_accounting():
    """The per-node acceptance codes must be the auditable record of the
    inexact contract (ref ver2's accept/tighten/retry accounting,
    block_6_admm_loop_ver2.py:155-176): a generous budget with a loose
    target yields code 0 (accepted at target); a 1-iteration budget with
    an unreachable target yields code 2 (budget exhausted)."""
    # Loose target, generous budget -> accepted at target.
    cfg = small_cfg()
    cfg = dataclasses.replace(
        cfg, admm=dataclasses.replace(
            cfg.admm, max_iters=3,
            node=dataclasses.replace(
                cfg.admm.node, eps0=1e6, check_every=10, max_inner=100,
            ),
        ),
    )
    res = admm.run_admm(loader.build_problem(cfg))
    codes = np.asarray(res.history["accept_code"])[:3]
    assert (codes == 0).all(), codes

    # Unreachable target, tiny budget -> budget exhausted.
    cfg2 = small_cfg()
    cfg2 = dataclasses.replace(
        cfg2, admm=dataclasses.replace(
            cfg2.admm, max_iters=3,
            node=dataclasses.replace(
                cfg2.admm.node, eps0=1e-12, check_every=1, max_inner=1,
                plateau_tol=0.0,
            ),
        ),
    )
    res2 = admm.run_admm(loader.build_problem(cfg2))
    codes2 = np.asarray(res2.history["accept_code"])[:3]
    assert (codes2 == 2).all(), codes2


def test_adapt_rho_fcv_step_does_not_ratchet():
    """Under adapt_rho + fcv the rho-scaled certified step must NOT ratchet
    into the warm-carried tk (code-review r5): after an iteration at a
    32x rho excursion, a following iteration back at baseline rho must run
    with the FULL certified step again, not the excursion's step/32."""
    import jax.numpy as jnp

    from dip_admm_tpu.core import node_solver

    cfg0 = small_cfg(adapt_rho=True)
    cfg0 = dataclasses.replace(
        cfg0, admm=dataclasses.replace(
            cfg0.admm,
            node=dataclasses.replace(cfg0.admm.node, algorithm="fcv"),
        ),
    )
    problem = loader.build_problem(cfg0)
    acfg = problem.cfg.admm
    data = admm._block_data(problem, acfg, problem.b.dtype)
    state, hist = admm.init_state(problem, acfg)

    # Iteration at a 32x rho excursion: the scaled certified step is
    # step/32, which the solver min()'s into the carried tk.
    st_hi = state._replace(rho_scale=jnp.asarray(32.0, jnp.float32))
    st1, hist = admm.admm_iteration(data, acfg, admm.LOCAL_COMM, st_hi, hist)
    assert float(jnp.max(st1.node.tk)) <= float(
        jnp.max(data.fprecond.step) / 16.0
    )

    # Back at baseline rho: the next solve must see the full certified
    # step again (tk reset to the fresh sentinel before the solve), so the
    # carried tk after the iteration is ~step, not ~step/32.
    st1 = st1._replace(rho_scale=jnp.asarray(1.0, jnp.float32))
    st2, hist = admm.admm_iteration(data, acfg, admm.LOCAL_COMM, st1, hist)
    assert float(jnp.min(st2.node.tk)) >= 0.4 * float(
        jnp.min(data.fprecond.step)
    ), (st2.node.tk, data.fprecond.step)
