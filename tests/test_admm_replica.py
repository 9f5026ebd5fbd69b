"""Independent trajectory oracle for the consensus loop.

With lam_tv = 0 the node subproblem (eq. 1) has the closed form
    x_i = (A_i^T A_i + rho diag(D_i))^{-1} (A_i^T b_i + rho b_cons_i),
so a direct numpy implementation of the reference's update equations
(``/root/reference/block_6_admm_loop_ver2.py:210-264``) gives exact
trajectories to compare the JAX loop against — primal/dual residual curves
and iterates must match when the inner solver is run to tight tolerance.
"""

import dataclasses

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


def numpy_admm_reference(A, b, Q, adj, rho, iters):
    """Straight numpy transcription of eqs. 1-6 with exact node solves."""
    P, m, n = A.shape
    x = np.zeros((P, n))
    z = np.zeros((P, P, n))
    y = np.zeros((P, P, n))
    AtA = np.einsum("pmn,pmk->pnk", A, A)
    Atb = np.einsum("pmn,pm->pn", A, b)
    pri_hist, dual_hist = [], []
    for _ in range(iters):
        v = z - y
        for i in range(P):
            D = Q[i].sum(axis=0)
            b_cons = (Q[i] * v[i]).sum(axis=0)
            M = AtA[i] + rho * np.diag(D)
            x[i] = np.linalg.solve(M, Atb[i] + rho * b_cons)
        a = x[:, None, :] + y
        zn = 0.5 * (a + a.transpose(1, 0, 2)) * adj[:, :, None]
        y = (y + x[:, None, :] - zn) * adj[:, :, None]
        r2 = np.sum(((x[:, None, :] - zn) * adj[:, :, None]) ** 2)
        s2 = 0.5 * rho**2 * np.sum(((zn - z) * adj[:, :, None]) ** 2)
        z = zn
        pri_hist.append(np.sqrt(r2))
        dual_hist.append(np.sqrt(s2))
    return x, np.array(pri_hist), np.array(dual_hist)


def test_trajectory_matches_closed_form():
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=12, num_nodes=3, angles_total=18),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.0,  # closed-form regime
            rho=2.0,
            max_iters=8,
            eps_pri=1e-12,
            eps_dual=1e-12,
            node=NodeSolverConfig(
                max_inner=4000, check_every=100, eps0=1e-3, gamma_decay=0.0
            ),
        ),
        noise_level=0.005,
        phantom="const",
    )
    problem = loader.build_problem(cfg, mode="dense")
    res = admm.run_admm(problem)

    A = np.asarray(problem.A)
    b = np.asarray(problem.b)
    Q = np.asarray(problem.Q)
    adj = np.asarray(problem.adj).astype(float)
    x_ref, pri_ref, dual_ref = numpy_admm_reference(
        A, b, Q, adj, rho=2.0, iters=8
    )

    pri = np.asarray(res.history["primal"])[:8]
    dual = np.asarray(res.history["dual"])[:8]
    np.testing.assert_allclose(pri, pri_ref, rtol=2e-2)
    # First dual residual can be near zero; compare from iteration 1.
    np.testing.assert_allclose(dual[1:], dual_ref[1:], rtol=5e-2)
    np.testing.assert_allclose(
        np.asarray(res.x), x_ref, rtol=1e-2, atol=1e-2 * np.abs(x_ref).max()
    )


def numpy_admm_weighted(A, b, Q, W, adj, rho, iters):
    """Numpy replica with the eq. 2 W-weighted fusion
    z = (W_i a_i + W_j a_j) / (W_i + W_j)."""
    P, m, n = A.shape
    x = np.zeros((P, n))
    z = np.zeros((P, P, n))
    y = np.zeros((P, P, n))
    AtA = np.einsum("pmn,pmk->pnk", A, A)
    Atb = np.einsum("pmn,pm->pn", A, b)
    pri_hist = []
    for _ in range(iters):
        v = z - y
        for i in range(P):
            D = Q[i].sum(axis=0)
            b_cons = (Q[i] * v[i]).sum(axis=0)
            x[i] = np.linalg.solve(
                AtA[i] + rho * np.diag(D), Atb[i] + rho * b_cons
            )
        a = x[:, None, :] + y
        wi = W[:, None, :]
        wj = W[None, :, :]
        zn = ((wi * a + wj * a.transpose(1, 0, 2)) / (wi + wj)) * adj[
            :, :, None
        ]
        y = (y + x[:, None, :] - zn) * adj[:, :, None]
        pri_hist.append(
            np.sqrt(np.sum(((x[:, None, :] - zn) * adj[:, :, None]) ** 2))
        )
        z = zn
    return x, np.array(pri_hist)


def test_weighted_fusion_trajectory():
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=12, num_nodes=3, angles_total=18),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.0, rho=2.0, max_iters=6, eps_pri=1e-12, eps_dual=1e-12,
            z_fusion="weighted",
            node=NodeSolverConfig(
                max_inner=4000, check_every=100, eps0=1e-3, gamma_decay=0.0,
                plateau_tol=0.0,
            ),
        ),
        noise_level=0.005,
        phantom="const",
    )
    problem = loader.build_problem(cfg, mode="dense")
    res = admm.run_admm(problem)
    x_ref, pri_ref = numpy_admm_weighted(
        np.asarray(problem.A), np.asarray(problem.b), np.asarray(problem.Q),
        np.asarray(problem.W), np.asarray(problem.adj).astype(float),
        rho=2.0, iters=6,
    )
    np.testing.assert_allclose(
        np.asarray(res.history["primal"])[:6], pri_ref, rtol=2e-2
    )
    np.testing.assert_allclose(
        np.asarray(res.x), x_ref, rtol=1e-2, atol=1e-2 * np.abs(x_ref).max()
    )


def numpy_admm_harmonic_weighted_relax(A, b, Q, W, adj, rho, alpha, iters):
    """Numpy replica of the combined reference-ver1 configuration: harmonic
    Q (consumed via the Q argument), eq.-2 W-weighted fusion, and
    over-relaxation x_hat = alpha*x + (1-alpha)*z in the z/y updates."""
    P, m, n = A.shape
    x = np.zeros((P, n))
    z = np.zeros((P, P, n))
    y = np.zeros((P, P, n))
    AtA = np.einsum("pmn,pmk->pnk", A, A)
    Atb = np.einsum("pmn,pm->pn", A, b)
    pri_hist, dual_hist = [], []
    for _ in range(iters):
        v = z - y
        for i in range(P):
            D = Q[i].sum(axis=0)
            b_cons = (Q[i] * v[i]).sum(axis=0)
            x[i] = np.linalg.solve(
                AtA[i] + rho * np.diag(D), Atb[i] + rho * b_cons
            )
        x_hat = alpha * x[:, None, :] + (1.0 - alpha) * z
        a = x_hat + y
        wi = W[:, None, :]
        wj = W[None, :, :]
        zn = ((wi * a + wj * a.transpose(1, 0, 2)) / (wi + wj)) * adj[
            :, :, None
        ]
        y = (a - zn) * adj[:, :, None]
        pri_hist.append(
            np.sqrt(np.sum(((x_hat - zn) * adj[:, :, None]) ** 2))
        )
        dual_hist.append(
            np.sqrt(0.5 * rho**2 * np.sum(((zn - z) * adj[:, :, None]) ** 2))
        )
        z = zn
    return x, np.array(pri_hist), np.array(dual_hist)


def test_harmonic_qmode_weighted_relax_trajectory():
    """q_mode="harmonic" end-to-end (the reference ver1 DEFAULT,
    block_7_main_ver1.py:41-51 / block_3_graph_and_precisions.py:26-41),
    combined with the eq.-2 weighted fusion and over-relaxation: the
    harmonic Q tensor must match the reference formula exactly and the
    trajectory must match the numpy replica at the arithmetic tests'
    tolerances (VERDICT r4 #5)."""
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=12, num_nodes=3, angles_total=18),
        graph=GraphConfig(strategy="knn", k=1, seed=123, q_mode="harmonic"),
        admm=AdmmConfig(
            lam_tv=0.0, rho=2.0, max_iters=6, eps_pri=1e-12, eps_dual=1e-12,
            z_fusion="weighted", relax_alpha=1.5,
            node=NodeSolverConfig(
                max_inner=4000, check_every=100, eps0=1e-3, gamma_decay=0.0,
                plateau_tol=0.0,
            ),
        ),
        noise_level=0.005,
        phantom="const",
    )
    problem = loader.build_problem(cfg, mode="dense")

    # The Q tensor IS the harmonic formula (floored, masked, zero diag):
    # Q = max(W_i W_j/(W_i+W_j), eps) * keep, ref block_3:26-41.
    W = np.asarray(problem.W)
    keep = np.asarray(problem.keep)
    wi, wj = W[:, None, :], W[None, :, :]
    q_ref = np.maximum(wi * wj / (wi + wj), 1e-12)
    q_ref = q_ref * (1.0 - np.eye(W.shape[0]))[:, :, None] * keep
    np.testing.assert_allclose(np.asarray(problem.Q), q_ref, rtol=1e-6)
    # Harmonic differs materially from arithmetic here (not a no-op test).
    q_arith = np.maximum(0.5 * (wi + wj), 1e-12)
    q_arith = q_arith * (1.0 - np.eye(W.shape[0]))[:, :, None] * keep
    assert np.max(np.abs(q_ref - q_arith)) > 1e-3 * np.max(q_arith)

    res = admm.run_admm(problem)
    x_ref, pri_ref, dual_ref = numpy_admm_harmonic_weighted_relax(
        np.asarray(problem.A), np.asarray(problem.b), np.asarray(problem.Q),
        W, np.asarray(problem.adj).astype(float), rho=2.0, alpha=1.5,
        iters=6,
    )
    np.testing.assert_allclose(
        np.asarray(res.history["primal"])[:6], pri_ref, rtol=2e-2
    )
    np.testing.assert_allclose(
        np.asarray(res.history["dual"])[1:6], dual_ref[1:], rtol=5e-2
    )
    np.testing.assert_allclose(
        np.asarray(res.x), x_ref, rtol=1e-2, atol=1e-2 * np.abs(x_ref).max()
    )
