"""Inexact node-subproblem solver: batched Condat-Vu primal-dual iteration.

This replaces the reference's CVXPY+SCS cone solve of the node update
(``/root/reference/block_5_node_problem.py:6-32`` builds the problem,
``block_6_admm_loop_ver2.py:97-176`` drives SCS with adaptive tolerance).
The subproblem at node i and outer iteration k is

    min_x  0.5 ||A_i x - b_i||^2 + lam_tv * TV(x)
           + (rho/2) sum_j ||x - v_ij||^2_{Q_ij}

Split as f(x) + h(Kx):  f = smooth LS + diagonal quadratic (gradient
A^T(Ax-b) + rho*(D x - b_cons) with D = sum_j Q_ij, b_cons = sum_j Q_ij v_ij),
h = lam_tv * ||.||_{2,1}, K = forward-difference gradient. Condat-Vu:

    x+ = x - tau * (grad f(x) + K^T u)
    u+ = Proj_{|.| <= lam_tv} (u + sigma * K (2 x+ - x))

with step sizes satisfying 1/tau - sigma ||K||^2 >= L_f / 2.

All P node problems are solved simultaneously as one batched iteration
([P, m] @ [P, m, n] matvecs on the MXU) inside a ``lax.while_loop`` that
checks, every ``check_every`` steps, the reference's stationarity residual
    g = A^T(Ax - b) + rho*(D x - b_cons) + lam_tv * K^T(Kx/|Kx|)
(``block_6_admm_loop_ver2.py:134-149``) against the adaptive target
eps_k = eps0/(k+1)^(1+gamma) (``:100-103``), stopping when every node is
accepted or the inner budget is exhausted. Warm starts carry (x, u) across
outer iterations — the analogue of SCS ``warm_start=True`` (``:123``).

A deliberate divergence from the reference: nodes that meet the target keep
iterating until all lanes finish (SPMD lanes run anyway; extra iterations
only tighten the subproblem solution, which inexact-ADMM theory permits).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from dip_admm_tpu.config import NodeSolverConfig
from dip_admm_tpu.ops import tv


class NodeState(NamedTuple):
    """Warm-started inner-solver state (per node, batched)."""

    x: jnp.ndarray  # [P, n]
    ux: jnp.ndarray  # [P, N, N] TV dual, x-component
    uy: jnp.ndarray  # [P, N, N] TV dual, y-component
    ua: jnp.ndarray  # [P, m] data-fit dual (ppdhg algorithm; zeros for cv)
    xp: jnp.ndarray  # [P, n] previous iterate (fista momentum; zeros for cv)
    tk: jnp.ndarray  # [P] fista t-sequence / fcv step (inf when fresh)


class FourierPrecond(NamedTuple):
    """Circulant (Fourier-diagonal) metric for the ``fcv`` inner algorithm.

    For parallel-beam CT the node normal operator ``A_i^T A_i`` is
    near shift-invariant (Fourier slice theorem: backprojection of the
    node's angular wedge is approximately a convolution with a ~1/|r|
    kernel restricted to that wedge), so its spectrum is captured by one
    per-node 2-D transfer function — estimated by probing with a centered
    impulse. The metric ``M = F^-1 diag(m_hat) F`` then matches the
    smooth part's curvature far better than any pixel-diagonal
    preconditioner (pcv/ppdhg), which cannot represent CT's spectral
    decay at all. The analogue of the Anderson-accelerated cone solves
    SCS brings to the same subproblem in the reference
    (``block_6_admm_loop_ver2.py:123``).
    """

    m_hat: jnp.ndarray  # [P, N, N//2+1] real positive Fourier symbol of M
    step: jnp.ndarray  # [P] primal step scale s: T = s * M^-1
    sigma: jnp.ndarray  # [P] dual (TV) step


def build_fourier_precond(
    fwd: Callable[[jnp.ndarray], jnp.ndarray],
    adj: Callable[[jnp.ndarray], jnp.ndarray],
    D_vec: jnp.ndarray,  # [P, n] = sum_j Q_ij (constant across outer iters)
    rho: float,
    cfg: NodeSolverConfig,
    N: int,
    n_lanczos: int = 25,
) -> FourierPrecond:
    """One-time setup for ``fcv``: per-node circulant symbol + safe steps.

    The symbol is ``m_hat = max(Re F[PSF], 0) + rho*mean(D) + delta`` with
    ``PSF = A^T A delta_center`` (one operator apply per run). The primal
    step ``s`` is certified by a Lanczos spectral-radius estimate of
    ``M^-1 (H/2 + sigma K^T K)`` in the M inner product
    (H = A^T A + rho diag(D), K = TV gradient): the Condat-Vu metric
    condition ``T^-1 >= grad^2 f / 2 + K^T Sigma K`` holds with
    ``T = s M^-1`` iff ``s <= 1/lambda_max`` — the circulant only has to
    *approximate* H for speed; the spectral bound keeps it convergent even
    where it misfits (image boundary, masked pixels, fan-beam rebin).
    Lanczos (eigh of the [n_lanczos]^2 tridiagonal, in-jit) resolves the
    near-degenerate top cluster that made a power-method estimate creep
    ~13% between 12 and 120 iterations and forced a 0.7 safety margin;
    the margin is now 0.95.
    """
    P, n = D_vec.shape
    dtype = D_vec.dtype
    center = (N // 2) * N + (N // 2)
    e = jnp.zeros((P, n), dtype).at[:, center].set(1.0)
    psf = adj(fwd(e)).reshape(P, N, N)
    # Move the impulse response to the origin. The probe pixel sits half a
    # pixel off the periodic center (even N), leaving a residual linear
    # phase ramp on the FFT — take the MODULUS, not the clamped real part
    # (clamping zeroed the high-frequency half of the spectrum, which the
    # rho*D floor masked until the rho=0 centralized path exposed it).
    psf = jnp.roll(psf, (-(N // 2), -(N // 2)), axis=(1, 2))
    m_hat_A = jnp.abs(jnp.fft.rfft2(psf))
    d_mean = jnp.mean(D_vec, axis=1)  # [P]

    # Dual step on the same local scale as cv's (sigma * ||K||^2 ~ L/2 with
    # L the consensus-quadratic curvature): keeps sigma K^T K from
    # dominating the metric bound while the lam_tv-ball projection
    # saturates the TV dual within a few steps regardless. With no
    # consensus quadratic (rho*D = 0 — the centralized TV solve) fall back
    # to the operator's own mean spectral scale so sigma stays positive.
    Ksq = tv.GRAD_OPNORM_SQ
    scale = rho * d_mean
    # rho=0 fallback measured on the centralized TV path: the TV dual is
    # the convergence bottleneck there, and PSNR-at-budget rises
    # monotonically with sigma through ~4*max(m_hat) (a sigma sweep);
    # sigma also enters the metric below, so larger values stay certified.
    scale = jnp.where(
        scale > 0, scale, 4.0 * jnp.max(m_hat_A, axis=(1, 2))
    )
    sigma = (cfg.sigma_scale * scale / (2.0 * Ksq)).astype(dtype)

    # The metric must also carry sigma * K^T K's circulant symbol (the
    # periodic Laplacian): K's spectrum PEAKS exactly where CT's decays
    # (|w|^2 vs ~1/|w|), so without this term the certified step collapses
    # to ~l_hat_max * m_hat_min^-1 at the Nyquist corner (measured: step
    # 0.016 instead of ~1 on the centralized path).
    kx = jnp.arange(N)[:, None]
    ky = jnp.arange(N // 2 + 1)[None, :]
    l_hat = (
        4.0 * jnp.sin(jnp.pi * kx / N) ** 2
        + 4.0 * jnp.sin(jnp.pi * ky / N) ** 2
    )  # [N, N//2+1]
    m_hat = (
        m_hat_A
        + rho * d_mean[:, None, None]
        + sigma[:, None, None] * l_hat[None]
    )
    m_hat = jnp.maximum(
        m_hat, 1e-6 * jnp.max(m_hat, axis=(1, 2), keepdims=True)
    ).astype(dtype)

    def H(x):  # [P, n] smooth-part Hessian apply
        return adj(fwd(x)) + rho * (D_vec * x)

    def KtK(x):
        gx, gy = tv.grad(x.reshape(P, N, N))
        return tv.grad_adjoint(gx, gy).reshape(P, -1)

    def S(x):  # the operator whose M-spectral radius certifies the step
        return 0.5 * H(x) + sigma[:, None] * KtK(x)

    def Minv(r):
        R = jnp.fft.rfft2(r.reshape(P, N, N))
        return jnp.fft.irfft2(R / m_hat, s=(N, N)).reshape(P, -1)

    def Mv_apply(v):
        return jnp.fft.irfft2(
            m_hat * jnp.fft.rfft2(v.reshape(P, N, N)), s=(N, N)
        ).reshape(P, -1)

    # Lanczos on G = M^-1 S in the M inner product (G is self-adjoint
    # there since S and M are symmetric): three-term recurrence with
    #   alpha_j = <G v_j, v_j>_M = v_j^T S v_j,
    #   beta_j  = ||w||_M,  w = G v_j - alpha_j v_j - beta_{j-1} v_{j-1},
    # then lambda_max(G) ~ the top Ritz value of the [k, k] tridiagonal
    # (eigh in-jit; batched over nodes). Krylov top-eigenvalue convergence
    # is quadratically faster than power iteration and handles clustered
    # tops, where a power estimate stalls. Ritz values
    # UNDERestimate lambda_max in exact arithmetic, so the margin below
    # stays < 1. Deterministic shared start vector — a [P, n] draw would
    # make the certified step depend on how the node batch is sliced
    # across shards (mesh parity).
    v0 = jnp.broadcast_to(
        jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32), (P, n)
    )
    b0 = jnp.sqrt(jnp.maximum(jnp.sum(v0 * Mv_apply(v0), axis=1), 1e-30))
    v = v0 / b0[:, None]
    k = n_lanczos

    def lanczos_step(carry, _):
        v, v_prev, beta_prev = carry
        Sv = S(v)
        alpha = jnp.sum(v * Sv, axis=1)  # <G v, v>_M
        w = Minv(Sv) - alpha[:, None] * v - beta_prev[:, None] * v_prev
        beta = jnp.sqrt(jnp.maximum(jnp.sum(w * Mv_apply(w), axis=1), 0.0))
        # Breakdown (beta ~ 0): the Krylov space is invariant — freeze the
        # recurrence (v_next = 0 keeps subsequent alphas 0; the converged
        # Ritz block is already in the tridiagonal).
        safe = jnp.maximum(beta, 1e-30)
        v_next = jnp.where(
            (beta > 1e-12 * jnp.maximum(jnp.abs(alpha), 1.0))[:, None],
            w / safe[:, None], 0.0,
        )
        return (v_next, v, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        lanczos_step, (v, jnp.zeros_like(v), jnp.zeros((P,), jnp.float32)),
        None, length=k,
    )  # alphas, betas: [k, P]
    # Build the symmetric tridiagonal explicitly (diag + super/sub).
    i = jnp.arange(k)
    diag_mask = (i[:, None] == i[None, :]).astype(jnp.float32)
    sup_mask = (i[:, None] + 1 == i[None, :]).astype(jnp.float32)
    beta_pad = betas.T  # [P, k]; beta_j couples v_j and v_{j+1}
    Tmat = (
        alphas.T[:, :, None] * diag_mask[None]
        + beta_pad[:, :, None] * sup_mask[None]
        + beta_pad[:, None, :] * sup_mask.T[None]
    )
    lam_max = jnp.linalg.eigvalsh(Tmat)[:, -1]
    # 0.95: Ritz values lower-bound the true spectral radius; 25 Lanczos
    # steps resolve the top of this operator's near-degenerate cluster to
    # well under 5% (certification test / bench_lanczos_cert.py), and the
    # in-solve divergence monitor (halve + rollback on residual growth,
    # solve_nodes fcv branch) guards the remaining tail.
    step = (0.95 / jnp.maximum(lam_max, 1e-30)).astype(dtype)
    return FourierPrecond(m_hat=m_hat, step=step, sigma=sigma)


class NodeSolveResult(NamedTuple):
    state: NodeState
    g_norm: jnp.ndarray  # [P] final stationarity residual norms
    objective: jnp.ndarray  # [P] node objective values
    # [P] per-node iterations to FIRST acceptance (||g|| <= eps at a check,
    # check_every granularity — the analogue of the reference's per-node SCS
    # iteration counts, block_6_admm_loop_ver2.py:130-132). Nodes that never
    # met the target record the full trip count (the batched solve runs all
    # lanes to the slowest node).
    inner_iters: jnp.ndarray
    trip_count: jnp.ndarray  # scalar: iterations the batched solve executed
    # [P] acceptance code — the auditable analogue of the reference ver2's
    # per-node accept/tighten(/5)/retry accounting
    # (block_6_admm_loop_ver2.py:155-176): 0 = accepted at the eps_k
    # target, 1 = exited on the plateau heuristic before the budget
    # (the residual floor SCS also stops at), 2 = ran the full inner
    # budget without meeting the target (the reference's "accepted at
    # relaxed tolerance after retries" terminal case).
    accept_code: jnp.ndarray = None


def init_state(P: int, N: int, m: int, dtype=jnp.float32) -> NodeState:
    return NodeState(
        x=jnp.zeros((P, N * N), dtype),
        ux=jnp.zeros((P, N, N), dtype),
        uy=jnp.zeros((P, N, N), dtype),
        ua=jnp.zeros((P, m), dtype),
        xp=jnp.zeros((P, N * N), dtype),
        # inf = "fresh" sentinel: fcv takes min(tk, certified step), so a
        # fresh state maps to the FULL certified step (which can exceed 1 —
        # lam_max ~ 0.5-0.7 gives step ~ 1-1.4; a ones sentinel used to clip
        # it). fista overwrites tk with ones at solve start.
        tk=jnp.full((P,), jnp.inf, dtype),
    )


def solve_nodes(
    fwd: Callable[[jnp.ndarray], jnp.ndarray],
    adj: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,  # [P, m]
    D_vec: jnp.ndarray,  # [P, n] = sum_j Q_ij (masked)
    b_cons: jnp.ndarray,  # [P, n] = sum_j Q_ij v_ij
    c_quad: jnp.ndarray,  # [P] = sum_{j,p} Q_ij v_ij^2 (objective constant)
    lam_tv: float,
    rho: float,
    L: jnp.ndarray,  # [P] Lipschitz bounds ||A^T A|| + rho*max(D)
    state: NodeState,
    eps_k: jnp.ndarray,  # scalar adaptive stationarity target
    cfg: NodeSolverConfig,
    N: int,
    any_reduce=None,  # cross-shard OR for the continue flag (mesh pmax);
    # None = this shard's nodes only. Passing the mesh reduction makes every
    # shard run the same inner trip count — exact parity with the
    # single-device batched solve, at one scalar collective per check.
    fprecond: FourierPrecond | None = None,  # required for algorithm="fcv"
) -> NodeSolveResult:
    P = b.shape[0]
    dtype = state.x.dtype
    post_check = None  # optional per-algorithm hook run at every check
    # lam_tv may be a scalar or a per-node [P] vector (GraphProblem nodes
    # with different TV weights); normalize to broadcastable views.
    lam_vec = jnp.broadcast_to(jnp.asarray(lam_tv, dtype), (P,))
    lam_col = lam_vec[:, None]
    lam_im = lam_vec[:, None, None]

    def grad_f(x):  # [P, n] -> [P, n]
        return adj(fwd(x) - b) + rho * (D_vec * x - b_cons)

    def g_residual(x):
        """Reference acceptance residual (``block_6 ver2:134-149``)."""
        sub = tv.tv_subgradient(x.reshape(P, N, N)).reshape(P, -1)
        return grad_f(x) + lam_col * sub

    if cfg.algorithm == "cv":
        # Balanced steps: sigma*||K||^2 = L/2 => tau = 0.99/L, per node.
        Ksq = tv.GRAD_OPNORM_SQ
        sigma = (cfg.sigma_scale * L / (2.0 * Ksq)).astype(dtype)  # [P]
        tau = (0.99 / (L / 2.0 + sigma * Ksq)).astype(dtype)  # [P]
        tau_c = tau[:, None]
        sig_im = sigma[:, None, None]

        def inner_step(_, st: NodeState) -> NodeState:
            x, ux, uy = st.x, st.ux, st.uy
            ktu = tv.grad_adjoint(ux, uy).reshape(P, -1)
            x_new = x - tau_c * (grad_f(x) + ktu)
            xb = (2.0 * x_new - x).reshape(P, N, N)
            gx, gy = tv.grad(xb)
            ux, uy = tv.project_l2_ball(
                ux + sig_im * gx, uy + sig_im * gy, lam_im
            )
            return st._replace(x=x_new, ux=ux, uy=uy)

    elif cfg.algorithm == "fcv":
        # Circulant-metric Condat-Vu: the gradient step runs in the Fourier
        # metric T = s * M^-1 built by ``build_fourier_precond`` (the
        # near-shift-invariance of A^T A for CT nodes).
        # Identical fixed-point and acceptance semantics to cv; only the
        # metric (and therefore the iteration count) changes.
        if fprecond is None:
            raise ValueError("algorithm='fcv' requires fprecond "
                             "(build_fourier_precond)")
        m_hat = fprecond.m_hat
        sig_im = fprecond.sigma[:, None, None]
        # The per-node step lives in the (otherwise unused) ``tk`` state
        # slot so the divergence monitor below can adapt it and warm starts
        # carry the adapted value across outer iterations; ``xp`` holds the
        # last-check snapshot of x for rollback. min() maps a fresh state
        # (tk = inf sentinel) to the full certified step — which may exceed
        # 1 — and keeps a warm-started adapted value.
        state = state._replace(
            tk=jnp.minimum(state.tk, fprecond.step), xp=state.x
        )

        def Minv(r):
            R = jnp.fft.rfft2(r.reshape(P, N, N))
            return jnp.fft.irfft2(R / m_hat, s=(N, N)).reshape(P, -1)

        def inner_step(_, st: NodeState) -> NodeState:
            x, ux, uy = st.x, st.ux, st.uy
            ktu = tv.grad_adjoint(ux, uy).reshape(P, -1)
            x_new = x - st.tk[:, None] * Minv(grad_f(x) + ktu)
            xb = (2.0 * x_new - x).reshape(P, N, N)
            gx, gy = tv.grad(xb)
            ux, uy = tv.project_l2_ball(
                ux + sig_im * gx, uy + sig_im * gy, lam_im
            )
            return st._replace(x=x_new, ux=ux, uy=uy)

        def post_check(st, g_norm, g_prev, g_min):
            # Divergence monitor: the power-method certificate can
            # under-resolve the spectral radius (slow convergence on the
            # near-degenerate top cluster), so a node whose stationarity
            # residual blew up past 5x its running minimum (primal-dual
            # iterations are NOT ||g||-monotone — ordinary oscillation must
            # not trigger) halves its step and rolls x back to the
            # last-check snapshot (the TV duals are lam-ball projections —
            # bounded — so only x needs rollback). The reported residual
            # for a rolled-back node is its previous one.
            bad = ~jnp.isfinite(g_norm) | (g_norm > 5.0 * g_min)
            bad_c = bad[:, None]
            st = st._replace(
                tk=jnp.where(bad, st.tk * 0.5, st.tk),
                x=jnp.where(bad_c, st.xp, st.x),
                xp=jnp.where(bad_c, st.xp, st.x),
            )
            return st, jnp.where(bad, g_prev, g_norm), jnp.any(bad)

    elif cfg.algorithm == "pcv":
        # Per-pixel preconditioned Condat-Vu: the smooth part's curvature is
        # majorized coordinate-wise by the Gershgorin row sums of
        # A^T A + rho*diag(D), computable matrix-free for nonnegative
        # operators as A^T(A 1) (a SART-type Jacobi preconditioner). The
        # step condition T_p (L_p/2 + sigma_p * ||K||^2) <= 1 holds per
        # pixel with sigma chosen from the same local scale.
        n = D_vec.shape[1]
        L_row = adj(fwd(jnp.ones((P, n), dtype))) + rho * D_vec  # [P, n]
        L_row = jnp.maximum(L_row, 1e-6)
        Ksq = tv.GRAD_OPNORM_SQ
        sigma_p = (cfg.sigma_scale * L_row / (2.0 * Ksq)).astype(dtype)
        T = (0.99 / (L_row / 2.0 + sigma_p * Ksq)).astype(dtype)  # [P, n]
        sig_im = sigma_p.reshape(P, N, N)

        def inner_step(_, st: NodeState) -> NodeState:
            x, ux, uy = st.x, st.ux, st.uy
            ktu = tv.grad_adjoint(ux, uy).reshape(P, -1)
            x_new = x - T * (grad_f(x) + ktu)
            xb = (2.0 * x_new - x).reshape(P, N, N)
            gx, gy = tv.grad(xb)
            ux, uy = tv.project_l2_ball(
                ux + sig_im * gx, uy + sig_im * gy, lam_im
            )
            return st._replace(x=x_new, ux=ux, uy=uy)

    elif cfg.algorithm == "ppdhg":
        # Diagonally preconditioned PDHG (Pock-Chambolle 2011, alpha=1):
        # K = [A; grad] entirely in the dual, the consensus quadratic as an
        # exact elementwise primal prox. Steps tau_j = 1/sum_i|K_ij|,
        # sigma_i = 1/sum_j|K_ij| — computable matrix-free because every
        # projector weight is nonnegative (|A| sums = A applied to ones);
        # convergence is guaranteed with no operator-norm estimation. The
        # standard recipe for CT (Sidky et al.).
        n = D_vec.shape[1]
        rowsum = fwd(jnp.ones((P, n), dtype))  # [P, m] = sum_j |A_ij|
        colsum = adj(jnp.ones_like(b))  # [P, n] = sum_i |A_ij|
        sig_a = 1.0 / jnp.maximum(rowsum, 1e-6)
        # TV rows have two unit entries (sigma = 1/2); TV column sums <= 4.
        T = (1.0 / (jnp.maximum(colsum, 0.0) + 4.0)).astype(dtype)  # [P, n]
        rden = 1.0 + T * rho * D_vec
        rnum = T * rho * b_cons

        def inner_step(_, st: NodeState) -> NodeState:
            x, ux, uy, ua = st.x, st.ux, st.uy, st.ua
            kty = adj(ua) + tv.grad_adjoint(ux, uy).reshape(P, -1)
            x_new = (x - T * kty + rnum) / rden  # quadratic prox, exact
            xb = 2.0 * x_new - x
            v = ua + sig_a * fwd(xb)
            ua = (v - sig_a * b) / (1.0 + sig_a)  # prox of 0.5||.-b||^2 dual
            gx, gy = tv.grad(xb.reshape(P, N, N))
            ux, uy = tv.project_l2_ball(ux + 0.5 * gx, uy + 0.5 * gy, lam_im)
            return st._replace(x=x_new, ux=ux, uy=uy, ua=ua)

    elif cfg.algorithm == "fista":
        # Momentum is meaningful only within ONE subproblem: across outer
        # iterations b_cons/D_vec change, so a carried-over (xp, tk) pair
        # extrapolates against the *previous* objective and the first step
        # overshoots before the gradient restart can fire. Keep x and the TV
        # dual as the warm start; reset the t-sequence.
        state = state._replace(xp=state.x, tk=jnp.ones_like(state.tk))
        # Accelerated proximal gradient (FISTA, Beck-Teboulle 2009) on
        # f(x) + lam*TV(x): gradient step on the smooth LS+quadratic part at
        # the momentum point, then prox_{tau*lam*TV} by Chambolle projected
        # dual ascent. The node's TV dual field (ux, uy) doubles as the prox
        # warm start across steps (the prox radius tau*lam is constant within
        # a solve), so ``fista_prox_iters`` dual iterations per step suffice.
        # O'Donoghue-Candes gradient restart per node keeps momentum from
        # overshooting: when (y - x+)'(x+ - x) > 0 the t-sequence resets.
        # Promoted from the test-only oracle (tests/test_node_solver.py);
        # the same accelerated scheme SCS's quadratic cone solves
        # play against in the reference (block_6_admm_loop_ver2.py:123).
        tau = (0.99 / L).astype(dtype)  # [P]
        tau_c = tau[:, None]
        w_im = (tau * lam_vec).astype(dtype)[:, None, None]

        def inner_step(_, st: NodeState) -> NodeState:
            x, ux, uy, xp, tk = st.x, st.ux, st.uy, st.xp, st.tk
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk * tk))
            beta = ((tk - 1.0) / t_new)[:, None]
            y = x + beta * (x - xp)
            w = y - tau_c * grad_f(y)
            x_im, (ux, uy) = tv.tv_prox_chambolle(
                w.reshape(P, N, N),
                w_im,
                n_iters=cfg.fista_prox_iters,
                p_init=(ux, uy),
            )
            x_new = x_im.reshape(P, -1)
            restart = (
                jnp.sum((y - x_new) * (x_new - x), axis=1) > 0.0
            )
            t_new = jnp.where(restart, jnp.ones_like(t_new), t_new)
            return st._replace(x=x_new, ux=ux, uy=uy, xp=x, tk=t_new)

    else:
        raise ValueError(f"unknown inner algorithm {cfg.algorithm!r}")

    if any_reduce is None:
        any_reduce = lambda v: v

    def cond(carry):
        st, k, g_norm, g_min, active, acc = carry
        return (k < cfg.max_inner) & active

    def body(carry):
        st, k, g_prev, g_min, _, acc = carry
        st = jax.lax.fori_loop(0, cfg.check_every, inner_step, st)
        g_norm = jnp.linalg.norm(g_residual(st.x), axis=1)
        adjusted = jnp.asarray(False)
        if post_check is not None:
            st, g_norm, adjusted = post_check(st, g_norm, g_prev, g_min)
        g_min = jnp.minimum(g_min, jnp.where(jnp.isfinite(g_norm), g_norm,
                                             jnp.inf))
        # Per-node first-acceptance iteration (check_every granularity):
        # lanes keep running to the slowest node, but WHEN each node met its
        # target is observable here and recorded for the history.
        acc = jnp.where(
            (acc < 0) & (g_norm <= eps_k), k + cfg.check_every, acc
        )
        # eps_k may be a scalar or per-node [P] (the data-scale-relative
        # schedule folds in at the caller, core.admm.admm_iteration).
        unmet = jnp.any(g_norm > eps_k)
        if cfg.plateau_tol > 0:
            # The normalized-subgradient residual has an irreducible floor at
            # TV optima with flat regions; once no node improves by more than
            # plateau_tol between checks, further iterations are wasted
            # (mirrors SCS stopping at its own tolerance).
            improving = jnp.any(
                jnp.where(
                    jnp.isinf(g_prev),  # first check: no baseline yet
                    True,
                    (g_prev - g_norm) > cfg.plateau_tol * jnp.abs(g_prev),
                )
            )
            # A step adjustment (fcv divergence monitor) is progress even
            # though the rolled-back residual shows none — don't let the
            # plateau exit fire on the adjustment check itself.
            unmet = unmet & (improving | adjusted)
        active = any_reduce(unmet)
        return st, k + cfg.check_every, g_norm, g_min, active, acc

    g0 = jnp.full((P,), jnp.inf, dtype)
    acc0 = jnp.full((P,), -1, jnp.int32)
    st, k_used, g_norm, _, _, acc = jax.lax.while_loop(
        cond, body, (state, jnp.int32(0), g0, g0, jnp.asarray(True), acc0)
    )
    # If the loop never ran (already accepted), g0 is stale — recompute.
    g_norm = jnp.where(
        jnp.isinf(g_norm), jnp.linalg.norm(g_residual(st.x), axis=1), g_norm
    )
    # Nodes that never met the target spent the full trip count.
    inner_per_node = jnp.where(acc >= 0, acc, k_used)

    r = fwd(st.x) - b
    data_term = 0.5 * jnp.sum(r * r, axis=1)
    tv_term = lam_vec * tv.tv_value(st.x.reshape(P, N, N))
    quad = 0.5 * rho * (
        jnp.sum(D_vec * st.x**2, axis=1)
        - 2.0 * jnp.sum(b_cons * st.x, axis=1)
        + c_quad
    )
    objective = data_term + tv_term + quad
    accept_code = jnp.where(
        acc >= 0, 0, jnp.where(k_used < cfg.max_inner, 1, 2)
    ).astype(jnp.int32)
    return NodeSolveResult(
        st, g_norm, objective, inner_per_node, k_used, accept_code
    )
