"""Batched linear-algebra primitives for the node solvers.

The reference delegates all heavy numerics to SCS's C core via CVXPY
(``/root/reference/block_6_admm_loop_ver2.py:123``); here the equivalents are
jittable fixed-shape iterations that vmap over the node axis and run on the
MXU: conjugate gradients for SPD normal-equation solves, a power method for
operator-norm/step-size estimation, and a direct Cholesky path for
small/Gram-mode problems.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp


def cg(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    max_iters: int = 50,
    tol: float = 1e-8,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Conjugate gradients for SPD ``matvec``.

    Runs a fixed maximum of ``max_iters`` with an early-exit predicate on
    ||r||^2 <= tol^2 * ||b||^2 inside a ``lax.while_loop`` (static shapes,
    data-dependent trip count — the jit-native analogue of an iterative
    solver with a tolerance). Returns (x, final ||r||^2, iterations used).
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = jnp.vdot(r, r).real
    b2 = jnp.vdot(b, b).real
    thresh = (tol**2) * jnp.maximum(b2, 1e-30)

    def cond(state):
        _, _, _, rs, k = state
        return (k < max_iters) & (rs > thresh)

    def body(state):
        x, r, p, rs, k = state
        ap = matvec(p)
        denom = jnp.vdot(p, ap).real
        alpha = rs / jnp.where(denom > 0, denom, 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r).real
        beta = rs_new / jnp.where(rs > 0, rs, 1e-30)
        p = r + beta * p
        return x, r, p, rs_new, k + 1

    x, r, p, rs, k = jax.lax.while_loop(cond, body, (x, r, p, rs, jnp.int32(0)))
    return x, rs, k


def power_method(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    shape: tuple[int, ...],
    iters: int = 30,
    seed: int = 0,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Largest eigenvalue of a symmetric PSD operator (e.g. A^T A).

    Mirrors the role of ``odl.power_method_opnorm`` in the legacy PDHG solver
    (``/root/reference/ADMM_Tomo_Only.py:130``), as a fori_loop.
    """
    v = jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, carry):
        v, _ = carry
        w = matvec(v)
        lam = jnp.linalg.norm(w)
        return w / jnp.maximum(lam, 1e-30), lam

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(0.0, dtype)))
    return lam


def solve_spd(mat: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Direct SPD solve via Cholesky (Gram-mode x-step for small n)."""
    chol = jnp.linalg.cholesky(mat)
    return jax.scipy.linalg.cho_solve((chol, True), rhs)


def ridge_solve(A: jnp.ndarray, b: jnp.ndarray, lam: float) -> jnp.ndarray:
    """x = (A^T A + lam I)^{-1} A^T b — the reference's aggregate ridge
    baseline (``/root/reference/block_2_test.py:83-88``)."""
    n = A.shape[1]
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    gram = mm(A.T, A) + lam * jnp.eye(n, dtype=A.dtype)
    return solve_spd(gram, mm(A.T, b))
