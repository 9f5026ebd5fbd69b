"""Per-pixel precision weights W_i and pairwise Q_ij.

TPU-native rebuild of ``/root/reference/block_3_graph_and_precisions.py:11-43``
(``make_precisions``): the reference returns a list of per-node weight vectors
plus a closure ``Qij_diag(i, j)``; here everything is materialized as dense
arrays — ``W [P, n]`` and ``Q [P, P, n]`` — which is what the vectorized
topology builders and the sharded consensus loop consume (SURVEY §3.2 calls
for replacing the closure protocol with a materialized tensor).

  W[i, p]    = ||A_i[:, p]||_2^2          (floored at eps)
  harmonic   : Q[i,j,p] = W_i W_j / (W_i + W_j)
  arithmetic : Q[i,j,p] = (W_i + W_j) / 2
with Q floored at eps and the diagonal Q[i,i,:] = 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

EPS = 1e-12


def weights_from_dense(A: jnp.ndarray, row_valid: jnp.ndarray | None = None):
    """W[i, p] from padded dense operators A [P, m_max, n].

    ``row_valid`` masks padded measurement rows (ragged angle counts,
    ref ``block_2_load_odl_data.py:36-38``).
    """
    if row_valid is not None:
        A = A * row_valid[..., None]
    W = jnp.sum(A * A, axis=1)
    return jnp.maximum(W, EPS)


@functools.partial(jax.jit, static_argnames="q_mode")
def pairwise_q(W: jnp.ndarray, q_mode: str = "arithmetic") -> jnp.ndarray:
    """Q [P, P, n] from W [P, n]; diagonal zeroed.

    jit: one fused program instead of ~6 eager elementwise dispatches over the
    [P, P, n] tensor."""
    Wi = W[:, None, :]
    Wj = W[None, :, :]
    if q_mode == "harmonic":
        q = (Wi * Wj) / (Wi + Wj)
    elif q_mode == "arithmetic":
        q = 0.5 * (Wi + Wj)
    else:
        raise ValueError("q_mode must be 'harmonic' or 'arithmetic'")
    q = jnp.maximum(q, EPS)
    P = W.shape[0]
    off_diag = ~jnp.eye(P, dtype=bool)
    return q * off_diag[:, :, None]


def symmetrize(q: jnp.ndarray) -> jnp.ndarray:
    """Average both directions (the reference forces exact symmetry per pixel
    before building masks, ``block_3_graph_and_precisions.py:169-172``)."""
    return 0.5 * (q + jnp.swapaxes(q, 0, 1))
