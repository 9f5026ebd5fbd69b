"""JAX-native ray transforms (Radon projectors).

Replaces the reference's ODL ``RayTransform`` + dense basis-probing
densification (``/root/reference/block_2_load_odl_data.py:16-96``,
``Gen_Sino_Partitioned.py:124-147``) with a differentiable Joseph projector:
for each ray, integrate along the dominant axis sampling one 2-tap linear
interpolation per crossed row/column. The operator is exactly linear, its
adjoint is obtained by ``jax.linear_transpose`` (machine-precision adjoint —
required so normal-equation CG stays SPD), and a dense matrix can be
materialized by projecting basis images (same contract as the reference's
densifier, but batched on the MXU).

Geometry semantics mirror the reference builder
(``block_2_load_odl_data.py:16-65``): image on [-1,1]^2 with N x N pixels,
detector of ``n_det`` cells spanning ``det_width`` (default 2.0), angles at
uniform-partition *cell centers* of [0, pi). Each node receives
``angles_total // P (+1)`` angles spread over the full angular range — i.e.
every node sees a coarse full-span view, the reference's "Incmp_Span" setup.

Everything is static-shape: per-node angle sets are padded to ``m_max`` with
a validity mask so node projections vmap into one batched kernel.

Axis convention: image array ``img[a, b]`` has axis 0 = x0, axis 1 = x1,
pixel centers c(i) = -1 + (i + 0.5) * h with h = 2/N. A parallel-beam ray for
(theta, d) is the line {x : x . (cos t, sin t) = d}.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dip_admm_tpu.config import GeometryConfig


# ---------------------------------------------------------------------------
# Ray construction
# ---------------------------------------------------------------------------


def node_angles(cfg: GeometryConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-node angle arrays padded to m_max.

    Returns (angles [P, m_max], valid [P, m_max] bool, m_per_node [P]).
    Node k gets the uniform-partition centers of [0, pi) with its own count
    m_k (ref ``block_2_load_odl_data.py:49-55``: each node spans the full
    range at its own angular resolution).
    """
    counts = cfg.angles_per_node()
    m_max = max(counts)
    P = cfg.num_nodes
    # Fan beam orbits the full circle; parallel beam spans [0, pi).
    span = 2.0 * np.pi if cfg.fan_beam else np.pi
    angles = np.zeros((P, m_max), dtype=np.float64)
    valid = np.zeros((P, m_max), dtype=bool)
    for kk, m_k in enumerate(counts):
        angles[kk, :m_k] = (np.arange(m_k) + 0.5) * span / m_k
        valid[kk, :m_k] = True
    return angles, valid, np.asarray(counts)


def aggregate_angles(cfg: GeometryConfig) -> np.ndarray:
    m = cfg.total_angles
    return (np.arange(m) + 0.5) * np.pi / m


def detector_centers(n_det: int, det_width: float) -> np.ndarray:
    return -det_width / 2.0 + (np.arange(n_det) + 0.5) * (det_width / n_det)


def parallel_rays(
    angles: jnp.ndarray, dets: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Ray (point, unit-direction) parameterization for parallel beam.

    angles [...A], dets [D] -> p0,p1,u0,u1 each [...A, D].
    Ray: x(t) = p + t*u with p = d*(cos,sin) and u = (-sin, cos).
    """
    cos = jnp.cos(angles)[..., None]
    sin = jnp.sin(angles)[..., None]
    d = dets[None, :]
    p0 = d * cos + 0.0 * sin
    p1 = d * sin + 0.0 * cos
    u0 = jnp.broadcast_to(-sin, p0.shape)
    u1 = jnp.broadcast_to(cos, p0.shape)
    return p0, p1, u0, u1


def fan_rays(
    angles: jnp.ndarray, dets: jnp.ndarray, src_radius: float, det_radius: float
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Flat-detector fan-beam rays (config 5 geometry: 512^2, 32 nodes).

    Source at -src_radius along the angle axis, flat detector at +det_radius
    orthogonal to it; ``dets`` are positions along the detector line.
    """
    cos = jnp.cos(angles)[..., None]
    sin = jnp.sin(angles)[..., None]
    # Axis unit vector for angle t is (cos, sin); detector line direction is
    # (-sin, cos).
    s0 = -src_radius * cos
    s1 = -src_radius * sin
    d = dets[None, :]
    q0 = det_radius * cos - d * sin
    q1 = det_radius * sin + d * cos
    v0 = q0 - s0
    v1 = q1 - s1
    norm = jnp.sqrt(v0**2 + v1**2)
    u0 = v0 / norm
    u1 = v1 / norm
    p0 = jnp.broadcast_to(s0, u0.shape)
    p1 = jnp.broadcast_to(s1, u0.shape)
    return p0, p1, u0, u1


# ---------------------------------------------------------------------------
# Joseph projection core
# ---------------------------------------------------------------------------


def _integrate_axis0(img, p0, p1, u0, u1, N: int, squared: bool):
    """Line integrals parametrized along axis 0 (valid when |u0| >= |u1|).

    img [N, N]; ray arrays of any common leading shape R -> out [R].
    At each grid plane x0 = c(a) the ray crosses x1 = p1 + (c(a)-p0)*u1/u0;
    a 2-tap linear interpolation along axis 1 samples the image there and the
    crossing contributes with length weight h/|u0|.
    """
    h = 2.0 / N
    ca = -1.0 + (jnp.arange(N, dtype=img.dtype) + 0.5) * h  # [N]
    safe_u0 = jnp.where(jnp.abs(u0) < 1e-12, 1e-12, u0)
    slope = u1 / safe_u0  # [R]
    x1 = p1[..., None] + (ca - p0[..., None]) * slope[..., None]  # [R, N]
    fb = (x1 + 1.0) / h - 0.5
    fb = jnp.clip(fb, -2.0, N + 1.0)  # keep int cast well-defined
    b0 = jnp.floor(fb)
    w = fb - b0
    b0 = b0.astype(jnp.int32)
    b1 = b0 + 1
    in0 = (b0 >= 0) & (b0 < N)
    in1 = (b1 >= 0) & (b1 < N)
    b0c = jnp.clip(b0, 0, N - 1)
    b1c = jnp.clip(b1, 0, N - 1)
    a_idx = jnp.arange(N)  # broadcast against [R, N] index arrays
    g0 = img[a_idx, b0c]
    g1 = img[a_idx, b1c]
    w0 = jnp.where(in0, 1.0 - w, 0.0)
    w1 = jnp.where(in1, w, 0.0)
    scale = h / jnp.abs(safe_u0)
    if squared:
        vals = w0**2 * g0 + w1**2 * g1
        scale = scale**2
    else:
        vals = w0 * g0 + w1 * g1
    return scale * jnp.sum(vals, axis=-1)


def joseph_project(
    img: jnp.ndarray,
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    u0: jnp.ndarray,
    u1: jnp.ndarray,
    valid: jnp.ndarray | None = None,
    squared: bool = False,
) -> jnp.ndarray:
    """Joseph line integrals of ``img`` over arbitrary rays.

    Each ray picks the parametrization along its dominant direction component
    so every crossed row/column contributes exactly one 2-tap sample.
    ``squared=True`` applies the *elementwise-squared* system weights — the
    matrix-free route to column norms W_i[p] = ||A_i[:, p]||^2 (each pixel
    appears at most once per ray, so squared weights sum exactly; see
    ``colnorms_sq``).
    """
    N = img.shape[-1]
    out_r = _integrate_axis0(img, p0, p1, u0, u1, N, squared)
    out_c = _integrate_axis0(img.T, p1, p0, u1, u0, N, squared)
    use_r = jnp.abs(u0) >= jnp.abs(u1)
    out = jnp.where(use_r, out_r, out_c)
    if valid is not None:
        out = jnp.where(valid, out, 0.0)
    return out


# ---------------------------------------------------------------------------
# Public projector API
# ---------------------------------------------------------------------------


def make_rays(cfg: GeometryConfig, angles: jnp.ndarray):
    """Build ray arrays for an angle set [..., A] -> each [..., A, D]."""
    dets = jnp.asarray(detector_centers(cfg.n_det, cfg.det_width_factor * 2.0))
    if cfg.fan_beam:
        return fan_rays(angles, dets, cfg.src_radius, cfg.det_radius)
    return parallel_rays(angles, dets)


def project(
    cfg: GeometryConfig, img: jnp.ndarray, angles: jnp.ndarray,
    valid: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Forward projection: img [N,N] x angles [A] -> sinogram [A, D]."""
    p0, p1, u0, u1 = make_rays(cfg, angles)
    v = None if valid is None else valid[..., None]
    return joseph_project(img, p0, p1, u0, u1, valid=v)


def backproject(
    cfg: GeometryConfig, sino: jnp.ndarray, angles: jnp.ndarray,
    valid: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Exact adjoint of ``project`` (via linear transposition)."""
    N = cfg.N
    f = lambda x: project(cfg, x, angles, valid)
    (out,) = jax.linear_transpose(f, jnp.zeros((N, N), sino.dtype))(sino)
    return out


def colnorms_sq(
    cfg: GeometryConfig, angles: jnp.ndarray, valid: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Matrix-free column norms W[p] = ||A[:, p]||_2^2 as an [N, N] image.

    Equals the adjoint of the squared-weights projector applied to ones
    (dense-parity tested against ``sum(A*A, axis=0)``, the reference's
    precision weights at ``block_3_graph_and_precisions.py:21-24``).
    """
    N = cfg.N
    p0, p1, u0, u1 = make_rays(cfg, angles)
    v = None if valid is None else valid[..., None]

    def fsq(x):
        return joseph_project(x, p0, p1, u0, u1, valid=v, squared=True)

    ones = jnp.ones(p0.shape, dtype=jnp.result_type(float))
    (out,) = jax.linear_transpose(fsq, jnp.zeros((N, N), ones.dtype))(ones)
    return out


def dense_matrix(
    cfg: GeometryConfig,
    angles: jnp.ndarray,
    valid: jnp.ndarray | None = None,
    chunk: int = 32,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Materialize the dense operator A [A*D, N*N].

    Row r = flat (angle, det) index, column p = flat (row-major) pixel index —
    the same layout the reference gets from ODL's matrix_representation /
    basis probing (``block_2_load_odl_data.py:68-96``). Instead of probing
    basis vectors, the 2-tap Joseph weights are evaluated *directly* by
    broadcast hat arithmetic (gather-free, chunked over angles) — exactly
    equal to :func:`project` (tested), and fast on TPU where XLA's gather
    lowering is slow.
    """
    T = angles.shape[0]
    # Pad the angle set so every chunk hits the same compiled shape (one
    # compilation total, cached across chunks, nodes, and problems).
    T_pad = -(-T // chunk) * chunk
    angles_p = jnp.zeros((T_pad,), dtype).at[:T].set(angles.astype(dtype))
    valid_p = jnp.zeros((T_pad,), bool)
    valid_p = valid_p.at[:T].set(
        jnp.ones((T,), bool) if valid is None else valid
    )
    blocks = [
        _dense_block(cfg, angles_p[s : s + chunk], valid_p[s : s + chunk])
        for s in range(0, T_pad, chunk)
    ]
    return jnp.concatenate(blocks, axis=0)[: T * cfg.n_det]


@functools.partial(jax.jit, static_argnums=0)
def _dense_block(cfg: GeometryConfig, ang_blk, val_blk):
    """Direct 2-tap Joseph weights for one angle chunk -> [tc*D, n]."""
    N, D = cfg.N, cfg.n_det
    dtype = ang_blk.dtype
    h = 2.0 / N
    c = -1.0 + (jnp.arange(N, dtype=dtype) + 0.5) * h  # pixel centers
    i_idx = jnp.arange(N, dtype=dtype)
    p0, p1, u0, u1 = make_rays(cfg, ang_blk)  # each [tc, D]
    tc = ang_blk.shape[0]

    def branch(p0, p1, u0, u1, transpose):
        safe = jnp.where(jnp.abs(u0) < 1e-12, 1e-12, u0)
        slope = u1 / safe
        # x1 at integration coordinate c(a): [tc, D, N(a)]
        x1 = p1[:, :, None] + (c[None, None, :] - p0[:, :, None]) * slope[
            :, :, None
        ]
        fb = (x1 + 1.0) / h - 0.5
        w = jnp.maximum(
            0.0, 1.0 - jnp.abs(fb[..., None] - i_idx)
        )  # [tc, D, a, i]
        w = (h / jnp.abs(safe))[:, :, None, None] * w
        if transpose:
            w = jnp.swapaxes(w, 2, 3)  # (i, a) -> image layout (a, i)
        return w

    w_r = branch(p0, p1, u0, u1, transpose=False)
    w_c = branch(p1, p0, u1, u0, transpose=True)
    use_r = (jnp.abs(u0) >= jnp.abs(u1))[:, :, None, None]
    w = jnp.where(use_r, w_r, w_c)
    w = w * val_blk[:, None, None, None]
    return w.reshape(tc * D, N * N)


# ---------------------------------------------------------------------------
# Batched-over-nodes wrappers
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=0)
def project_nodes(
    cfg: GeometryConfig, imgs: jnp.ndarray, angles: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Forward-project every node's image: [P,N,N] -> [P, m_max, D]."""
    return jax.vmap(lambda im, a, v: project(cfg, im, a, v))(imgs, angles, valid)


@functools.partial(jax.jit, static_argnums=0)
def backproject_nodes(
    cfg: GeometryConfig, sinos: jnp.ndarray, angles: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Adjoint per node: [P, m_max, D] -> [P, N, N]."""
    return jax.vmap(lambda s, a, v: backproject(cfg, s, a, v))(sinos, angles, valid)
