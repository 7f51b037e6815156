"""SO(3): rotations as 3x3 matrices + unit quaternions, batched & branch-free.

Replaces the reference's quaternion/matrix conversions (`util/Converter.h`,
g2o `se3quat.h`) with jnp ops safe under jit/vmap: all small-angle and
near-pi cases are handled with Taylor fallbacks selected by `jnp.where`
(never python branches), so the same code runs on the device for any batch shape.

Quaternions are stored (w, x, y, z), Hamilton convention, unit norm.
"""

from __future__ import annotations

import jax.numpy as jnp

from hyslam_tpu.utils.precision import HIGHEST as _P

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix [..., 3] -> [..., 3, 3] such that hat(w) @ v = w x v."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jnp.ndarray):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (1 - sin t/t)/t^2).

    float32-robust: the Taylor switch happens at theta = 0.5 (not machine
    epsilon) so that the closed forms are only evaluated where they have no
    catastrophic cancellation; B uses the identity 1-cos t = 2 sin^2(t/2).
    The sqrt argument is guarded (not just the result) so gradients at
    theta = 0 stay finite.  theta2 = |w|^2.
    """
    small = theta2 < 0.25
    st2 = jnp.where(small, 1.0, theta2)
    t = jnp.sqrt(st2)
    t4 = theta2 * theta2
    t6 = t4 * theta2
    A = jnp.where(
        small, 1.0 - theta2 / 6.0 + t4 / 120.0 - t6 / 5040.0, jnp.sin(t) / t
    )
    sh = jnp.sin(0.5 * t)
    B = jnp.where(
        small,
        0.5 - theta2 / 24.0 + t4 / 720.0 - t6 / 40320.0,
        2.0 * sh * sh / st2,
    )
    C = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0 - t6 / 362880.0,
        (1.0 - A) / st2,
    )
    return A, B, C


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map: axis-angle [..., 3] -> rotation matrix [..., 3, 3].

    Rodrigues: R = I + A*hat(w) + B*hat(w)^2.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_P)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map: rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Implemented via quaternions, which is uniformly stable including near
    theta = pi (where the classic (R - R^T) formula degenerates).
    """
    return quat_log(quat_from_mat(R))


def quat_from_mat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z), Shepperd's method.

    All four branch candidates are computed and the numerically best one is
    selected with where-masks (branch-free, batch-safe).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate 4*q_i^2 values
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    # candidate quaternions (unnormalized), one per dominant component
    cw = jnp.stack([qw2, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    cx = jnp.stack([m21 - m12, qx2, m01 + m10, m02 + m20], axis=-1)
    cy = jnp.stack([m02 - m20, m01 + m10, qy2, m12 + m21], axis=-1)
    cz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, qz2], axis=-1)

    mags = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = jnp.argmax(mags, axis=-1)
    cand = jnp.stack([cw, cx, cy, cz], axis=-2)  # [..., 4 cands, 4]
    q = jnp.take_along_axis(cand, best[..., None, None].repeat(4, -1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def mat_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
    return r


def quat_log(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> axis-angle [..., 3] (rotation vector, |v| in [0, pi])."""
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = jnp.linalg.norm(v, axis=-1)
    theta = 2.0 * jnp.arctan2(vn, w)
    small = vn < _EPS
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), theta / jnp.where(small, 1.0, vn))
    return v * scale[..., None]


def quat_exp(w3: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle [..., 3] -> unit quaternion (w,x,y,z)."""
    theta2 = jnp.sum(w3 * w3, axis=-1)
    small = theta2 < 1e-10
    safe_t = jnp.sqrt(jnp.where(small, 1.0, theta2))  # guarded sqrt (gradients)
    half = 0.5 * jnp.where(small, 0.0, safe_t)
    s = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / safe_t)
    qw = jnp.cos(half)
    return jnp.concatenate([qw[..., None], w3 * s[..., None]], axis=-1)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of quaternions (w,x,y,z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def normalize(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize a near-rotation matrix (SVD projection)."""
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(jnp.matmul(u, vt, precision=_P))
    d = jnp.ones(R.shape[:-2] + (3,), R.dtype).at[..., 2].set(det)
    return jnp.matmul(u * d[..., None, :], vt, precision=_P)


def left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian J_l(w) = I + B*hat + C*hat^2 (V matrix of SE(3) exp)."""
    theta2 = jnp.sum(w * w, axis=-1)
    _, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_P)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + B[..., None, None] * W + C[..., None, None] * W2


def left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse of the SO(3) left Jacobian, with small-angle Taylor fallback."""
    theta2 = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta2)
    small = theta2 < 0.25
    safe_t2 = jnp.where(small, 1.0, theta2)
    # D = (1 - A/(2B)) / theta^2, -> 1/12 as theta -> 0 (f32: switch at 0.5)
    t4 = theta2 * theta2
    D = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0,
        (1.0 - A / (2.0 * B)) / safe_t2,
    )
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_P)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + D[..., None, None] * W2
