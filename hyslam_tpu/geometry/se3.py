"""SE(3): rigid transforms as [..., 4, 4] homogeneous matrices.

Tangent vectors are [..., 6] ordered (omega, upsilon) — rotation first — the
same ordering as g2o's SE3Quat::exp/log used throughout the reference
optimizers (Thirdparty/g2o/g2o/types/se3quat.h), so solver update conventions
translate directly. Updates in the solvers are LEFT-multiplicative:
T <- exp(delta) @ T, matching g2o's VertexSE3Expmap::oplusImpl.
"""

from __future__ import annotations

import jax.numpy as jnp

from hyslam_tpu.geometry import so3
from hyslam_tpu.utils.precision import HIGHEST as _P


def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch_shape) + (4, 4))


def from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Build [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return from_Rt(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_P))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(A, B, precision=_P)


def apply(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Transform points: T [..., 4, 4] applied to pts [..., 3] (broadcasting)."""
    return (
        jnp.einsum("...ij,...j->...i", rotation(T), pts, precision=_P)
        + translation(T)
    )


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map [..., 6] (omega, upsilon) -> [..., 4, 4]."""
    w = xi[..., :3]
    v = xi[..., 3:]
    R = so3.exp(w)
    V = so3.left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, v, precision=_P)
    return from_Rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map [..., 4, 4] -> [..., 6] (omega, upsilon)."""
    w = so3.log(rotation(T))
    Vinv = so3.left_jacobian_inv(w)
    v = jnp.einsum("...ij,...j->...i", Vinv, translation(T), precision=_P)
    return jnp.concatenate([w, v], axis=-1)


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint [..., 6, 6] for tangent ordering (omega, upsilon):
    Ad(T) = [[R, 0], [hat(t) R, R]]."""
    R = rotation(T)
    t = translation(T)
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, z], axis=-1)
    bottom = jnp.concatenate([jnp.matmul(so3.hat(t), R, precision=_P), R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def interpolate(T0: jnp.ndarray, T1: jnp.ndarray, alpha) -> jnp.ndarray:
    """Geodesic interpolation: T(alpha) = exp(alpha * log(T1 T0^-1)) T0.

    This is the array-native equivalent of the reference Trajectory's
    `poseAtTime` interpolation (src/core/Trajectory.cc:195) used to place the
    imaging camera between stereo frames.
    """
    alpha = jnp.asarray(alpha)
    delta = log(compose(T1, inverse(T0)))
    return compose(exp(alpha[..., None] * delta), T0)


def normalize(T: jnp.ndarray) -> jnp.ndarray:
    """Project the rotation block back onto SO(3) (drift control)."""
    return from_Rt(so3.normalize(rotation(T)), translation(T))
