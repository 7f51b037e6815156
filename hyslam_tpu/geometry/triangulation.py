"""Two-view DLT triangulation, batched.

Replaces `src/estimators/Triangulator.{h,cc}` (DLT with SVD on the 4x4
design matrix) with a batched jnp version used by the mapper's
LandMarkTriangulator job and the mono initializer.
"""

from __future__ import annotations

import jax.numpy as jnp

from hyslam_tpu.utils.precision import HIGHEST as _P


def triangulate_dlt(
    P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray
) -> jnp.ndarray:
    """DLT triangulation.

    P1, P2: projection matrices [..., 3, 4] (K @ Tcw[:3]).
    uv1, uv2: pixel observations [..., 2].
    Returns world points [..., 3] (homogeneous solution dehomogenized).

    Matches Triangulator::Triangulate (src/estimators/Triangulator.cc): rows
    of A are u*P3 - P1r, v*P3 - P2r for each view; solution is the right
    singular vector of least singular value.
    """
    def rows(P, uv):
        r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return jnp.stack([r0, r1], axis=-2)

    A = jnp.concatenate([rows(P1, uv1), rows(P2, uv2)], axis=-2)  # [..., 4, 4]
    # Right singular vector of smallest singular value of A == eigenvector of
    # A^T A with smallest eigenvalue. eigh batches well.
    AtA = jnp.matmul(jnp.swapaxes(A, -1, -2), A, precision=_P)
    _, vecs = jnp.linalg.eigh(AtA)
    X = vecs[..., :, 0]  # eigenvalues ascending -> first column
    w = X[..., 3]
    wsafe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / wsafe[..., None]


def projection_matrix(K: jnp.ndarray, Tcw: jnp.ndarray) -> jnp.ndarray:
    """K [3,3] and Tcw [..., 4, 4] -> P = K @ [R|t] of shape [..., 3, 4]."""
    return jnp.einsum("ij,...jk->...ik", K, Tcw[..., :3, :], precision=_P)
