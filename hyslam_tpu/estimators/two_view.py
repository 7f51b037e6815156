"""Two-view relative pose estimation: batched H/F RANSAC + motion recovery.

Replaces MonoEstimator (src/initializers/MonoEstimator.{h,cpp}): the
reference scores homography and fundamental models in parallel RANSAC
threads and selects by RH = SH/(SH+SF) at 0.40 (MonoEstimator.cpp:126-132);
here every hypothesis is one row of a batched tensor program (hypothesis
generation = batched eigh, scoring = one [S, M] matrix op — the RANSAC
shape that fits an accelerator).

Motion recovery:
- F-branch: essential-matrix decomposition with cheirality arbitration over
  the four (R, t) candidates (ReconstructF).
- H-branch: Faugeras/Malis 8-hypothesis homography decomposition with
  triangulation-count arbitration and the reference's uniqueness gate
  (second-best < 0.75 * best, ReconstructH, MonoEstimator.cpp:585-744) —
  this is what initializes planar scenes (seafloor / wall starts) where the
  fundamental model is degenerate.
"""

from __future__ import annotations

from functools import partial

from hyslam_tpu.utils.precision import f32 as _f32

import jax
import jax.numpy as jnp
import numpy as np

from hyslam_tpu.geometry import se3
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.geometry.triangulation import projection_matrix, triangulate_dlt

N_HYPOTHESES = 256
CHI2_F = 3.84    # per-direction epipolar chi2 gate (CheckFundamental)
CHI2_H = 5.991   # scoring offset (both models) + H transfer-error gate
RH_SELECT = 0.40  # homography selected when SH/(SH+SF) > 0.40
MIN_TRIANGULATED = 50
MIN_FRAC_TRIANGULATED = 0.9  # H-branch: best must triangulate 90% of inliers


def _fit_fundamental(p1, p2):
    """8-point fundamental for one minimal set ([8,2],[8,2]) -> [3,3]."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)],
        axis=-1,
    )  # [8, 9]
    _, vecs = jnp.linalg.eigh(A.T @ A)
    f = vecs[:, 0].reshape(3, 3)
    # enforce rank 2
    u, s, vt = jnp.linalg.svd(f)
    s = s.at[2].set(0.0)
    return (u * s[None, :]) @ vt


def _epipolar_chi2(F, p1, p2, inv_sigma2=1.0):
    """Symmetric epipolar transfer chi2 both directions ([M], [M])."""
    ones = jnp.ones((p1.shape[0], 1), p1.dtype)
    x1 = jnp.concatenate([p1, ones], -1)
    x2 = jnp.concatenate([p2, ones], -1)
    l2 = x1 @ F.T          # lines in image 2
    l1 = x2 @ F            # lines in image 1
    num = jnp.sum(x2 * l2, -1) ** 2
    d2_2 = num / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12)
    d2_1 = num / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12)
    return d2_1 * inv_sigma2, d2_2 * inv_sigma2


def _sample_valid(key, valid, n_sets, set_size=8):
    """[S, set_size] indices drawn only from rows where valid is True
    (padded capacity rows would otherwise dominate the minimal sets)."""
    order = jnp.argsort(~valid)           # valid rows first, stable
    nv = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    samp = jax.random.randint(key, (n_sets, set_size), 0, nv)
    return order[samp]


@_f32
@partial(jax.jit, static_argnames=())
def ransac_fundamental(p1, p2, valid, key):
    """Batched RANSAC: [M,2] correspondences -> (best F, inlier mask, score).

    Scoring mirrors MonoEstimator::CheckFundamental: per-point score
    sum(th - d2) over both directions for d2 < chi2 gate."""
    M = p1.shape[0]
    idx = _sample_valid(key, valid, N_HYPOTHESES)
    w = valid.astype(p1.dtype)

    def one(i8):
        return _fit_fundamental(p1[i8], p2[i8])

    Fs = jax.vmap(one)(idx)                           # [S,3,3]

    def score(F):
        d1, d2 = _epipolar_chi2(F, p1, p2)
        ok = (d1 < CHI2_F) & (d2 < CHI2_F) & valid
        sc = jnp.sum(
            jnp.where(ok, (CHI2_H - d1) + (CHI2_H - d2), 0.0)
        )
        return sc, ok

    scores, inls = jax.vmap(score)(Fs)
    best = jnp.argmax(scores)
    return Fs[best], inls[best], scores[best]


def _normalize_points(p, valid):
    """Hartley normalization (MonoEstimator::Normalize): shift to the valid
    centroid, scale each axis by its mean absolute deviation. Returns
    (normalized points [M,2], T [3,3] with pn_h = T @ p_h)."""
    w = valid.astype(p.dtype)
    n = jnp.maximum(w.sum(), 1.0)
    mean = (p * w[:, None]).sum(0) / n
    dev = (jnp.abs(p - mean) * w[:, None]).sum(0) / n
    s = 1.0 / jnp.maximum(dev, 1e-9)
    pn = (p - mean) * s
    T = jnp.array([
        [s[0], 0.0, -mean[0] * s[0]],
        [0.0, s[1], -mean[1] * s[1]],
        [0.0, 0.0, 1.0],
    ], p.dtype)
    return pn, T


def _fit_homography(p1, p2):
    """4+-point DLT homography for one minimal set ([8,2],[8,2]) -> [3,3]
    H21 with p2_h ~ H21 @ p1_h (ComputeH21)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    rows_a = jnp.stack(
        [z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    rows_b = jnp.stack(
        [x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)   # [16, 9]
    _, vecs = jnp.linalg.eigh(A.T @ A)
    return vecs[:, 0].reshape(3, 3)


def _homography_chi2(H21, H12, p1, p2):
    """Bidirectional transfer chi2 (CheckHomography): p1 through H21 vs p2,
    p2 through H12 vs p1. Returns (d2_1 [M], d2_2 [M])."""
    ones = jnp.ones((p1.shape[0], 1), p1.dtype)
    x1 = jnp.concatenate([p1, ones], -1)
    x2 = jnp.concatenate([p2, ones], -1)

    def xfer(H, x):
        y = x @ H.T
        w = y[:, 2]
        wsafe = jnp.where(jnp.abs(w) < 1e-9, 1e-9, w)
        return y[:, :2] / wsafe[:, None]

    d2_2 = jnp.sum((xfer(H21, x1) - p2) ** 2, -1)   # error in image 2
    d2_1 = jnp.sum((xfer(H12, x2) - p1) ** 2, -1)   # error in image 1
    return d2_1, d2_2


@_f32
@partial(jax.jit, static_argnames=())
def ransac_homography(p1, p2, valid, key):
    """Batched homography RANSAC: [M,2] correspondences ->
    (best H21, inlier mask, score). Scoring mirrors CheckHomography: each
    transfer direction adds (5.991 - chi2) when below the gate; an inlier
    must pass both directions. Minimal sets are fit on Hartley-normalized
    coordinates, scored at full resolution (FindHomography)."""
    M = p1.shape[0]
    pn1, T1 = _normalize_points(p1, valid)
    pn2, T2 = _normalize_points(p2, valid)
    T2inv = jnp.linalg.inv(T2)
    idx = _sample_valid(key, valid, N_HYPOTHESES)

    def one(i8):
        Hn = _fit_homography(pn1[i8], pn2[i8])
        return T2inv @ Hn @ T1

    Hs = jax.vmap(one)(idx)                            # [S,3,3]
    Hinvs = jnp.linalg.inv(Hs)

    def score(H21, H12):
        d1, d2 = _homography_chi2(H21, H12, p1, p2)
        in1 = (d1 < CHI2_H) & valid
        in2 = (d2 < CHI2_H) & valid
        sc = (jnp.sum(jnp.where(in1, CHI2_H - d1, 0.0))
              + jnp.sum(jnp.where(in2, CHI2_H - d2, 0.0)))
        return sc, in1 & in2

    scores, inls = jax.vmap(score)(Hs, Hinvs)
    best = jnp.argmax(scores)
    return Hs[best], inls[best], scores[best]


def _triangulate_and_check(cam, T21, p1, p2, valid):
    P1 = projection_matrix(cam.K(), se3.identity())
    P2 = projection_matrix(cam.K(), T21)
    M = p1.shape[0]
    X = triangulate_dlt(
        jnp.broadcast_to(P1, (M, 3, 4)), jnp.broadcast_to(P2, (M, 3, 4)), p1, p2
    )
    z1 = X[:, 2]
    pc2 = se3.apply(T21, X)
    z2 = pc2[:, 2]
    # reprojection gates
    def reproj(P, X, uv):
        x = jnp.concatenate([X, jnp.ones((M, 1))], -1) @ P.T
        return jnp.sum((x[:, :2] / jnp.maximum(x[:, 2:], 1e-9) - uv) ** 2, -1)

    e1 = reproj(P1, X, p1)
    e2 = reproj(P2, X, p2)
    # parallax per point
    r1 = X
    C2 = se3.translation(se3.inverse(T21))
    r2 = X - C2
    cosp = jnp.sum(r1 * r2, -1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-9
    )
    good = valid & (z1 > 0) & (z2 > 0) & (e1 < 4.0) & (e2 < 4.0) & (cosp < 0.99998)
    return X, good, cosp


@_f32
@partial(jax.jit, static_argnames=("cam",))
def _recover_pose(cam: Camera, F, p1, p2, valid):
    """E = K^T F K -> 4 candidate (R, t); pick by cheirality vote."""
    K = cam.K()
    E = K.T @ F @ K
    u, s, vt = jnp.linalg.svd(E)
    # ensure proper rotations
    d = jnp.linalg.det(u @ vt)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = u[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)

    cands = [
        se3.from_Rt(R1, t), se3.from_Rt(R1, -t),
        se3.from_Rt(R2, t), se3.from_Rt(R2, -t),
    ]
    results = [
        _triangulate_and_check(cam, T, p1, p2, valid) for T in cands
    ]
    votes = jnp.stack([jnp.sum(g.astype(jnp.int32)) for _, g, _ in results])
    best = jnp.argmax(votes)
    X = jnp.stack([X for X, _, _ in results])[best]
    good = jnp.stack([g for _, g, _ in results])[best]
    T = jnp.stack(cands)[best]
    return T, X, good, votes[best]


@_f32
@partial(jax.jit, static_argnames=("cam",))
def _recover_pose_homography(cam: Camera, H21, p1, p2, valid):
    """ReconstructH (MonoEstimator.cpp:585-744): Faugeras 1988 decomposition
    of A = K^-1 H K into 8 motion hypotheses (4 for d'=d2, 4 for d'=-d2);
    each hypothesis is triangulation-checked and the winner must beat the
    runner-up by the 0.75 uniqueness factor.

    Returns (T21, X, good, best_votes, second_votes, ok_decomp)."""
    K = cam.K()
    A = jnp.linalg.inv(K) @ H21 @ K
    U, w, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    # degenerate when singular values are (near-)equal
    ok_decomp = (d1 / jnp.maximum(d2, 1e-12) > 1.00001) & (
        d2 / jnp.maximum(d3, 1e-12) > 1.00001)

    denom13 = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom13)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom13)
    x1s = jnp.asarray([aux1, aux1, -aux1, -aux1])
    x3s = jnp.asarray([aux3, -aux3, aux3, -aux3])

    # case d' = d2
    num = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    st = num / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    sthetas = jnp.asarray([st, -st, -st, st])

    # case d' = -d2
    sp = num / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sphis = jnp.asarray([sp, -sp, -sp, sp])

    cands = []
    for i in range(4):
        Rp = jnp.array([
            [ct, 0.0, -sthetas[i]],
            [0.0, 1.0, 0.0],
            [sthetas[i], 0.0, ct],
        ])
        R = s * U @ Rp @ Vt
        tp = (d1 - d3) * jnp.asarray([x1s[i], 0.0, -x3s[i]])
        t = U @ tp
        t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
        cands.append(se3.from_Rt(R, t))
    for i in range(4):
        Rp = jnp.array([
            [cp, 0.0, sphis[i]],
            [0.0, -1.0, 0.0],
            [sphis[i], 0.0, -cp],
        ])
        R = s * U @ Rp @ Vt
        tp = (d1 + d3) * jnp.asarray([x1s[i], 0.0, x3s[i]])
        t = U @ tp
        t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
        cands.append(se3.from_Rt(R, t))

    results = [_triangulate_and_check(cam, T, p1, p2, valid) for T in cands]
    votes = jnp.stack([jnp.sum(g.astype(jnp.int32)) for _, g, _ in results])
    best = jnp.argmax(votes)
    # runner-up count for the uniqueness gate
    second = jnp.max(jnp.where(
        jnp.arange(8) == best, jnp.int32(-1), votes))
    X = jnp.stack([X for X, _, _ in results])[best]
    good = jnp.stack([g for _, g, _ in results])[best]
    T = jnp.stack(cands)[best]
    return T, X, good, votes[best], second, ok_decomp


def two_view_reconstruct(cam: Camera, uv1, uv2, idx, seed: int = 0):
    """Full pipeline: matched features (uv1 [F,2], idx [F] into uv2) ->
    (ok, T21 [4,4], X [F,3] world points in frame-1, inlier mask [F]).

    Both models are fit in parallel and selected by RH = SH/(SH+SF) > 0.40
    (MonoEstimator.cpp:126-132). The F-branch requires >= 50 cheirality-
    consistent points with adequate parallax; the H-branch additionally
    requires the best hypothesis to triangulate > 0.9 of the inliers and to
    beat the runner-up by 4/3 (ReconstructH acceptance). Pure rotation
    still fails (no parallax to triangulate), which reproduces the
    reference's observable wait-for-parallax behavior."""
    F_cap = uv1.shape[0]
    valid = idx >= 0
    p1 = uv1
    p2 = uv2[jnp.clip(idx, 0, uv2.shape[0] - 1)]
    key = jax.random.PRNGKey(seed)
    kF, kH = jax.random.split(key)
    Fm, inlF, sF = ransac_fundamental(p1, p2, valid, kF)
    Hm, inlH, sH = ransac_homography(p1, p2, valid, kH)
    rh = float(sH) / max(float(sH) + float(sF), 1e-9)

    if rh > RH_SELECT:
        inlH = valid & inlH
        T21, X, good, best, second, ok_d = _recover_pose_homography(
            cam, Hm, p1, p2, inlH)
        n_best, n_second = int(best), int(second)
        n_inl = int(jnp.sum(inlH.astype(jnp.int32)))
        ok = (bool(ok_d) and n_second < 0.75 * n_best
              and n_best >= MIN_TRIANGULATED
              and n_best > MIN_FRAC_TRIANGULATED * n_inl)
        if not ok:
            return False, None, None, None
        return True, T21, X, good

    T21, X, good, votes = _recover_pose(cam, Fm, p1, p2, valid & inlF)
    n_good = int(votes)
    if n_good < MIN_TRIANGULATED:
        return False, None, None, None
    return True, T21, X, good
