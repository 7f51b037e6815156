"""The matching engine: every FeatureMatcher entry point as dense masked
matmul ops.

Replaces src/features/FeatureMatcher.{h,cc} + MatchCriteria.{h,cc}. The
reference's architecture — candidate harvesting via a keypoint grid, then a
pipeline of criterion objects (LandMarkCriterion -> LandMarkViewCriterion ->
GlobalCriterion, FeatureMatcher.h:1-103) — maps to masked dense score
matrices here:

- LandMark criteria (projection window, distance range, viewing angle)
  become [Q] / [Q, F] boolean masks,
- LandMarkView criteria (level compatibility, stereo consistency, best
  score) become mask terms + the argmin,
- Global criteria (rotation consistency, one-landmark-per-feature) become
  the histogram filter and a feature-side argmin pass.

All functions are jit-friendly on padded arrays; -1 marks "no match".
Thresholds mirror the reference: TH_HIGH=100, TH_LOW=50, ratio 0.9/0.75/0.6,
rotation histogram of 30 bins keeping the 3 largest (ComputeThreeMaxima,
FeatureMatcher.cc:1079).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hyslam_tpu.core.frame import FrameFeatures
from hyslam_tpu.geometry import se3
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.ops.hamming import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30
N_LEVELS = 8        # defaults only; per-camera values flow in from
SCALE = 1.2         # ExtractorConfig via the n_levels/scale_factor args
BIG = 1 << 16


def predict_level(dist: jnp.ndarray, max_dist: jnp.ndarray,
                  n_levels: int = N_LEVELS, scale_factor: float = SCALE):
    """Scale level a landmark would appear at, from its distance and
    max-distance invariance bound (MapPoint::PredictScale analog), under
    the camera's pyramid model (FeatureExtractorSettings)."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-6), 1e-6)
    lv = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor))
    return jnp.clip(lv, 0, n_levels - 1).astype(jnp.int32)


def rotation_consistency(delta_angle: jnp.ndarray, matched: jnp.ndarray):
    """Keep only matches whose orientation change falls in the 3 dominant
    30-bin histogram bins (GlobalCriterion RotationConsistency)."""
    two_pi = 2.0 * jnp.pi
    frac = jnp.mod(delta_angle, two_pi) / two_pi
    bins = jnp.clip((frac * HISTO_BINS).astype(jnp.int32), 0, HISTO_BINS - 1)
    hist = jax.ops.segment_sum(
        matched.astype(jnp.int32), bins, num_segments=HISTO_BINS
    )
    top3_v, top3_i = jax.lax.top_k(hist, 3)
    # ComputeThreeMaxima rule: drop 2nd/3rd maxima below 10% of the first
    keep_k = top3_v.astype(jnp.float32) >= 0.1 * top3_v[0].astype(jnp.float32)
    good_bins = jnp.zeros((HISTO_BINS,), bool).at[top3_i].set(keep_k & (top3_v > 0))
    return matched & good_bins[bins]


def _dedup_feature_side(dist_qf: jnp.ndarray, match_q: jnp.ndarray, ok_q: jnp.ndarray):
    """Resolve feature conflicts: if several queries matched the same
    feature, keep the smallest distance (one landmark per feature invariant,
    PreviouslyMatchedCriterion analog). Returns updated ok_q."""
    F = dist_qf.shape[1]
    q_dist = jnp.where(
        ok_q, jnp.take_along_axis(dist_qf, jnp.clip(match_q, 0, F - 1)[:, None], 1)[:, 0],
        BIG,
    )
    tgt = jnp.where(ok_q, match_q, F)
    best_per_f = jnp.full((F + 1,), BIG, jnp.int32).at[tgt].min(q_dist.astype(jnp.int32))
    keep = ok_q & (q_dist.astype(jnp.int32) <= best_per_f[jnp.clip(tgt, 0, F)])
    # break exact ties: first query wins
    Q = dist_qf.shape[0]
    qidx = jnp.arange(Q, dtype=jnp.int32)
    first_q = jnp.full((F + 1,), Q, jnp.int32).at[
        jnp.where(keep, tgt, F)
    ].min(qidx)
    keep = keep & (first_q[jnp.clip(tgt, 0, F)] == qidx)
    return keep


class ProjMatchResult(NamedTuple):
    lm_for_feature: jnp.ndarray   # [F] landmark-row index (-1 = none)
    n_matches: jnp.ndarray


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale_factor"))
def search_by_projection_landmarks(
    cam: Camera,
    frame: FrameFeatures,
    Tcw: jnp.ndarray,
    lm_pos: jnp.ndarray,       # [Q, 3]
    lm_normal: jnp.ndarray,    # [Q, 3]
    lm_desc: jnp.ndarray,      # [Q, 8]
    lm_max_dist: jnp.ndarray,  # [Q]
    lm_min_dist: jnp.ndarray,  # [Q]
    lm_valid: jnp.ndarray,     # [Q]
    already_matched: jnp.ndarray,  # [F] features to skip (have a landmark)
    th: float = 1.0,
    ratio: float = 0.9,
    n_levels: int = N_LEVELS,
    scale_factor: float = SCALE,
) -> ProjMatchResult:
    """Track-local-map matching (_SearchByProjection_ vs a landmark set,
    FeatureMatcher.cc:123 path). Returns the per-feature landmark row.

    Criteria replicated: in-image projection, depth > 0, distance within
    [0.8 min, 1.2 max], viewing angle cos > 0.5, predicted-level window
    radius (2.5 or 4.0) * th * scale(level), level in [pred-1, pred],
    best-vs-second ratio on same level, TH_HIGH gate.
    """
    pc = se3.apply(Tcw, lm_pos)                                 # [Q, 3]
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height) & (z > 0)

    cam_center = se3.translation(se3.inverse(Tcw))
    po = lm_pos - cam_center
    dist = jnp.linalg.norm(po, axis=-1)
    dist_ok = (dist >= 0.8 * lm_min_dist) & (dist <= 1.2 * lm_max_dist)
    ncos = jnp.sum(po * lm_normal, axis=-1) / jnp.maximum(
        dist * jnp.linalg.norm(lm_normal, axis=-1), 1e-9
    )
    view_ok = ncos > 0.5
    lv = predict_level(dist, lm_max_dist, n_levels, scale_factor)
    r_base = jnp.where(ncos > 0.998, 2.5, 4.0)
    radius = r_base * th * scale_factor ** lv.astype(jnp.float32)  # [Q]

    q_ok = lm_valid & in_img & dist_ok & view_ok

    duv = jnp.stack([u, v], -1)[:, None, :] - frame.uv[None, :, :]
    within = jnp.sum(duv * duv, axis=-1) <= (radius[:, None] ** 2)
    lvl_ok = (frame.level[None, :] >= lv[:, None] - 1) & (
        frame.level[None, :] <= lv[:, None] + 1
    )
    fmask = frame.valid[None, :] & ~already_matched[None, :]
    ok_qf = q_ok[:, None] & within & lvl_ok & fmask

    # best + second-best via two argmin passes (cheaper XLA lowering than
    # top_k on a [Q, F] int matrix)
    d = jnp.where(ok_qf, hamming_matrix(lm_desc, frame.desc), BIG)
    best_i = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_d = jnp.take_along_axis(d, best_i[:, None], 1)[:, 0]
    Q_ = d.shape[0]
    d2 = d.at[jnp.arange(Q_), best_i].set(BIG)
    second_i = jnp.argmin(d2, axis=1).astype(jnp.int32)
    second_d = jnp.take_along_axis(d2, second_i[:, None], 1)[:, 0]
    best_lv = frame.level[best_i]
    second_lv = frame.level[second_i]
    ratio_ok = (best_lv != second_lv) | (
        best_d.astype(jnp.float32) <= ratio * second_d.astype(jnp.float32)
    )
    ok_q = q_ok & (best_d <= TH_HIGH) & ratio_ok
    keep = _dedup_feature_side(d, best_i, ok_q)

    F = frame.capacity
    Q = lm_pos.shape[0]
    lm_for_feature = jnp.full((F,), -1, jnp.int32)
    tgt = jnp.where(keep, best_i, F)
    lm_for_feature = (
        jnp.full((F + 1,), -1, jnp.int32)
        .at[tgt]
        .set(jnp.arange(Q, dtype=jnp.int32), mode="drop")[:F]
    )
    return ProjMatchResult(
        lm_for_feature=lm_for_feature,
        n_matches=jnp.sum((lm_for_feature >= 0).astype(jnp.int32)),
    )


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale_factor"))
def search_by_projection_frame(
    cam: Camera,
    cur: FrameFeatures,
    Tcw_pred: jnp.ndarray,
    last: FrameFeatures,
    last_lm_id: jnp.ndarray,      # [F] landmark ids of last frame
    last_lm_pos: jnp.ndarray,     # [F, 3] world positions for those ids
    th: float = 1.0,
    forward: jnp.ndarray | None = None,
    n_levels: int = N_LEVELS,
    scale_factor: float = SCALE,
):
    """Motion-model matching vs the last frame (FeatureMatcher.cc:145 path):
    project last frame's landmarks with the predicted pose, window-search by
    level, rotation-consistency filter. Returns ([F_cur] landmark ids, count).
    """
    has_lm = (last_lm_id >= 0) & last.valid
    pc = se3.apply(Tcw_pred, last_lm_pos)
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height) & (z > 0)
    q_ok = has_lm & in_img

    lv = last.level
    radius = th * scale_factor ** lv.astype(jnp.float32)
    duv = jnp.stack([u, v], -1)[:, None, :] - cur.uv[None, :, :]
    within = jnp.sum(duv * duv, axis=-1) <= (radius[:, None] ** 2)
    lvl_ok = (cur.level[None, :] >= lv[:, None] - 1) & (
        cur.level[None, :] <= lv[:, None] + 1
    )
    ok_qf = q_ok[:, None] & within & lvl_ok & cur.valid[None, :]

    d = jnp.where(ok_qf, hamming_matrix(last.desc, cur.desc), BIG)
    best_i = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best_i[:, None], 1)[:, 0]
    ok_q = q_ok & (best_d <= TH_HIGH)

    dang = cur.angle[best_i] - last.angle
    ok_q = rotation_consistency(dang, ok_q)
    keep = _dedup_feature_side(d, best_i, ok_q)

    F = cur.capacity
    tgt = jnp.where(keep, best_i, F)
    lm_ids = (
        jnp.full((F + 1,), -1, jnp.int32).at[tgt].set(last_lm_id, mode="drop")[:F]
    )
    return lm_ids, jnp.sum((lm_ids >= 0).astype(jnp.int32))


@jax.jit
def match_descriptors(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    angle_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    angle_b: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 0.75,
    check_rotation: bool = True,
):
    """Generic descriptor matching A -> B with ratio + rotation tests — the
    SearchByBoW analog (FeatureMatcher.cc:216,281). The reference restricts
    candidates to shared BoW nodes purely as a CPU pruning; here the dense
    distance matrix replaces gather-pruning, criteria are identical.

    Returns ([A] index into B or -1, count)."""
    ok_ab = valid_a[:, None] & valid_b[None, :]
    d = jnp.where(ok_ab, hamming_matrix(desc_a, desc_b), BIG)
    best_i = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_d = jnp.take_along_axis(d, best_i[:, None], 1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_i].set(BIG)
    second_d = jnp.min(d2, axis=1)
    ok = valid_a & (best_d <= max_dist) & (
        best_d.astype(jnp.float32) <= ratio * second_d.astype(jnp.float32)
    )
    dang = angle_b[best_i] - angle_a
    ok = jnp.where(check_rotation, rotation_consistency(dang, ok), ok)
    keep = _dedup_feature_side(d, best_i, ok)
    out = jnp.where(keep, best_i, -1)
    return out, jnp.sum((out >= 0).astype(jnp.int32))


def fundamental_from_poses(cam1: Camera, Tcw1: jnp.ndarray,
                           cam2: Camera, Tcw2: jnp.ndarray) -> jnp.ndarray:
    """Fundamental matrix mapping image-1 points to image-2 epilines:
    l2 = F @ x1,  x2^T F x1 = 0  (GenUtils::ComputeF12 analog).
    F = K2^{-T} [t21]x R21 K1^{-1} with (R21, t21) = Tcw2 @ Tcw1^{-1}."""
    from hyslam_tpu.geometry import so3

    T21 = Tcw2 @ se3.inverse(Tcw1)
    R21 = T21[:3, :3]
    t21 = T21[:3, 3]
    K1i = jnp.linalg.inv(cam1.K())
    K2i = jnp.linalg.inv(cam2.K())
    return K2i.T @ so3.hat(t21) @ R21 @ K1i


@partial(jax.jit, static_argnames=("cam", "scale_factor"))
def search_for_triangulation(
    cam: Camera,
    f1: FrameFeatures,
    f2: FrameFeatures,
    unmatched1: jnp.ndarray,   # [F] bool: feature has no landmark yet
    unmatched2: jnp.ndarray,
    F12: jnp.ndarray,          # [3, 3] fundamental matrix kf1 -> kf2
    epi_sigma: float = 1.0,
    scale_factor: float = SCALE,
):
    """Epipolar-constrained matching of unmatched features between two
    keyframes for new-landmark triangulation (SearchForTriangulation,
    FeatureMatcher.cc:373): Hamming TH_LOW + point-to-epiline chi2 gate
    (3.84 sigma^2 at the candidate's level) + rotation consistency."""
    x1 = jnp.concatenate([f1.uv, jnp.ones((f1.capacity, 1))], axis=-1)  # [F,3]
    l2 = x1 @ F12.T                                          # epilines in img2
    x2 = jnp.concatenate([f2.uv, jnp.ones((f2.capacity, 1))], axis=-1)
    num = jnp.abs(l2 @ x2.T)                                  # [F1, F2]
    den = jnp.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None]
    epi_d2 = (num / jnp.maximum(den, 1e-9)) ** 2
    sigma2 = epi_sigma * scale_factor ** (2.0 * f2.level.astype(jnp.float32))
    epi_ok = epi_d2 < 3.84 * sigma2[None, :]

    ok_ab = (
        (f1.valid & unmatched1)[:, None]
        & (f2.valid & unmatched2)[None, :]
        & epi_ok
    )
    d = jnp.where(ok_ab, hamming_matrix(f1.desc, f2.desc), BIG)
    best_i = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best_i[:, None], 1)[:, 0]
    ok = (f1.valid & unmatched1) & (best_d <= TH_LOW)
    dang = f2.angle[best_i] - f1.angle
    ok = rotation_consistency(dang, ok)
    keep = _dedup_feature_side(d, best_i, ok)
    out = jnp.where(keep, best_i, -1)
    return out, jnp.sum((out >= 0).astype(jnp.int32))
