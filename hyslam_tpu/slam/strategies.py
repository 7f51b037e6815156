"""Tracking strategies: motion-model, reference-KF, local-map — the jitted
compute behind the tracking state machine.

Replaces src/slam/tracking/TrackMotionModel.cpp, TrackReferenceKeyFrame.cpp,
TrackLocalMap.cpp. Each strategy is (match kernel) + (pose optimization) +
(outlier pruning), composed from hyslam_tpu.features.matcher and
hyslam_tpu.solver.pose_opt. Host code only sequences them.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hyslam_tpu.core.frame import Frame, feature_inv_sigma2
from hyslam_tpu.core.mapstate import MapState, resolve_landmarks
from hyslam_tpu.features.matcher import (
    match_descriptors,
    search_by_projection_frame,
    search_by_projection_landmarks,
)
from hyslam_tpu.geometry import se3
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.slam.localmap import LocalMap, build_local_map
from hyslam_tpu.slam.tracking_params import (
    LocalMapParams,
    MotionModelParams,
    ReferenceKFParams,
    TrackingParams,
)
from hyslam_tpu.solver.pose_opt import pose_optimization_fast


class TrackResult(NamedTuple):
    Tcw: jnp.ndarray
    lm_id: jnp.ndarray       # [F] associations after pruning
    n_inliers: jnp.ndarray
    ok: jnp.ndarray          # success flag


def _optimize_frame_pose(cam: Camera, feats, lm_id, lm_pos_table, Tcw0,
                         min_inliers: int, n_levels: int = 8,
                         scale_factor: float = 1.2):
    """Shared tail: pose-only LM on current associations + outlier pruning
    (the pattern at TrackMotionModel.cpp:45-80)."""
    F = feats.capacity
    has = lm_id >= 0
    X = lm_pos_table
    inv_s2 = feature_inv_sigma2(feats.level, n_levels, scale_factor)
    stereo = has & (feats.ur > 0)
    res = pose_optimization_fast(
        cam, Tcw0, X, feats.uv, feats.ur, inv_s2, has, stereo,
    )
    lm_out = jnp.where(res.inliers, lm_id, -1)
    ok = res.num_inliers >= min_inliers
    return TrackResult(
        Tcw=res.Tcw, lm_id=lm_out, n_inliers=res.num_inliers, ok=ok
    )


@partial(jax.jit,
         static_argnames=("cam", "min_inliers", "n_levels", "scale_factor",
                          "p"))
def track_motion_model(
    cam: Camera,
    cur_feats,
    Tcw_pred: jnp.ndarray,
    last_feats,
    last_lm_id: jnp.ndarray,
    ms: MapState,
    min_inliers: int = 20,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    p: MotionModelParams = MotionModelParams(),
) -> TrackResult:
    """TrackMotionModel::track: constant-velocity predicted pose ->
    projection match vs last frame -> pose optimization. The reference
    retries with a widened window (inflation_factor*th) when matches <
    n_min_matches (TrackMotionModel.cpp:40-44); both passes run
    unconditionally here and the wide result is used only if the narrow one
    is weak (no host sync). Parameters are static (per-camera constants,
    Tracking_datastructs.h TrackMotionModelParameters)."""
    last_lm_id = resolve_landmarks(ms, last_lm_id)
    last_pos = ms.lm.pos[jnp.clip(last_lm_id, 0, ms.L - 1)]

    lm_n, n_n = search_by_projection_frame(
        cam, cur_feats, Tcw_pred, last_feats, last_lm_id, last_pos,
        th=p.match_radius, n_levels=n_levels, scale_factor=scale_factor,
    )
    lm_w, _ = search_by_projection_frame(
        cam, cur_feats, Tcw_pred, last_feats, last_lm_id, last_pos,
        th=p.inflation_factor * p.match_radius,
        n_levels=n_levels, scale_factor=scale_factor,
    )
    lm_id = jnp.where(n_n >= p.n_min_matches, lm_n, lm_w)
    pos_table = ms.lm.pos[jnp.clip(lm_id, 0, ms.L - 1)]
    return _optimize_frame_pose(
        cam, cur_feats, lm_id, pos_table, Tcw_pred, min_inliers,
        n_levels, scale_factor,
    )


@partial(jax.jit,
         static_argnames=("cam", "min_inliers", "n_levels", "scale_factor",
                          "p"))
def track_reference_keyframe(
    cam: Camera,
    cur_feats,
    Tcw0: jnp.ndarray,
    ms: MapState,
    ref_kf,
    min_inliers: int = 10,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    p: ReferenceKFParams = ReferenceKFParams(),
) -> TrackResult:
    """TrackReferenceKeyFrame::track: descriptor-match the current frame
    against the reference keyframe's landmark-bearing features
    (>= n_min_matches_bow required), optimize from the last pose."""
    k = jnp.clip(ref_kf, 0, ms.K - 1)
    kf_lm = resolve_landmarks(ms, ms.kf.lm_id[k])
    kf_has = kf_lm >= 0
    idx_b, n = match_descriptors(
        cur_feats.desc, cur_feats.valid, cur_feats.angle,
        ms.kf.desc[k], ms.kf.kp_valid[k] & kf_has, ms.kf.angle[k],
        max_dist=p.max_descriptor_dist, ratio=p.match_nnratio,
    )
    lm_id = jnp.where(idx_b >= 0, kf_lm[jnp.clip(idx_b, 0, ms.F - 1)], -1)
    lm_id = jnp.where(n >= p.n_min_matches_bow, lm_id,
                      jnp.full_like(lm_id, -1))
    pos_table = ms.lm.pos[jnp.clip(lm_id, 0, ms.L - 1)]
    return _optimize_frame_pose(cam, cur_feats, lm_id, pos_table, Tcw0,
                                min_inliers, n_levels, scale_factor)


class LocalMapResult(NamedTuple):
    track: TrackResult
    local: LocalMap
    n_local_matches: jnp.ndarray


class NormalFrameResult(NamedTuple):
    """Everything the host state machine needs from one NORMAL-state frame,
    produced by ONE device program. `scalars` packs the telemetry / decision
    counters so the host syncs a single small transfer instead of one
    blocking int() per counter."""

    Tcw: jnp.ndarray          # [4,4] optimized pose
    lm_id: jnp.ndarray        # [F] pruned associations
    local_ref_kf: jnp.ndarray  # [] best-supported local keyframe
    scalars: jnp.ndarray      # int32 [8]: n_motion, init_ok, n_inliers,
                              #   n_local, n_tracked_close,
                              #   n_nontracked_close, ok, n_kfs_in_map


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale_factor",
                                   "params"))
def track_normal_frame(
    cam: Camera,
    cur_feats,
    timestamp,
    traj,
    last_Tcw: jnp.ndarray,
    last_feats,
    last_lm_id: jnp.ndarray,
    ref_kf,
    ms: MapState,
    min_inliers,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    params: TrackingParams = TrackingParams(),
) -> NormalFrameResult:
    """The whole NORMAL-state tracking frame fused into one program
    (Tracking::_Track_, Tracking.cpp:158): constant-velocity pose prediction
    -> motion-model track -> reference-KF fallback (lax.cond, only computed
    on motion-model failure) -> local-map refinement -> keyframe-decision
    counters. One program instead of 3-4 dispatches with a blocking
    bool()/int() sync after each.

    min_inliers is traced (30 normally, 50 right after relocalization,
    TrackingStateNormal / MIN_INLIERS_RELOC)."""
    from hyslam_tpu.core import trajectory as TJ

    Tcw_pred = TJ.predict_pose(traj, jnp.asarray(timestamp, jnp.float32))
    mm = track_motion_model(
        cam, cur_feats, Tcw_pred, last_feats, last_lm_id, ms,
        min_inliers=params.motion.n_min_matches,
        n_levels=n_levels, scale_factor=scale_factor, p=params.motion,
    )

    def keep_mm(_):
        return mm

    def fallback(_):
        return track_reference_keyframe(
            cam, cur_feats, last_Tcw, ms, ref_kf,
            n_levels=n_levels, scale_factor=scale_factor, p=params.ref_kf,
        )

    init = jax.lax.cond(mm.ok, keep_mm, fallback, None)

    lres = track_local_map(cam, cur_feats, init.Tcw, init.lm_id, ms,
                           n_levels=n_levels, scale_factor=scale_factor,
                           p=params.local_map)
    tr = lres.track
    ok = init.ok & (tr.n_inliers >= min_inliers)

    depth = cur_feats.depth
    has = tr.lm_id >= 0
    close = (depth > 0) & (depth < cam.close_depth)
    # mask the refine-stage counters when initial pose estimation failed:
    # the staged code never ran TrackLocalMap on that path, so telemetry
    # must not report its counts for a lost frame (ADVICE r2)
    scalars = jnp.stack([
        mm.n_inliers.astype(jnp.int32),
        init.ok.astype(jnp.int32),
        jnp.where(init.ok, tr.n_inliers, 0).astype(jnp.int32),
        jnp.where(init.ok, lres.n_local_matches, 0).astype(jnp.int32),
        (close & has).sum().astype(jnp.int32),
        (close & ~has).sum().astype(jnp.int32),
        ok.astype(jnp.int32),
        ms.next_kf.astype(jnp.int32),
    ])
    return NormalFrameResult(
        Tcw=tr.Tcw,
        lm_id=tr.lm_id,
        local_ref_kf=lres.local.ref_kf,
        scalars=scalars,
    )


class DevTrackState(NamedTuple):
    """Device-resident per-frame tracker state for the async tracking loop
    (zero host syncs per frame): everything _do_normal used to keep as host
    numpy — last pose, relative pose to the reference KF, reference ids,
    last-frame features/associations — stays on device, updated by ONE
    program per frame (track_normal_step). The host state machine consumes
    the packed decision scalars asynchronously, `commit_lag` frames later,
    so no device->host fetch blocks the frame loop — the latency analog of
    the reference's tracking-queue depth (System.cc:194 blocks at depth
    2)."""

    last_Tcw: jnp.ndarray      # [4,4] last successfully tracked pose
    last_Tcr: jnp.ndarray      # [4,4] last pose relative to its ref KF
    last_ref_kf: jnp.ndarray   # [] int32
    ref_kf: jnp.ndarray        # [] int32 current reference keyframe
    last_lm_id: jnp.ndarray    # [F] last frame's associations
    last_feats: object         # FrameFeatures of the last good frame


class AsyncStepOut(NamedTuple):
    dev: DevTrackState
    traj: object               # Trajectory after (conditional) append
    scalars: jnp.ndarray       # NormalFrameResult.scalars (int32 [8])
    Tcw: jnp.ndarray           # this frame's optimized pose (garbage if !ok)
    lm_id: jnp.ndarray         # [F] this frame's pruned associations


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale_factor",
                                   "params"))
def track_normal_step(
    cam: Camera,
    cur_feats,
    timestamp,
    traj,
    dev: DevTrackState,
    ms: MapState,
    min_inliers,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    params: TrackingParams = TrackingParams(),
) -> AsyncStepOut:
    """One NORMAL-state frame with the ENTIRE state update on device:
    UpdateLastFrame re-anchoring (Tracking.cpp:249) + track_normal_frame +
    trajectory append + last-frame rollover, all gated on the frame's
    success flag so a lost frame freezes the device state at the last good
    frame (the host discovers the loss from the async scalar fetch and
    transitions the state machine then)."""
    from hyslam_tpu.core import trajectory as TJ

    K = ms.K
    # UpdateLastFrame: re-derive last pose from the (re-optimized) ref KF
    rc = jnp.clip(dev.last_ref_kf, 0, K - 1)
    last_Tcw = jnp.where(dev.last_ref_kf >= 0,
                         dev.last_Tcr @ ms.kf.Tcw[rc], dev.last_Tcw)

    nf = track_normal_frame(
        cam, cur_feats, timestamp, traj, last_Tcw, dev.last_feats,
        dev.last_lm_id, dev.ref_kf, ms, min_inliers,
        n_levels=n_levels, scale_factor=scale_factor, params=params,
    )
    ok = nf.scalars[6] > 0

    ref_new = jnp.where(ok, nf.local_ref_kf, dev.ref_kf)
    ref_pose = ms.kf.Tcw[jnp.clip(ref_new, 0, K - 1)]
    Tcr = nf.Tcw @ se3.inverse(ref_pose)
    traj = TJ.append(traj, jnp.asarray(timestamp, jnp.float32), nf.Tcw,
                     ref_new, ref_pose, ok, commit=ok)

    def keep(new, old):
        return jax.tree.map(lambda a, b: jnp.where(ok, a, b), new, old)

    dev2 = DevTrackState(
        last_Tcw=jnp.where(ok, nf.Tcw, dev.last_Tcw),
        last_Tcr=jnp.where(ok, Tcr, dev.last_Tcr),
        last_ref_kf=jnp.where(ok, ref_new, dev.last_ref_kf),
        ref_kf=ref_new,
        last_lm_id=jnp.where(ok, nf.lm_id, dev.last_lm_id),
        last_feats=keep(cur_feats, dev.last_feats),
    )
    return AsyncStepOut(dev=dev2, traj=traj, scalars=nf.scalars,
                        Tcw=nf.Tcw, lm_id=nf.lm_id)


@partial(jax.jit, static_argnames=("cam", "min_inliers",
                                   "n_levels", "scale_factor", "p"))
def track_local_map(
    cam: Camera,
    cur_feats,
    Tcw0: jnp.ndarray,
    cur_lm_id: jnp.ndarray,
    ms: MapState,
    min_inliers: int = 30,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    p: LocalMapParams = LocalMapParams(),
) -> LocalMapResult:
    """TrackLocalMap::track: build the local map from the frame's current
    matches, harvest its landmarks, projection-match the still-unmatched
    features, then optimize the pose against the enlarged association set."""
    local = build_local_map(ms, cur_lm_id, capacity=p.local_capacity)
    already = cur_lm_id >= 0
    # exclude landmarks already matched in this frame from the search set
    Lloc = local.lm_idx.shape[0]
    cur_set = jnp.zeros((ms.L + 1,), bool).at[
        jnp.where(already, jnp.clip(cur_lm_id, 0, ms.L - 1), ms.L)
    ].set(True, mode="drop")
    fresh = local.lm_valid & ~cur_set[jnp.clip(local.lm_idx, 0, ms.L - 1)]
    res = search_by_projection_landmarks(
        cam, cur_feats, Tcw0,
        local.lm_pos, local.lm_normal, local.lm_desc,
        local.lm_max_dist, local.lm_min_dist, fresh,
        already_matched=already, th=p.match_radius, ratio=p.match_nnratio,
        n_levels=n_levels, scale_factor=scale_factor,
    )
    new_lm = jnp.where(
        res.lm_for_feature >= 0,
        local.lm_idx[jnp.clip(res.lm_for_feature, 0, Lloc - 1)],
        -1,
    )
    lm_id = jnp.where(already, cur_lm_id, new_lm)
    pos_table = ms.lm.pos[jnp.clip(lm_id, 0, ms.L - 1)]
    tr = _optimize_frame_pose(cam, cur_feats, lm_id, pos_table, Tcw0,
                              min_inliers, n_levels, scale_factor)
    return LocalMapResult(track=tr, local=local, n_local_matches=res.n_matches)
