"""Dual-camera imaging pipeline: frame placement + imaging bundle adjustment.

Replaces the reference's flagship dual-camera machinery:

- ImagingFramePlacer (util/ImagingFramePlacer.{h,cpp}): place candidate
  imaging frames via the SLAM trajectory + rig transform, keep a frame when
  its landmark overlap with the previously retained keyframe drops below a
  threshold (default 0.8) and enough landmarks are visible (>= 20).
- ImagingBundleAdjustment (optimizers/ImagingBundleAdjustment.cc +
  the custom g2o types in sba_accessory_cam.h): per-submap Horn Sim3
  alignment of imaging keyframe centers against trajectory-predicted
  centers, submap registration, then a BA in which each imaging keyframe
  pose is tied to trajectory.poseAtTime(t_i) composed with the rig
  transform Tcam — with the times t_i and Tcam themselves optimizable
  (VertexTrajectoryTime / EdgeTime / EdgeTcam /
  EdgeTrajectoryTimeTransformtoSE3).

array-native translation: the trajectory-tie multi-edge becomes an
ALTERNATING scheme — (a) reprojection BA over (poses, landmarks) with unary
SE3 anchor residuals pulling each pose toward Tcam o T_traj(t_i), assembled
straight into the reduced camera system; (b) a differentiable refit of
(t_i, Tcam) through the SE3-interpolated trajectory (pose_at_time is
jax-differentiable, so the time vertex is just a scalar parameter).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hyslam_tpu.core import mapstate as M
from hyslam_tpu.core import trajectory as TJ
from hyslam_tpu.core.mapstate import MapState
from hyslam_tpu.geometry import se3, sim3
from hyslam_tpu.geometry.camera import Camera, in_image, project
from hyslam_tpu.geometry.horn import horn_sim3
from hyslam_tpu.slam.global_ba import build_global_problem
from hyslam_tpu.solver.ba import _backsub, _linearize, _solve_poses, _robust_cost


# ---------------------------------------------------------------------------
# ImagingFramePlacer
# ---------------------------------------------------------------------------

class ImagingFramePlacer:
    """Online imaging-frame selection (ImagingFramePlacer.h:24-47):
    place via SLAM trajectory + rig transform, keep when overlap with the
    last retained frame < threshold and >= min landmarks are visible."""

    def __init__(self, cam: Camera, overlap_threshold: float = 0.8,
                 min_visible: int = 20):
        self.cam = cam
        self.overlap_threshold = overlap_threshold
        self.min_visible = min_visible
        self._last_visible_set: set[int] | None = None

    def place(self, slam_traj, timestamp: float, Tcam: jnp.ndarray):
        """Pose the imaging frame: Tcw = Tcam o T_slam(t)."""
        T, ok = TJ.pose_at_time(slam_traj, jnp.asarray([timestamp]))
        Tcw = (Tcam @ T[0]) if Tcam is not None else T[0]
        return Tcw, bool(ok[0])

    def visible_landmarks(self, ms: MapState, Tcw) -> np.ndarray:
        """Frustum + distance-invariance visibility (the same landmark
        criteria the matcher applies: dist in [0.8 min, 1.2 max])."""
        lm_ok = np.asarray(ms.lm.valid & ~ms.lm.bad)
        uv, z = project(self.cam, se3.apply(Tcw, ms.lm.pos))
        center = se3.translation(se3.inverse(Tcw))
        dist = np.asarray(jnp.linalg.norm(ms.lm.pos - center, axis=-1))
        mn = np.asarray(ms.lm.min_dist)
        mx = np.asarray(ms.lm.max_dist)
        vis = (
            np.asarray(in_image(self.cam, uv) & (z > 0.2)) & lm_ok
            & (dist >= 0.8 * mn) & (dist <= 1.2 * mx)
        )
        return np.nonzero(vis)[0]

    def should_keep(self, ms: MapState, slam_traj, timestamp: float,
                    Tcam) -> tuple[bool, jnp.ndarray]:
        Tcw, ok = self.place(slam_traj, timestamp, Tcam)
        if not ok:
            return False, Tcw
        vis = self.visible_landmarks(ms, Tcw)
        if len(vis) < self.min_visible:
            return False, Tcw
        if self._last_visible_set is None:
            self._last_visible_set = set(vis.tolist())
            return True, Tcw
        inter = len(self._last_visible_set & set(vis.tolist()))
        overlap = inter / max(len(vis), 1)
        if overlap < self.overlap_threshold:
            self._last_visible_set = set(vis.tolist())
            return True, Tcw
        return False, Tcw


# ---------------------------------------------------------------------------
# similarity pre-alignment (DetermineSimilarityTransforms)
# ---------------------------------------------------------------------------

def align_submaps_to_trajectory(ms: MapState, cam: Camera, slam_traj,
                                Tcam) -> MapState:
    """Per sub-map Horn Sim3 of imaging KF centers vs trajectory-predicted
    centers, applied + registered (ImagingBundleAdjustment.cc:37-55,
    162-200)."""
    n_maps = int(np.asarray(ms.maps.n_maps))
    kf_ok = np.asarray(ms.kf.valid & ~ms.kf.bad)
    map_ids = np.asarray(ms.kf.map_id)
    ts = np.asarray(ms.kf.timestamp)
    centers = np.asarray(M.camera_centers(ms))
    for mid in range(n_maps):
        sel = np.nonzero(kf_ok & (map_ids == mid))[0]
        if len(sel) < 3:
            continue
        T_pred, ok = TJ.pose_at_time(slam_traj, jnp.asarray(ts[sel]))
        if Tcam is not None:
            T_pred = jnp.einsum("ij,njk->nik", Tcam, T_pred)
        ok = np.asarray(ok)
        if ok.sum() < 3:
            continue
        pred_centers = np.asarray(se3.translation(se3.inverse(T_pred)))
        g = horn_sim3(
            jnp.asarray(centers[sel][ok]), jnp.asarray(pred_centers[ok])
        )
        # apply as an SE3+scale to the submap (scale folds into positions)
        s, R, t = sim3.unpack(g)
        Tmap = se3.from_Rt(R, t)
        # scale first: X' = s * X around origin, then rigid
        in_kf = jnp.asarray(kf_ok & (map_ids == mid))
        in_lm = ms.lm.valid & (ms.lm.map_id == mid)
        pos = jnp.where(in_lm[:, None], ms.lm.pos * s, ms.lm.pos)
        Tcw_scaled = ms.kf.Tcw.at[:, :3, 3].multiply(
            jnp.where(in_kf, s, 1.0)[:, None]
        )
        ms = ms._replace(
            kf=ms.kf._replace(Tcw=Tcw_scaled), lm=ms.lm._replace(pos=pos)
        )
        ms = M.apply_transform_to_map(ms, mid, Tmap)
        ms = M.register_submap(ms, mid)
    return ms


# ---------------------------------------------------------------------------
# trajectory-tied bundle adjustment
# ---------------------------------------------------------------------------

def _anchor_blocks(kf_Tcw, anchors, weight, movable):
    """Unary SE3 anchor residual r = log(T_anchor T^-1) per keyframe:
    contributes w * J^T J to Hpp and w * J^T r to b (J approximated by -I in
    the left tangent — exact at r = 0, standard weak-prior linearization)."""
    r = jax.vmap(lambda a, t: se3.log(a @ se3.inverse(t)))(anchors, kf_Tcw)
    w = weight * movable.astype(kf_Tcw.dtype)
    Hpp_extra = w[:, None, None] * jnp.eye(6, dtype=kf_Tcw.dtype)
    b_extra = w[:, None] * r            # -J^T r with J = -I
    return Hpp_extra, b_extra, r


@partial(jax.jit, static_argnames=("n_iters", "chunk"))
def _trajectory_tied_ba(prob, anchors, anchor_w, n_iters: int = 10,
                        chunk: int = 256, lam0: float = 1e-4):
    movable = ~prob.kf_fixed

    def total_cost(kf_Tcw, lm_pos):
        c = _robust_cost(prob, kf_Tcw, lm_pos, True)
        r = jax.vmap(lambda a, t: se3.log(a @ se3.inverse(t)))(anchors, kf_Tcw)
        c = c + jnp.sum(anchor_w * movable * jnp.sum(r * r, -1))
        return c

    def step(state, _):
        kf_Tcw, lm_pos, lam, cost = state
        Hpp, b_pose, S_red, b_red, Vinv, Wlo, b_lm, kf_idx = _linearize(
            prob, kf_Tcw, lm_pos, lam, prob.obs.valid, True, chunk
        )
        Ha, ba, _ = _anchor_blocks(kf_Tcw, anchors, anchor_w, movable)
        Hpp = Hpp + Ha
        b_pose = b_pose + ba
        dp = _solve_poses(Hpp, b_pose, S_red, b_red, prob.kf_fixed, lam)
        dl = _backsub(Vinv, Wlo, b_lm, kf_idx, dp, prob.lm_valid)
        kf_new = se3.exp(dp) @ kf_Tcw
        kf_new = jnp.where(prob.kf_fixed[:, None, None], kf_Tcw, kf_new)
        lm_new = lm_pos + dl
        new_cost = total_cost(kf_new, lm_new)
        accept = new_cost < cost
        return (
            jnp.where(accept, kf_new, kf_Tcw),
            jnp.where(accept, lm_new, lm_pos),
            jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4),
            jnp.minimum(new_cost, cost),
        ), None

    init = (prob.kf_Tcw, prob.lm_pos, jnp.asarray(lam0), total_cost(
        prob.kf_Tcw, prob.lm_pos))
    (kf_Tcw, lm_pos, _, cost), _ = jax.lax.scan(step, init, None, length=n_iters)
    return kf_Tcw, lm_pos, cost


@partial(jax.jit, static_argnames=("n_iters",))
def _refit_times_and_rig(traj: TJ.Trajectory, kf_Tcw, kf_ts, kf_ok,
                         Tcam0, n_iters: int = 20):
    """Optimize per-KF trajectory times and the shared rig transform to
    best explain the current imaging poses:
      min sum_k || log( (Tcam o T_traj(t_k)) Tcw_k^-1 ) ||^2
    — gradient descent through the differentiable SE3 interpolation (the
    VertexTrajectoryTime/EdgeTcam translation)."""
    w = kf_ok.astype(jnp.float32)

    def loss(params):
        dt, xi_cam = params
        Tcam = se3.exp(xi_cam) @ Tcam0
        Tq, _ = TJ.pose_at_time(traj, kf_ts + dt)
        pred = jnp.einsum("ij,njk->nik", Tcam, Tq)
        r = jax.vmap(lambda a, t: se3.log(a @ se3.inverse(t)))(pred, kf_Tcw)
        return jnp.sum(w[:, None] * r * r)

    params = (jnp.zeros_like(kf_ts), jnp.zeros(6))
    lr_t, lr_c = 1e-3, 1e-2

    def gd(params, _):
        g = jax.grad(loss)(params)
        return (params[0] - lr_t * g[0], params[1] - lr_c * g[1]), None

    params, _ = jax.lax.scan(gd, params, None, length=n_iters)
    dt, xi_cam = params
    return dt, se3.exp(xi_cam) @ Tcam0, loss(params)


def run_imaging_ba(ms: MapState, cam: Camera, slam_traj, Tcam,
                   anchor_weight: float = 1.0e4, rounds: int = 2) -> MapState:
    """Full imaging finalization (System::RunImagingBundleAdjustment):
    align + register sub-maps, then alternate trajectory-tied BA with
    (time, rig) refitting."""
    import jax.numpy as jnp

    Tcam0 = jnp.eye(4) if Tcam is None else jnp.asarray(Tcam)
    ms = align_submaps_to_trajectory(ms, cam, slam_traj, Tcam0)

    kf_ok = ms.kf.valid & ~ms.kf.bad
    kf_ts = ms.kf.timestamp
    dt = jnp.zeros_like(kf_ts)
    Tcam_cur = Tcam0
    for _ in range(rounds):
        # anchors from current (t, Tcam)
        Tq, okq = TJ.pose_at_time(slam_traj, kf_ts + dt)
        anchors = jnp.einsum("ij,njk->nik", Tcam_cur, Tq)
        prob = build_global_problem(ms, cam)
        # gauge comes from the trajectory anchors, not a fixed origin KF
        # (the reference's imaging BA likewise frees all imaging poses and
        # constrains them through the trajectory-time edges)
        prob = prob._replace(kf_fixed=~(ms.kf.valid & ~ms.kf.bad))
        anchor_w = anchor_weight * (kf_ok & okq).astype(jnp.float32)
        kf_Tcw, lm_pos, cost = _trajectory_tied_ba(prob, anchors, anchor_w)
        ms = ms._replace(
            kf=ms.kf._replace(
                Tcw=jnp.where((~prob.kf_fixed)[:, None, None], kf_Tcw,
                              ms.kf.Tcw)
            ),
            lm=ms.lm._replace(
                pos=jnp.where(prob.lm_valid[:, None], lm_pos, ms.lm.pos)
            ),
        )
        dt, Tcam_cur, _ = _refit_times_and_rig(
            slam_traj, ms.kf.Tcw, kf_ts, kf_ok, Tcam_cur
        )
    ms = M.update_landmark_stats(ms)
    return ms
