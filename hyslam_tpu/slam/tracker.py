"""Per-camera tracking: the state machine + per-frame orchestration.

Replaces the Tracking thread (src/main/Tracking.cpp) and the tracking state
classes (src/slam/tracking/TrackingState*.cpp): a host-side state machine
(control flow is cheap scalar logic, SURVEY.md §7.1) dispatching the jitted
strategies in hyslam_tpu.slam.strategies. States and transitions follow
Tracking_datastructs.h:21-30 and TrackingStateTransitionReinit.cpp:79-146:

  INITIALIZE -> POSTINIT (5 forced-KF frames) -> NORMAL
  NORMAL --loss--> REINITIALIZE (stereo SLAM: new registered submap at the
                   velocity-extrapolated pose) or RELOCALIZE (mono/other)
  NULL: imaging cameras while the SLAM camera is lost
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hyslam_tpu.core import mapstate as M
from hyslam_tpu.core import trajectory as TJ
from hyslam_tpu.core.frame import FrameFeatures
from hyslam_tpu.core.mapstate import MapCaps, MapState, empty_map_state
from hyslam_tpu.geometry import se3
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.slam.initializers import stereo_initialize
from hyslam_tpu.slam.keyframe_policy import (
    KeyFramePolicyParams,
    KFDecisionInputs,
    need_new_keyframe,
    seed_close_landmarks,
)
from hyslam_tpu.slam.mapper import Mapper
from hyslam_tpu.slam.strategies import (
    DevTrackState,
    TrackResult,
    track_normal_frame,
    track_normal_step,
)
from hyslam_tpu.slam.tracking_params import TrackingParams


class State(enum.Enum):
    """eTrackingState analog (Tracking_datastructs.h:21-30)."""

    NO_IMAGES_YET = 0
    INITIALIZE = 1
    POSTINIT = 2
    NORMAL = 3
    RELOCALIZE = 4
    REINITIALIZE = 5
    NULL = 6


POSTINIT_FRAMES = 5          # TrackingStatePostInitialization hold
# back-compat aliases; the live thresholds come from TrackingParams.normal
MIN_INLIERS_NORMAL = 30      # TrackLocalMap success threshold
MIN_INLIERS_RELOC = 50       # stricter right after relocalization


@partial(jax.jit, static_argnames=("cam", "is_mono"))
def _insert_keyframe_device(ms, feats, Tcw, lm_id, timestamp, frame_id,
                            cam_id, cam, is_mono: bool):
    """KF insertion + close-point seeding as one dispatch-only program for
    the async tracking loop (TrackingState::createNewKeyFrame,
    TrackingState.cpp:20-93): no host scalars are produced — the keyframe
    id is the map's allocation cursor, which the host mirrors exactly."""
    ms, k = M.add_keyframe(ms, feats, Tcw, timestamp, frame_id, cam_id,
                           lm_id)
    if not is_mono:
        ms, _ = seed_close_landmarks(ms, k, cam)
    return ms


@dataclass
class _Pending:
    """One dispatched-but-uncommitted frame of the async tracking loop:
    device handles for everything the lagged host decisions need."""

    frame_id: int
    timestamp: float
    state_name: str
    force_kf: bool
    feats: object          # FrameFeatures (device)
    scalars: object        # int32 [8] (async D2H in flight)
    Tcw: object            # [4,4] device
    lm_id: object          # [F] device
    sensor_data: object = None


@dataclass
class TrackerTelemetry:
    """Per-frame TSV telemetry row (tracking_data.txt analog,
    Tracking.cpp:51-55)."""

    frame_id: int = 0
    state: str = ""
    n_motion: int = 0
    n_inliers: int = 0
    n_local: int = 0
    kf_inserted: int = -1
    n_seeded: int = 0
    mapper_stats: dict = field(default_factory=dict)  # per-KF job counters
                              # (localmapping_data.txt row, Mapping.cpp:46-48)


@dataclass
class Tracker:
    cam: Camera
    cam_id: int = 0
    caps: MapCaps = MapCaps()
    is_mono: bool = False
    policy: KeyFramePolicyParams = field(default_factory=KeyFramePolicyParams)
    reset_interval: int = 0   # forced-loss fault injection
                              # (TrackingStateNormal.cpp:78-82)
    opt_info: object = None   # OptimizerInfo for sensor-prior weights in
                              # local BA (optParams, Mapping.cpp)
    n_levels: int = 8         # pyramid model of this camera's extractor
    scale_factor: float = 1.2  # (FeatureExtractorSettings sigma2 model)
    params: TrackingParams = field(default_factory=TrackingParams)
                              # per-camera state/strategy parameter sets
                              # (Tracking_datastructs.h:32-181 via the
                              # Cameras/States/Strategies YAML indirection)
    commit_lag: int = 2       # async loop: frames a dispatched frame's host
                              # decisions trail behind (hides the D2H round
                              # trip; the reference's tracking queue blocks
                              # at depth 2, System.cc:194 — same latency)
    mapper_busy_frames: int = 2
                              # async loop: frames the (device-queued) mapper
                              # integration of the last keyframe is assumed
                              # to occupy — the keyframe policy's
                              # mapping-idle gate (optional KFs are
                              # suppressed while mapping is busy,
                              # TrackingStateNormal.cpp:87-170); the
                              # threaded pipeline measures this for real,
                              # the async loop estimates it host-side.
                              # 2, not 4: with the commit-lag decision
                              # latency on top, a 4-frame suppression let
                              # fast turns starve the map before the next
                              # keyframe could replenish it (measured
                              # sawtooth-to-loss on the KITTI-layout
                              # circuit; 2 holds 90/90 frames)
    on_keyframe: object = None
                              # async loop: callable(kf_id) invoked after a
                              # deferred keyframe insertion — System routes
                              # these to the loop-closing worker thread
                              # (the reference's LoopClosing thread feed,
                              # System.cc:145)
    mapping_status: object = None
                              # threaded-pipeline hook (runtime.pipeline):
                              # .idle() / .queue_len() feed the KF policy's
                              # mapping-idle inputs; .sync(tracker) blocks
                              # until the mapper drains and its output map
                              # is adopted BEFORE a keyframe is inserted —
                              # the functional-state analog of the
                              # reference's accepting-input protocol
                              # (InterThread.h:37-89, System.cc:194)

    def __post_init__(self):
        from hyslam_tpu.core.sensordata import empty_sensor_arena

        # fault injection configured through the params tree
        # (reset_interval, TrackingStateNormal.cpp:78-82); the explicit
        # Tracker.reset_interval field still wins when set
        if not self.reset_interval and self.params.normal.reset_interval > 0:
            self.reset_interval = self.params.normal.reset_interval

        self.ms: MapState = empty_map_state(self.caps)
        self.sensors = empty_sensor_arena(self.caps.K)
        self._pending_sensor = None   # SensorData for the current frame
        self.traj = TJ.empty_trajectory()
        self.mapper = Mapper(self.cam, is_mono=self.is_mono,
                             n_levels=self.n_levels,
                             scale_factor=self.scale_factor)
        self.state = State.INITIALIZE
        self.last_feats: Optional[FrameFeatures] = None
        self.last_lm_id = None
        self.last_Tcw = np.eye(4, dtype=np.float32)
        self.last_Tcr = np.eye(4, dtype=np.float32)
        self.last_ref_kf = -1
        self.ref_kf = -1
        self.last_kf_frame_id = -(10**6)
        self.postinit_left = 0
        self.frames_since_reloc = 10**6
        self.n_frames = 0
        self.telemetry: list[TrackerTelemetry] = []
        # async tracking loop (zero host syncs per steady-state frame)
        self._pending: deque[_Pending] = deque()
        self._dev: Optional[DevTrackState] = None
        self._kf_mirror = 0       # host mirror of ms.next_kf (exact: every
                                  # allocation is a host-visible event)
        self._has_priors = False  # sensor readings / registered submaps
                                  # exist -> local BA needs the prior path

    # -- public -------------------------------------------------------------

    def track(self, feats: FrameFeatures, timestamp: float, frame_id: int,
              sensor_data=None):
        """Process one frame; returns TrackerTelemetry. sensor_data
        (core.sensordata.SensorData) is attached to the keyframe if one is
        inserted for this frame (SensorData rides Frame->KeyFrame in the
        reference, System.cc:179-222)."""
        tel = TrackerTelemetry(frame_id=frame_id, state=self.state.name)
        self.n_frames += 1
        self._pending_sensor = sensor_data
        if self.state == State.NULL:
            pass
        elif self.state == State.INITIALIZE:
            self._do_initialize(feats, timestamp, frame_id, tel)
        elif self.state in (State.NORMAL, State.POSTINIT):
            self._do_normal(feats, timestamp, frame_id, tel)
        elif self.state == State.REINITIALIZE:
            self._do_reinitialize(feats, timestamp, frame_id, tel)
        elif self.state == State.RELOCALIZE:
            self._do_relocalize(feats, timestamp, frame_id, tel)
        self.telemetry.append(tel)
        return tel

    @property
    def current_Tcw(self):
        return self.last_Tcw

    # -- states -------------------------------------------------------------

    def _do_initialize(self, feats, timestamp, frame_id, tel,
                       Tcw0=None, as_submap=False, tie_kf=-1):
        if self.mapping_status is not None:
            # drain + adopt the mapper's map BEFORE allocating init/reinit
            # keyframes — inserting on a stale snapshot would be silently
            # discarded at the next adoption, leaving ref_kf/last_lm_id
            # pointing at unallocated arena slots (ADVICE r3 medium;
            # mirrors the need_new_keyframe sync in _do_normal)
            self.mapping_status.sync(self)
        if self.is_mono:
            from hyslam_tpu.slam.mono_init import MonoInitializer  # lazy
            if not hasattr(self, "_mono_init"):
                self._mono_init = MonoInitializer(self.cam)
            done, ms, kf_ids = self._mono_init.feed(
                self.ms, feats, timestamp, frame_id, self.cam_id
            )
            self.ms = ms
            if not done:
                return
            kf_id = kf_ids[-1]
            self.last_Tcw = np.asarray(self.ms.kf.Tcw[kf_id])
        else:
            ms_before = self.ms   # roll back the submap on failed init —
                                  # otherwise every blank/featureless frame
                                  # in REINITIALIZE leaks an empty submap
            if as_submap and int(np.asarray(
                    self.ms.maps.n_maps)) >= M.MAX_MAPS:
                # submap table full (bounded capacity): re-initialize
                # within the active map instead of silently clamping the
                # table scatter (a map_id past MAX_MAPS poisons every
                # host-side table walk downstream)
                as_submap = False
            if as_submap:
                self.ms, submap = M.create_submap(self.ms)
            ms, kf_id, n = stereo_initialize(
                self.ms, feats, self.cam, timestamp, frame_id, self.cam_id,
                Tcw0=None if Tcw0 is None else jnp.asarray(Tcw0),
            )
            if kf_id < 0:
                self.ms = ms_before
                return
            self.ms = ms
            if as_submap:
                # register immediately with a tiepoint: measurement
                # Tse3 = Tcw_origin @ Tcw_parent^-1 so that
                # pose_this = Tse3 * pose_parent (Map.h:75,
                # TrackingStateReInitialize.cpp:59)
                if tie_kf >= 0:
                    Tcw_child = np.asarray(self.ms.kf.Tcw[int(kf_id)])
                    Tcw_par = np.asarray(self.ms.kf.Tcw[int(tie_kf)])
                    tse3 = (Tcw_child @ np.linalg.inv(Tcw_par)).astype(
                        np.float32)
                else:
                    tse3 = np.eye(4, dtype=np.float32)
                self.ms = M.register_submap(
                    self.ms, submap,
                    Tse3_parent=jnp.asarray(tse3), tie_kf=tie_kf,
                )
                self._has_priors = True   # tiepoint edges exist now
            tel.n_seeded = n
            self.last_Tcw = np.asarray(self.ms.kf.Tcw[kf_id]) if Tcw0 is None \
                else np.asarray(Tcw0, dtype=np.float32)
        self.ref_kf = int(kf_id)
        self.last_ref_kf = int(kf_id)
        self.last_Tcr = np.eye(4, dtype=np.float32)
        self.last_kf_frame_id = frame_id
        self.last_feats = feats
        self.last_lm_id = self.ms.kf.lm_id[int(kf_id)]
        self.traj = TJ.append(
            self.traj, timestamp, jnp.asarray(self.last_Tcw), int(kf_id),
            self.ms.kf.Tcw[int(kf_id)], True,
        )
        self.state = State.POSTINIT
        self.postinit_left = POSTINIT_FRAMES
        tel.kf_inserted = int(kf_id)
        if self._pending_sensor is not None:
            from hyslam_tpu.core.sensordata import set_sensor

            self.sensors = set_sensor(self.sensors, int(kf_id),
                                      self._pending_sensor)
            self._has_priors = True

    def _update_last_frame(self):
        """UpdateLastFrame (Tracking.cpp:249): re-derive the last frame's
        pose from its (possibly re-optimized) reference keyframe."""
        if self.last_ref_kf >= 0:
            ref_pose = np.asarray(self.ms.kf.Tcw[self.last_ref_kf])
            self.last_Tcw = (self.last_Tcr @ ref_pose).astype(np.float32)

    def _do_normal(self, feats, timestamp, frame_id, tel):
        self._update_last_frame()
        # fault injection: forced tracking loss every reset_interval frames
        if self.reset_interval and self.n_frames % self.reset_interval == 0:
            self._lose_tracking()
            tel.state += ">FORCED_LOSS"
            return

        # one fused device program for the whole frame (motion model +
        # reference-KF fallback + local-map refinement + decision counters,
        # Tracking::_Track_), then ONE host sync of the packed counters
        min_inl = (
            self.params.normal.thresh_refine_postreloc
            if self.frames_since_reloc < 30
            else self.params.normal.thresh_refine
        )
        nf = track_normal_frame(
            self.cam, feats, timestamp, self.traj,
            jnp.asarray(self.last_Tcw), self.last_feats, self.last_lm_id,
            self.ref_kf, self.ms, jnp.asarray(min_inl, jnp.int32),
            n_levels=self.n_levels, scale_factor=self.scale_factor,
            params=self.params,
        )
        (n_motion, init_ok, n_inliers, n_local, n_tracked_close,
         n_nontracked_close, ok, n_kfs) = (int(x) for x in np.asarray(nf.scalars))
        tel.n_motion = n_motion
        tel.n_inliers = n_inliers
        tel.n_local = n_local
        if not (init_ok and ok):
            self._lose_tracking()
            return

        tr = TrackResult(Tcw=nf.Tcw, lm_id=nf.lm_id,
                         n_inliers=jnp.asarray(n_inliers), ok=jnp.asarray(True))
        Tcw = np.asarray(nf.Tcw)
        self.ref_kf = int(nf.local_ref_kf)

        # keyframe decision
        force = self.state == State.POSTINIT
        idle, qlen = True, 0
        if self.mapping_status is not None:
            idle = bool(self.mapping_status.idle())
            qlen = int(self.mapping_status.queue_len())
        inp = KFDecisionInputs(
            n_inliers=n_inliers,
            frame_id=frame_id,
            last_kf_frame_id=self.last_kf_frame_id,
            n_kfs_in_map=n_kfs,
            n_tracked_close=n_tracked_close,
            n_nontracked_close=n_nontracked_close,
            mapping_idle=idle,
            mapping_queue_len=qlen,
            is_mono=self.is_mono,
            force=force,
        )
        kf_id = -1
        if need_new_keyframe(inp, self.policy):
            if self.mapping_status is not None:
                # drain the mapper and adopt its map before inserting, so
                # keyframe insertions form a linear chain (a second KF on a
                # stale snapshot would be lost at adoption)
                self.mapping_status.sync(self)
            kf_id = self._insert_keyframe(feats, tr, timestamp, frame_id, tel)

        # trajectory append (relative to the reference keyframe)
        ref = kf_id if kf_id >= 0 else self.ref_kf
        ref_pose = self.ms.kf.Tcw[ref]
        self.traj = TJ.append(
            self.traj, timestamp, jnp.asarray(Tcw), ref, ref_pose, True
        )
        self.last_Tcw = Tcw
        self.last_Tcr = (Tcw @ np.asarray(se3.inverse(ref_pose))).astype(np.float32)
        self.last_ref_kf = int(ref)
        self.last_feats = feats
        self.last_lm_id = tr.lm_id
        self.frames_since_reloc += 1
        if self.state == State.POSTINIT:
            self.postinit_left -= 1
            if self.postinit_left <= 0:
                self.state = State.NORMAL

    def _insert_keyframe(self, feats, tr, timestamp, frame_id, tel) -> int:
        if int(np.asarray(self.ms.next_kf)) >= self.caps.K:
            return -1   # arena full: the scatter would silently clamp
        ms, kf_id = M.add_keyframe(
            self.ms, feats, jnp.asarray(tr.Tcw), timestamp, frame_id,
            self.cam_id, tr.lm_id,
        )
        kf_id = int(kf_id)
        if not self.is_mono:
            ms, n_seeded = seed_close_landmarks(ms, kf_id, self.cam)
            tel.n_seeded = int(n_seeded)
        ms, stats = self.mapper.integrate_keyframe(
            ms, kf_id, sensors=self.sensors, opt_info=self.opt_info)
        tel.mapper_stats = stats
        self.ms = ms
        if self._pending_sensor is not None:
            from hyslam_tpu.core.sensordata import set_sensor

            self.sensors = set_sensor(self.sensors, kf_id,
                                      self._pending_sensor)
            self._has_priors = True
        self.last_kf_frame_id = frame_id
        self.ref_kf = kf_id
        tel.kf_inserted = kf_id
        return kf_id

    # -- async tracking loop --------------------------------------------------
    #
    # The device-queue answer to the reference's thread pipeline: a
    # synchronous per-frame state machine waits on a device->host fetch
    # every frame, so the host and the device never overlap. track_async
    # dispatches ONE fused device program per frame (track_normal_step keeps
    # all tracker state device-resident), starts an async D2H of the packed
    # decision scalars, and commits the host decisions (loss transition,
    # keyframe policy, telemetry) `commit_lag` frames later when the fetch
    # has landed — the same decision latency the reference's bounded
    # tracking queue imposes (System.cc:194 blocks at depth 2).

    def track_async(self, feats: FrameFeatures, timestamp: float,
                    frame_id: int, sensor_data=None):
        """Dispatch-only tracking for NORMAL/POSTINIT; cold states (init,
        reinit, relocalize) drain the pending window and run synchronously.
        Telemetry rows appear in self.telemetry at commit time."""
        if self.state in (State.NORMAL, State.POSTINIT):
            self.n_frames += 1
            if self.reset_interval and self.n_frames % self.reset_interval == 0:
                # fault injection is a host event: take the sync path
                self.drain_pending()
                if self.state in (State.NORMAL, State.POSTINIT):
                    self._sync_dev_to_host()
                    self._lose_tracking()
                    self.telemetry.append(TrackerTelemetry(
                        frame_id=frame_id, state="NORMAL>FORCED_LOSS"))
                return None
            self._ensure_dev()
            min_inl = (
                self.params.normal.thresh_refine_postreloc
                if self.frames_since_reloc < 30
                else self.params.normal.thresh_refine
            )
            out = track_normal_step(
                self.cam, feats, jnp.asarray(timestamp, jnp.float32),
                self.traj, self._dev, self.ms,
                jnp.asarray(min_inl, jnp.int32),
                n_levels=self.n_levels, scale_factor=self.scale_factor,
                params=self.params,
            )
            self.traj = out.traj
            self._dev = out.dev
            try:
                out.scalars.copy_to_host_async()
            except Exception:
                pass
            self._pending.append(_Pending(
                frame_id=frame_id, timestamp=timestamp,
                state_name=self.state.name,
                force_kf=self.state == State.POSTINIT,
                feats=feats, scalars=out.scalars, Tcw=out.Tcw,
                lm_id=out.lm_id, sensor_data=sensor_data,
            ))
            while len(self._pending) > self.commit_lag:
                self._commit_one()
            return None
        # cold path: commit everything in flight, then run synchronously
        self.drain_pending()
        return self.track(feats, timestamp, frame_id,
                          sensor_data=sensor_data)

    def drain_pending(self):
        """Commit every dispatched-but-unresolved frame (System.flush /
        before any cold-state or map-reading operation)."""
        while self._pending:
            self._commit_one()

    def _ensure_dev(self):
        """Enter async mode: lift the host tracker state onto the device
        (one-time cold sync of the keyframe-cursor mirror)."""
        if self._dev is not None:
            return
        F = self.caps.F
        lm = (self.last_lm_id if self.last_lm_id is not None
              else jnp.full((F,), -1, jnp.int32))
        self._dev = DevTrackState(
            last_Tcw=jnp.asarray(self.last_Tcw, jnp.float32),
            last_Tcr=jnp.asarray(self.last_Tcr, jnp.float32),
            last_ref_kf=jnp.asarray(int(self.last_ref_kf), jnp.int32),
            ref_kf=jnp.asarray(int(self.ref_kf), jnp.int32),
            last_lm_id=jnp.asarray(lm, jnp.int32),
            last_feats=self.last_feats,
        )
        self._kf_mirror = int(np.asarray(self.ms.next_kf))

    def _sync_dev_to_host(self):
        """Leave async mode: pull the device tracker state back into the
        host fields the cold-state handlers read (blocking; cold path)."""
        if self._dev is None:
            return
        d = self._dev
        self.last_Tcw = np.asarray(d.last_Tcw)
        self.last_Tcr = np.asarray(d.last_Tcr)
        self.last_ref_kf = int(np.asarray(d.last_ref_kf))
        self.ref_kf = int(np.asarray(d.ref_kf))
        self.last_lm_id = d.last_lm_id
        self.last_feats = d.last_feats
        self._dev = None

    def _commit_one(self):
        """Resolve the oldest pending frame: read its (async-fetched)
        decision scalars and run the host state machine for it — loss
        transition, keyframe policy, telemetry (Tracking::_Track_'s
        decisions, `commit_lag` frames late)."""
        p = self._pending.popleft()
        s = np.asarray(p.scalars)
        tel = TrackerTelemetry(
            frame_id=p.frame_id, state=p.state_name,
            n_motion=int(s[0]), n_inliers=int(s[2]), n_local=int(s[3]))
        self.telemetry.append(tel)
        ok = bool(s[1]) and bool(s[6])
        if not ok:
            # the remaining in-flight frames tracked against the frozen
            # last-good device state; if the tail re-acquired, the blip
            # heals without a state transition — otherwise transition as
            # the reference would have at the first failure
            recovered = False
            while self._pending:
                q = self._pending.popleft()
                sq = np.asarray(q.scalars)
                self.telemetry.append(TrackerTelemetry(
                    frame_id=q.frame_id, state=q.state_name,
                    n_motion=int(sq[0]), n_inliers=int(sq[2]),
                    n_local=int(sq[3])))
                recovered = bool(sq[1]) and bool(sq[6])
            if not recovered:
                self._sync_dev_to_host()
                self._lose_tracking()
                tel.state += ">LOST"
            return tel

        self.frames_since_reloc += 1
        if self.state == State.POSTINIT:
            self.postinit_left -= 1
            if self.postinit_left <= 0:
                self.state = State.NORMAL

        if self.mapping_status is not None:
            idle = bool(self.mapping_status.idle())
            qlen = int(self.mapping_status.queue_len())
        else:
            # estimate mapper occupancy from the last insertion: its
            # integration is queued on the device stream for roughly
            # mapper_busy_frames frames
            busy = (p.frame_id
                    < self.last_kf_frame_id + self.mapper_busy_frames)
            idle, qlen = not busy, int(busy)
        inp = KFDecisionInputs(
            n_inliers=int(s[2]),
            frame_id=p.frame_id,
            last_kf_frame_id=self.last_kf_frame_id,
            n_kfs_in_map=int(s[7]),
            n_tracked_close=int(s[4]),
            n_nontracked_close=int(s[5]),
            mapping_idle=idle,
            mapping_queue_len=qlen,
            is_mono=self.is_mono,
            force=p.force_kf,
        )
        if need_new_keyframe(inp, self.policy) \
                and self._kf_mirror < self.caps.K:
            # arena-full guard: the cursor is monotonic, a 65th insert
            # into K=64 would silently clamp on device while the host
            # mirror (and the place recognizer) ran past the capacity
            self._insert_keyframe_deferred(p, tel)
        return tel

    def _insert_keyframe_deferred(self, p: _Pending, tel):
        """Dispatch-only keyframe insertion + mapper integration for a
        committed frame (its features/pose/associations are still device-
        resident in the pending record). The keyframe id is the host mirror
        of the allocation cursor — no fetch needed."""
        kf_id = self._kf_mirror
        ms = _insert_keyframe_device(
            self.ms, p.feats, p.Tcw, p.lm_id,
            jnp.asarray(p.timestamp, jnp.float32),
            jnp.asarray(p.frame_id, jnp.int32),
            jnp.asarray(self.cam_id, jnp.int32),
            self.cam, self.is_mono)
        self._kf_mirror += 1
        if p.sensor_data is not None:
            from hyslam_tpu.core.sensordata import set_sensor

            self.sensors = set_sensor(self.sensors, kf_id, p.sensor_data)
            self._has_priors = True
        ms, stats = self.mapper.integrate_keyframe(
            ms, jnp.asarray(kf_id, jnp.int32), sensors=self.sensors,
            opt_info=self.opt_info, fetch_stats=False,
            has_priors=self._has_priors)
        self.ms = ms
        self.last_kf_frame_id = p.frame_id
        tel.kf_inserted = kf_id
        tel.mapper_stats = stats
        if self.on_keyframe is not None:
            self.on_keyframe(kf_id)

    def _lose_tracking(self):
        """Transition on loss (TrackingStateTransitionReinit.cpp:79-146):
        stereo SLAM reinitializes a registered submap; mono relocalizes."""
        self.state = State.RELOCALIZE if self.is_mono else State.REINITIALIZE

    def reenter_initialize(self):
        """Re-enter INITIALIZE without discarding the existing map (accessory
        camera recovering from NULL, TrackingStateTransitionReinit.cpp:
        101-119 / TrackingStateInitialize.cpp:34-41): the new initialization
        happens in a fresh private submap so the previous map keeps its
        single origin/gauge. The submap stays unregistered (no pose relation
        to the parent is known yet) until imaging BA aligns + registers it
        via the SLAM trajectory (slam.imaging.align_submaps_to_trajectory);
        until then global BA holds its origin fixed."""
        self.state = State.INITIALIZE
        if hasattr(self, "_mono_init"):
            self._mono_init.ref = None   # pre-loss frame is stale
        if int(np.asarray(self.ms.next_kf)) == 0:
            return  # nothing in the map yet: plain first init
        # reuse an empty active submap left by a previous failed re-entry
        active = int(np.asarray(self.ms.maps.active))
        in_active = np.asarray(self.ms.kf.valid
                               & (self.ms.kf.map_id == active))
        if active != 0 and not in_active.any():
            return
        if int(np.asarray(self.ms.maps.n_maps)) >= M.MAX_MAPS:
            return  # submap table full: keep current map (bounded capacity)
        self.ms, _ = M.create_submap(self.ms)

    def _do_reinitialize(self, feats, timestamp, frame_id, tel):
        """TrackingStateReInitialize: new registered submap placed at the
        velocity-extrapolated pose, tied to the last reference KF."""
        Tcw0 = np.asarray(TJ.predict_pose(self.traj, jnp.asarray(timestamp)))
        self._do_initialize(
            feats, timestamp, frame_id, tel,
            Tcw0=Tcw0, as_submap=True, tie_kf=self.last_ref_kf,
        )
        if self.state == State.POSTINIT:
            tel.state += ">REINIT_OK"

    def _do_relocalize(self, feats, timestamp, frame_id, tel):
        from hyslam_tpu.slam.relocalization import try_relocalize  # lazy
        # recognizer (BoW place recognition) is injected by System once the
        # vocabulary exists; candidate ranking falls back to dense
        # descriptor-set similarity without it
        ok, Tcw, lm_id, n = try_relocalize(
            self.cam, feats, self.ms,
            recognizer=getattr(self, "recognizer", None),
            n_levels=self.n_levels, scale_factor=self.scale_factor,
            p=self.params.place_rec)
        tel.n_inliers = n
        if not ok:
            return
        self.last_Tcw = np.asarray(Tcw)
        self.last_Tcr = np.eye(4, dtype=np.float32)
        self.last_feats = feats
        self.last_lm_id = lm_id
        self.frames_since_reloc = 0
        self.state = State.NORMAL
        tel.state += ">RELOC_OK"
