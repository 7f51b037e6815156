"""MapState: fixed-capacity SoA arenas for keyframes, landmarks,
associations, covisibility, spanning tree, and the recursive multi-map table.

This is the functional replacement for the reference's mutex-guarded pointer
graph: Map (src/core/Map.{h,cc}), KeyFrameDB + CovisibilityGraph +
SpanningTree (src/core/KeyFrameDB.*, CovisibilityGraph.*, SpanningTree.*),
and MapPointDB (src/core/MapPointDB.*). All updates are pure functions
MapState -> MapState run under jit; there are no mutexes because there is no
shared mutation (SURVEY.md §2.10 concurrency translation).

Conventions:
- keyframe ids / landmark ids are arena slot indices (int32); -1 = none.
- "bad" entries keep their storage but drop out of every query via masks
  (KeyFrame::setBad / MapPoint::setBad analogs).
- landmark replacement (fuse) is an indirection column `replaced_by`
  resolved by `resolve_landmarks` (MapPoint::replace analog).
- multi-map: each KF/landmark carries a map_id; sub-maps form a tree via
  `map_parent`; a registered sub-map's contents join its parent's queries
  through root-resolution instead of DB splicing (Map::registerWithParent,
  Map.cc:475-481 re-design).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hyslam_tpu.core.frame import FrameFeatures
from hyslam_tpu.ops.hamming import hamming_pairwise

COVIS_THRESHOLD = 15  # min shared landmarks for a covisibility edge
                      # (CovisibilityGraph.h: threshold 15)
MAX_MAPS = 32         # sub-map tree capacity
RECYCLE_DELAY = 2     # mapper passes a freed landmark slot stays
                      # unallocatable (set_landmarks_bad / replace; ticked
                      # down in mapper.cull_landmarks) so stale host-held
                      # indices re-resolve against the bad flag first
MAP_TREE_DEPTH = 8    # max nesting resolved by root()


class KeyFrameArena(NamedTuple):
    Tcw: jnp.ndarray          # [K, 4, 4]
    timestamp: jnp.ndarray    # [K]
    frame_id: jnp.ndarray     # [K] source frame id
    cam_id: jnp.ndarray       # [K] camera index
    map_id: jnp.ndarray       # [K]
    valid: jnp.ndarray        # [K] slot allocated
    bad: jnp.ndarray          # [K] culled
    origin: jnp.ndarray       # [K] map-origin KF (non-erasable, Map.cc origin)
    span_parent: jnp.ndarray  # [K] spanning-tree parent (-1 root)
    Tcp: jnp.ndarray          # [K, 4, 4] pose relative to span_parent frozen
                              # at cull time (KeyFrame::mTcp): a culled KF's
                              # own Tcw stops being optimized, so trajectory
                              # re-anchoring composes Tcp with the LIVE
                              # parent's pose instead (Trajectory.cc:152)
    # per-feature data (padded to F slots)
    uv: jnp.ndarray           # [K, F, 2]
    ur: jnp.ndarray           # [K, F]
    depth: jnp.ndarray        # [K, F]
    level: jnp.ndarray        # [K, F]
    angle: jnp.ndarray        # [K, F]
    desc: jnp.ndarray         # [K, F, 8] uint32
    kp_valid: jnp.ndarray     # [K, F]
    lm_id: jnp.ndarray        # [K, F] feature -> landmark (-1)


class LandmarkArena(NamedTuple):
    pos: jnp.ndarray          # [L, 3]
    normal: jnp.ndarray       # [L, 3] mean viewing direction
    desc: jnp.ndarray         # [L, 8] representative descriptor
    min_dist: jnp.ndarray     # [L] scale-invariance range (MapPointDB)
    max_dist: jnp.ndarray     # [L]
    valid: jnp.ndarray        # [L]
    bad: jnp.ndarray          # [L]
    replaced_by: jnp.ndarray  # [L] fuse indirection (-1)
    protection: jnp.ndarray   # [L] new-point protection countdown
                              # (MapPoint protection counter / LandMarkCuller)
    map_id: jnp.ndarray       # [L]
    first_kf: jnp.ndarray     # [L] creating KF
    n_obs: jnp.ndarray        # [L]
    visible: jnp.ndarray      # [L] tracking "visible" counter
    found: jnp.ndarray        # [L] tracking "found" counter
    # observation list (padded to O slots per landmark)
    obs_kf: jnp.ndarray       # [L, O] keyframe id
    obs_feat: jnp.ndarray     # [L, O] feature slot in that KF
    obs_valid: jnp.ndarray    # [L, O]


class MapTable(NamedTuple):
    """Sub-map tree bookkeeping (recursive multi-map, Map.h:32-34)."""

    parent: jnp.ndarray       # [M] parent map id (-1 root)
    registered: jnp.ndarray   # [M] bool: contents visible to parent queries
    active: jnp.ndarray       # [] int32 active map id (single-active
                              # invariant, Map.cc:452-465)
    Tse3_parent: jnp.ndarray  # [M, 4, 4] tiepoint: child-origin pose in
                              # parent frame (Tse3Parent, Map.h:72-77)
    tie_kf: jnp.ndarray       # [M] parent KF anchoring the tiepoint (-1)
    n_maps: jnp.ndarray       # [] int32 allocation cursor


class MapState(NamedTuple):
    kf: KeyFrameArena
    lm: LandmarkArena
    maps: MapTable
    covis: jnp.ndarray        # [K, K] int32 shared-landmark counts
    next_kf: jnp.ndarray      # [] int32
    next_lm: jnp.ndarray      # [] int32

    @property
    def K(self):
        return self.kf.Tcw.shape[0]

    @property
    def L(self):
        return self.lm.pos.shape[0]

    @property
    def F(self):
        return self.kf.uv.shape[1]

    @property
    def O(self):
        return self.lm.obs_kf.shape[1]


class MapCaps(NamedTuple):
    """Static arena capacities (compile-time shapes)."""

    K: int = 256      # keyframes
    L: int = 16384    # landmarks
    F: int = 1024     # features per keyframe
    O: int = 16       # observations per landmark


def empty_map_state(caps: MapCaps = MapCaps()) -> MapState:
    K, L, F, O = caps.K, caps.L, caps.F, caps.O
    kf = KeyFrameArena(
        Tcw=jnp.tile(jnp.eye(4, dtype=jnp.float32), (K, 1, 1)),
        timestamp=jnp.zeros((K,), jnp.float32),
        frame_id=jnp.full((K,), -1, jnp.int32),
        cam_id=jnp.zeros((K,), jnp.int32),
        map_id=jnp.zeros((K,), jnp.int32),
        valid=jnp.zeros((K,), bool),
        bad=jnp.zeros((K,), bool),
        origin=jnp.zeros((K,), bool),
        span_parent=jnp.full((K,), -1, jnp.int32),
        Tcp=jnp.tile(jnp.eye(4, dtype=jnp.float32), (K, 1, 1)),
        uv=jnp.zeros((K, F, 2), jnp.float32),
        ur=jnp.full((K, F), -1.0, jnp.float32),
        depth=jnp.full((K, F), -1.0, jnp.float32),
        level=jnp.zeros((K, F), jnp.int32),
        angle=jnp.zeros((K, F), jnp.float32),
        desc=jnp.zeros((K, F, 8), jnp.uint32),
        kp_valid=jnp.zeros((K, F), bool),
        lm_id=jnp.full((K, F), -1, jnp.int32),
    )
    lm = LandmarkArena(
        pos=jnp.zeros((L, 3), jnp.float32),
        normal=jnp.zeros((L, 3), jnp.float32),
        desc=jnp.zeros((L, 8), jnp.uint32),
        min_dist=jnp.zeros((L,), jnp.float32),
        max_dist=jnp.full((L,), jnp.inf, jnp.float32),
        valid=jnp.zeros((L,), bool),
        bad=jnp.zeros((L,), bool),
        replaced_by=jnp.full((L,), -1, jnp.int32),
        protection=jnp.zeros((L,), jnp.int32),
        map_id=jnp.zeros((L,), jnp.int32),
        first_kf=jnp.full((L,), -1, jnp.int32),
        n_obs=jnp.zeros((L,), jnp.int32),
        visible=jnp.zeros((L,), jnp.int32),
        found=jnp.zeros((L,), jnp.int32),
        obs_kf=jnp.full((L, O), -1, jnp.int32),
        obs_feat=jnp.full((L, O), -1, jnp.int32),
        obs_valid=jnp.zeros((L, O), bool),
    )
    maps = MapTable(
        parent=jnp.full((MAX_MAPS,), -1, jnp.int32),
        registered=jnp.zeros((MAX_MAPS,), bool),
        active=jnp.asarray(0, jnp.int32),
        Tse3_parent=jnp.tile(jnp.eye(4, dtype=jnp.float32), (MAX_MAPS, 1, 1)),
        tie_kf=jnp.full((MAX_MAPS,), -1, jnp.int32),
        n_maps=jnp.asarray(1, jnp.int32),
    )
    return MapState(
        kf=kf,
        lm=lm,
        maps=maps,
        covis=jnp.zeros((K, K), jnp.int32),
        next_kf=jnp.asarray(0, jnp.int32),
        next_lm=jnp.asarray(0, jnp.int32),
    )


# ---------------------------------------------------------------------------
# multi-map visibility
# ---------------------------------------------------------------------------

def map_root(maps: MapTable, map_id: jnp.ndarray) -> jnp.ndarray:
    """Resolve a map id to its registration root: walk parents while the
    child is registered. Registered sub-maps' contents belong to the parent's
    query scope (replaces recursive DB splicing, Map.cc:475-481)."""
    def step(mid, _):
        reg = maps.registered[jnp.clip(mid, 0, MAX_MAPS - 1)]
        par = maps.parent[jnp.clip(mid, 0, MAX_MAPS - 1)]
        nxt = jnp.where(reg & (par >= 0), par, mid)
        return nxt, None

    out, _ = jax.lax.scan(step, map_id, None, length=MAP_TREE_DEPTH)
    return out


def visible_scope(ms: MapState):
    """(kf_in_scope [K], lm_in_scope [L]) for the active map: entries whose
    registration root equals the active map's registration root."""
    active_root = map_root(ms.maps, ms.maps.active)
    kf_root = map_root(ms.maps, ms.kf.map_id)
    lm_root = map_root(ms.maps, ms.lm.map_id)
    kf_ok = ms.kf.valid & ~ms.kf.bad & (kf_root == active_root)
    lm_ok = ms.lm.valid & ~ms.lm.bad & (lm_root == active_root)
    return kf_ok, lm_ok


# ---------------------------------------------------------------------------
# allocation + association
# ---------------------------------------------------------------------------

def add_keyframe(
    ms: MapState,
    feats: FrameFeatures,
    Tcw: jnp.ndarray,
    timestamp,
    frame_id,
    cam_id,
    lm_assoc: jnp.ndarray,
    origin: bool | jnp.ndarray = False,
):
    """Insert a keyframe at the allocation cursor with its features and the
    frame's landmark associations [F] (-1 = none). Returns (ms, k).

    Mirrors Map::addKeyFrame + ProcessNewKeyFrame's association binding:
    each associated landmark gets an observation (kf, feat) appended and
    n_obs bumped."""
    k = ms.next_kf
    kf = ms.kf
    kf = kf._replace(
        Tcw=kf.Tcw.at[k].set(Tcw),
        timestamp=kf.timestamp.at[k].set(timestamp),
        frame_id=kf.frame_id.at[k].set(frame_id),
        cam_id=kf.cam_id.at[k].set(cam_id),
        map_id=kf.map_id.at[k].set(ms.maps.active),
        valid=kf.valid.at[k].set(True),
        bad=kf.bad.at[k].set(False),
        origin=kf.origin.at[k].set(origin),
        uv=kf.uv.at[k].set(feats.uv),
        ur=kf.ur.at[k].set(feats.ur),
        depth=kf.depth.at[k].set(feats.depth),
        level=kf.level.at[k].set(feats.level),
        angle=kf.angle.at[k].set(feats.angle),
        desc=kf.desc.at[k].set(feats.desc),
        kp_valid=kf.kp_valid.at[k].set(feats.valid),
        lm_id=kf.lm_id.at[k].set(jnp.where(feats.valid, lm_assoc, -1)),
    )
    ms = ms._replace(kf=kf, next_kf=k + 1)
    ms = _append_observations(
        ms, k, jnp.arange(ms.F, dtype=jnp.int32), lm_assoc, feats.valid
    )
    return ms, k


def _append_observations(ms, k, feat_idx, lm_idx, mask):
    """Append (k, feat) to each landmark's observation list (batched; each
    landmark at most once per call). mask selects real associations.

    Masked-out rows are routed to an out-of-bounds index and dropped
    (mode="drop") — clipping them to a real slot would race with genuine
    scatter writes to the same landmark."""
    L, O = ms.L, ms.O
    lm = ms.lm
    safe = jnp.clip(lm_idx, 0, L - 1)
    ok = mask & (lm_idx >= 0)
    free = jnp.argmin(lm.obs_valid, axis=-1)          # [L] first False slot
    has_room = ~jnp.all(lm.obs_valid, axis=-1)
    ok = ok & has_room[safe]
    tgt = jnp.where(ok, safe, L)                       # L => dropped
    slot = free[safe]
    obs_kf = lm.obs_kf.at[tgt, slot].set(k, mode="drop")
    obs_feat = lm.obs_feat.at[tgt, slot].set(feat_idx, mode="drop")
    obs_valid = lm.obs_valid.at[tgt, slot].set(True, mode="drop")
    n_obs = lm.n_obs.at[tgt].add(1, mode="drop")
    return ms._replace(
        lm=lm._replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_valid=obs_valid, n_obs=n_obs)
    )


def add_landmarks(
    ms: MapState,
    pos: jnp.ndarray,        # [N, 3]
    desc: jnp.ndarray,       # [N, 8]
    kf_id,                   # scalar creating keyframe
    feat_idx: jnp.ndarray,   # [N] feature slot in that KF
    mask: jnp.ndarray,       # [N] create or not
    protection: int = 3,
):
    """Batch-allocate landmarks from the cursor and bind them to (kf, feat).
    Returns (ms, lm_indices [N] with -1 where masked out).

    The protection countdown shields new points from the culler for a few
    keyframes (MapPoint protection / LandMarkCuller grace period)."""
    N = pos.shape[0]
    L = ms.L
    lm = ms.lm
    # Allocation policy: VIRGIN slots first (ascending — exactly the
    # monotonic cursor the system was tuned on), recycled slots only when
    # the virgin region is exhausted. A monotonic cursor alone exhausted
    # the arena on long sequences — the 600-frame soak hit the L cap at
    # frame ~120 and every later allocation (incl. re-init seeding)
    # silently failed, so the tracker thrashed REINITIALIZE for the rest
    # of the sequence. But eager reuse measurably degrades tracking (r4
    # regression: dual-camera SLAM inliers dropped ~30% when fresh
    # landmarks landed in recycled low-index slots), so recycled rows are
    # strictly a spill region. A freed (bad) row additionally only
    # becomes allocatable after its RECYCLE_DELAY countdown expires
    # (ticked in mapper.cull_landmarks), so no slot is reallocated in the
    # same integrate pass that freed it and stale host-held indices
    # re-resolve against the bad flag first (ADVICE r4 medium).
    virgin = ~lm.valid
    recycled = lm.valid & lm.bad & (lm.protection <= 0)
    n_free = jnp.sum((virgin | recycled).astype(jnp.int32))
    idx = jnp.arange(L)
    key = jnp.where(virgin, idx, jnp.where(recycled, L + idx, 2 * L + idx))
    order = jnp.argsort(key)
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    ok = mask & (rank < n_free)
    slots = order[jnp.clip(rank, 0, L - 1)]
    tgt = jnp.where(ok, slots, L)  # L => dropped scatter
    lm = lm._replace(
        pos=lm.pos.at[tgt].set(pos, mode="drop"),
        desc=lm.desc.at[tgt].set(desc, mode="drop"),
        valid=lm.valid.at[tgt].set(True, mode="drop"),
        bad=lm.bad.at[tgt].set(False, mode="drop"),
        replaced_by=lm.replaced_by.at[tgt].set(-1, mode="drop"),
        protection=lm.protection.at[tgt].set(protection, mode="drop"),
        map_id=lm.map_id.at[tgt].set(ms.maps.active, mode="drop"),
        first_kf=lm.first_kf.at[tgt].set(kf_id, mode="drop"),
        n_obs=lm.n_obs.at[tgt].set(0, mode="drop"),
        visible=lm.visible.at[tgt].set(1, mode="drop"),
        found=lm.found.at[tgt].set(1, mode="drop"),
        obs_kf=lm.obs_kf.at[tgt].set(-1, mode="drop"),
        obs_feat=lm.obs_feat.at[tgt].set(-1, mode="drop"),
        obs_valid=lm.obs_valid.at[tgt].set(False, mode="drop"),
    )
    ms = ms._replace(lm=lm, next_lm=ms.next_lm + jnp.sum(ok.astype(jnp.int32)))
    out_idx = jnp.where(ok, jnp.clip(slots, 0, L - 1), -1)
    # bind to creating keyframe
    ms = add_associations(ms, kf_id, feat_idx, out_idx, ok)
    return ms, out_idx


def add_associations(ms: MapState, k, feat_idx, lm_idx, mask):
    """Associate (kf k, feature slots) -> landmarks; updates both sides
    (Map::addAssociation analog). Batched over features of one KF."""
    ok = mask & (lm_idx >= 0) & (feat_idx >= 0)
    fi = jnp.where(ok, jnp.clip(feat_idx, 0, ms.F - 1), ms.F)  # F => dropped
    lm_col = ms.kf.lm_id.at[k, fi].set(lm_idx, mode="drop")
    ms = ms._replace(kf=ms.kf._replace(lm_id=lm_col))
    return _append_observations(
        ms, k, jnp.clip(feat_idx, 0, ms.F - 1), jnp.where(ok, lm_idx, -1), ok
    )


def erase_associations(ms: MapState, k, feat_idx, mask):
    """Remove associations for (kf k, feature slots) (Map::eraseAssociation).
    Batched over features of one KF."""
    fi = jnp.clip(feat_idx, 0, ms.F - 1)
    lm_idx = ms.kf.lm_id[k, fi]
    ok = mask & (lm_idx >= 0)
    safe = jnp.clip(lm_idx, 0, ms.L - 1)
    # clear KF side (dropped scatter for masked rows)
    kf_lm = ms.kf.lm_id.at[k, jnp.where(ok, fi, ms.F)].set(-1, mode="drop")
    # clear LM side: find matching obs slot
    lm = ms.lm
    match = (lm.obs_kf[safe] == k) & lm.obs_valid[safe]     # [N, O]
    slot = jnp.argmax(match, axis=-1)
    found = jnp.any(match, axis=-1) & ok
    tgt = jnp.where(found, safe, ms.L)
    obs_valid = lm.obs_valid.at[tgt, slot].set(False, mode="drop")
    n_obs = lm.n_obs.at[tgt].add(-1, mode="drop")
    return ms._replace(
        kf=ms.kf._replace(lm_id=kf_lm),
        lm=lm._replace(obs_valid=obs_valid, n_obs=n_obs),
    )


def erase_observations(ms: MapState, lm_rows: jnp.ndarray, slots: jnp.ndarray,
                       mask: jnp.ndarray) -> MapState:
    """Remove specific (landmark, obs-slot) observations and the matching
    KF-side references (outlier erasure after BA,
    LocalBundleAdjustment.cc:154-198)."""
    L, O = ms.L, ms.O
    ok = mask & (lm_rows >= 0) & (slots >= 0)
    lr = jnp.clip(lm_rows, 0, L - 1)
    sl = jnp.clip(slots, 0, O - 1)
    ok = ok & ms.lm.obs_valid[lr, sl]
    kf_i = ms.lm.obs_kf[lr, sl]
    feat_i = ms.lm.obs_feat[lr, sl]
    tgt_l = jnp.where(ok, lr, L)
    lm = ms.lm._replace(
        obs_valid=ms.lm.obs_valid.at[tgt_l, sl].set(False, mode="drop"),
        n_obs=ms.lm.n_obs.at[tgt_l].add(-1, mode="drop"),
    )
    tgt_k = jnp.where(ok, jnp.clip(kf_i, 0, ms.K - 1), ms.K)
    kf = ms.kf._replace(
        lm_id=ms.kf.lm_id.at[tgt_k, jnp.clip(feat_i, 0, ms.F - 1)].set(
            -1, mode="drop"
        )
    )
    return ms._replace(lm=lm, kf=kf)


def kf_features(ms: MapState, k):
    """View keyframe k's stored features as a FrameFeatures bundle (for
    matching kernels that operate on frames)."""
    kc = jnp.clip(jnp.asarray(k), 0, ms.K - 1)
    return FrameFeatures(
        uv=ms.kf.uv[kc],
        ur=ms.kf.ur[kc],
        depth=ms.kf.depth[kc],
        level=ms.kf.level[kc],
        angle=ms.kf.angle[kc],
        desc=ms.kf.desc[kc],
        valid=ms.kf.kp_valid[kc],
    )


def camera_centers(ms: MapState) -> jnp.ndarray:
    """[K, 3] world-frame camera centers of all keyframes."""
    R = ms.kf.Tcw[:, :3, :3]
    t = ms.kf.Tcw[:, :3, 3]
    return -jnp.einsum("kji,kj->ki", R, t)


def n_live_landmarks(ms: MapState) -> jnp.ndarray:
    """Count of live landmarks (valid & not bad). With slot recycling,
    next_lm counts cumulative allocations — not map size — so telemetry
    and exports report this instead (ADVICE r4)."""
    return jnp.sum((ms.lm.valid & ~ms.lm.bad).astype(jnp.int32))


def resolve_landmarks(ms: MapState, lm_idx: jnp.ndarray) -> jnp.ndarray:
    """Follow one step of replacement indirection and mask bad/invalid
    landmarks to -1 (MapPoint::replace consumers)."""
    idx = jnp.clip(lm_idx, 0, ms.L - 1)
    rep = ms.lm.replaced_by[idx]
    idx2 = jnp.where((lm_idx >= 0) & (rep >= 0), rep, lm_idx)
    idx2c = jnp.clip(idx2, 0, ms.L - 1)
    ok = (idx2 >= 0) & ms.lm.valid[idx2c] & ~ms.lm.bad[idx2c]
    return jnp.where(ok, idx2, -1)


# ---------------------------------------------------------------------------
# covisibility + spanning tree
# ---------------------------------------------------------------------------

def incidence_matrix(ms: MapState) -> jnp.ndarray:
    """[K, L] bool: keyframe k observes landmark l (from the KF-side
    association columns)."""
    K, L = ms.K, ms.L
    lm_id = ms.kf.lm_id                      # [K, F]
    ok = (lm_id >= 0) & ms.kf.kp_valid & ms.kf.valid[:, None] & ~ms.kf.bad[:, None]
    tgt = jnp.clip(lm_id, 0, L - 1)
    I = jnp.zeros((K, L), bool)
    rows = jnp.broadcast_to(jnp.arange(K)[:, None], lm_id.shape)
    return I.at[rows, tgt].max(ok)


@jax.jit
def refresh_covisibility(ms: MapState) -> MapState:
    """Recompute the full covisibility weight matrix with one matmul:
    covis = I @ I^T over the association incidence. Replaces the reference's
    incremental symmetric edge bookkeeping (CovisibilityGraph.cc) with one
    dense product over the whole arena instead of scattered updates."""
    I = incidence_matrix(ms).astype(jnp.bfloat16)
    lm_ok = (ms.lm.valid & ~ms.lm.bad).astype(jnp.bfloat16)
    I = I * lm_ok[None, :]
    covis = jax.lax.dot_general(
        I, I, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)
    covis = covis - jnp.diag(jnp.diag(covis))  # no self-edges
    return ms._replace(covis=covis)


def covis_neighbors(ms: MapState, k, n_best: int, min_weight: int = COVIS_THRESHOLD):
    """Top-n covisible neighbor ids + weights of keyframe k (ordered-
    neighbor cache analog, GetBestCovisibilityKeyFrames)."""
    w = jnp.where(ms.kf.valid & ~ms.kf.bad, ms.covis[k], 0)
    w = jnp.where(w >= min_weight, w, 0)
    top_w, top_i = jax.lax.top_k(w, n_best)
    return jnp.where(top_w > 0, top_i, -1), top_w


@jax.jit
def compute_spanning_parents(ms: MapState) -> MapState:
    """Spanning tree: parent of k = the earlier keyframe sharing the most
    landmarks (SpanningTree.h policy: attach to max-covis predecessor)."""
    K = ms.K
    idx = jnp.arange(K)
    earlier = idx[None, :] < idx[:, None]
    ok = earlier & (ms.kf.valid & ~ms.kf.bad)[None, :]
    w = jnp.where(ok, ms.covis, -1)
    best = jnp.argmax(w, axis=-1)
    has = jnp.max(w, axis=-1) > 0
    live = ms.kf.valid & ~ms.kf.bad
    # recompute parents for LIVE keyframes only. A culled KF's
    # (span_parent, Tcp) pair was frozen together at cull time
    # (set_keyframes_bad) and is the only way trajectory re-anchoring can
    # recover its frames' poses; zeroing it here left every frame whose
    # reference KF was later culled permanently stuck at its pre-loop pose
    # (measured: ~1.26 m frozen spikes after an otherwise clean closure).
    parent = jnp.where(live, jnp.where(has, best, -1), ms.kf.span_parent)
    return ms._replace(kf=ms.kf._replace(span_parent=parent.astype(jnp.int32)))


# ---------------------------------------------------------------------------
# landmark statistics (MapPointDB::update analogs)
# ---------------------------------------------------------------------------

@jax.jit
def update_landmark_stats(ms: MapState) -> MapState:
    """Recompute normals, distance-invariance ranges, and representative
    descriptors for all landmarks in one batched pass.

    - normal: mean of unit vectors from observing camera centers to the point
      (MapPointDBEntry::updateNormalAndDepth)
    - min/max dist: from mean distance and the observing levels' scale span
    - descriptor: the observation descriptor minimizing total Hamming
      distance to the other observations (min-median in the reference,
      MapPointDBEntry::computeDistinctiveDescriptor; min-sum is the batched
      equivalent)
    """
    L, O = ms.L, ms.O
    kf_ok = jnp.clip(ms.lm.obs_kf, 0, ms.K - 1)
    feat_ok = jnp.clip(ms.lm.obs_feat, 0, ms.F - 1)
    ov = ms.lm.obs_valid
    Twc = ms.kf.Tcw[kf_ok]                                  # [L,O,4,4] world->cam
    R = Twc[..., :3, :3]
    t = Twc[..., :3, 3]
    centers = -jnp.einsum("...ji,...j->...i", R, t)         # camera centers [L,O,3]
    vec = ms.lm.pos[:, None, :] - centers
    dist = jnp.linalg.norm(vec, axis=-1)
    unit = vec / jnp.maximum(dist[..., None], 1e-9)
    wsum = jnp.maximum(jnp.sum(ov, axis=-1), 1)
    normal = jnp.sum(jnp.where(ov[..., None], unit, 0.0), axis=1) / wsum[:, None]

    # distance range from the last (reference) observation's level
    levels = ms.kf.level[kf_ok, feat_ok]                    # [L,O]
    scale = 1.2 ** levels.astype(jnp.float32)
    mean_dist = jnp.sum(jnp.where(ov, dist, 0.0), axis=-1) / wsum
    ref_scale = jnp.sum(jnp.where(ov, scale, 0.0), axis=-1) / wsum
    max_dist = mean_dist * ref_scale
    min_dist = max_dist / (1.2 ** 8)

    # representative descriptor: min total Hamming among observations
    descs = ms.kf.desc[kf_ok, feat_ok]                      # [L,O,8]
    d = hamming_pairwise(descs[:, :, None, :], descs[:, None, :, :])  # [L,O,O]
    pairmask = ov[:, :, None] & ov[:, None, :]
    tot = jnp.sum(jnp.where(pairmask, d, 0), axis=-1) + jnp.where(ov, 0, 1 << 20)
    best = jnp.argmin(tot, axis=-1)
    best_desc = jnp.take_along_axis(
        descs, best[:, None, None].astype(jnp.int32).repeat(8, -1), axis=1
    )[:, 0]
    has_obs = jnp.any(ov, axis=-1)
    lm = ms.lm._replace(
        normal=jnp.where(has_obs[:, None], normal, ms.lm.normal),
        min_dist=jnp.where(has_obs, min_dist, ms.lm.min_dist),
        max_dist=jnp.where(has_obs, max_dist, ms.lm.max_dist),
        desc=jnp.where(has_obs[:, None], best_desc, ms.lm.desc),
    )
    return ms._replace(lm=lm)


# ---------------------------------------------------------------------------
# bad-marking / replacement
# ---------------------------------------------------------------------------

def set_landmarks_bad(ms: MapState, bad_mask: jnp.ndarray) -> MapState:
    """Mark landmarks bad and detach them from all keyframes (setBad +
    eraseAssociation sweep). bad_mask: [L]."""
    bad_mask = bad_mask & ms.lm.valid
    lm = ms.lm._replace(
        bad=ms.lm.bad | bad_mask,
        obs_valid=ms.lm.obs_valid & ~bad_mask[:, None],
        n_obs=jnp.where(bad_mask, 0, ms.lm.n_obs),
        # a bad row's slot becomes recyclable (add_landmarks free-list)
        # only after RECYCLE_DELAY further mapper passes: stale host-held
        # indices must observe the bad flag before the slot can alias
        protection=jnp.where(bad_mask, RECYCLE_DELAY, ms.lm.protection),
    )
    # clear KF-side references
    ref = jnp.clip(ms.kf.lm_id, 0, ms.L - 1)
    hit = (ms.kf.lm_id >= 0) & bad_mask[ref]
    kf = ms.kf._replace(lm_id=jnp.where(hit, -1, ms.kf.lm_id))
    return ms._replace(lm=lm, kf=kf)


def replace_landmarks(ms: MapState, src: jnp.ndarray, dst: jnp.ndarray,
                      mask: jnp.ndarray) -> MapState:
    """Fuse: each src landmark is replaced by dst (keeps dst, marks src bad,
    rewrites KF references; Map::replaceMapPoint / MapPointDB::replace).

    src, dst, mask: [N] batched; observation lists of dst are NOT merged here
    — the caller re-binds via add_associations where feature slots allow
    (matches the fuser's re-matching behavior)."""
    ok = mask & (src >= 0) & (dst >= 0) & (src != dst)
    L = ms.L
    srcc = jnp.where(ok, jnp.clip(src, 0, L - 1), L)  # L => dropped scatter
    # redirect
    repl = ms.lm.replaced_by.at[srcc].set(dst, mode="drop")
    bad = ms.lm.bad.at[srcc].set(True, mode="drop")
    obs_valid = ms.lm.obs_valid.at[srcc].set(False, mode="drop")
    # rewrite KF-side references src -> dst via a full indirection gather
    table = jnp.arange(L, dtype=jnp.int32)
    table = table.at[srcc].set(dst, mode="drop")
    kf_ref = ms.kf.lm_id
    kf_new = jnp.where(kf_ref >= 0, table[jnp.clip(kf_ref, 0, L - 1)], kf_ref)
    prot = ms.lm.protection.at[srcc].set(RECYCLE_DELAY, mode="drop")
    lm = ms.lm._replace(replaced_by=repl, bad=bad, obs_valid=obs_valid,
                        protection=prot)
    return ms._replace(lm=lm, kf=ms.kf._replace(lm_id=kf_new))


def set_keyframes_bad(ms: MapState, bad_mask: jnp.ndarray) -> MapState:
    """Cull keyframes: mark bad, drop their observations from landmarks,
    and reparent spanning-tree children to the grandparent
    (KeyFrameDB::erase + SpanningTree::handleSetBad, KeyFrameDB.cc:149-161).
    Origin keyframes are never erased (Map origin non-erasability)."""
    bad_mask = bad_mask & ms.kf.valid & ~ms.kf.origin
    K = ms.K
    # landmark side: invalidate obs rows pointing at culled KFs
    obs_kfc = jnp.clip(ms.lm.obs_kf, 0, K - 1)
    drop = ms.lm.obs_valid & bad_mask[obs_kfc]
    n_drop = jnp.sum(drop.astype(jnp.int32), axis=-1)
    lm = ms.lm._replace(
        obs_valid=ms.lm.obs_valid & ~drop,
        n_obs=jnp.maximum(ms.lm.n_obs - n_drop, 0),
    )
    # spanning tree: child of bad kf -> grandparent (one sweep per call;
    # chains of simultaneously-culled KFs resolve over MAP_TREE_DEPTH steps)
    par = ms.kf.span_parent

    def lift(p, _):
        pc = jnp.clip(p, 0, K - 1)
        p2 = jnp.where((p >= 0) & bad_mask[pc], par[pc], p)
        return p2, None

    new_par, _ = jax.lax.scan(lift, par, None, length=MAP_TREE_DEPTH)
    # freeze each newly-culled KF's pose relative to its (lifted, live)
    # parent: Tcp = Tcw_bad @ Tcw_parent^-1 — later optimization moves the
    # parent, and trajectory re-anchoring recovers the culled frame's pose
    # as Tcp @ Tcw_parent (KeyFrame::mTcp semantics)
    from hyslam_tpu.geometry import se3 as _se3

    own_par = jnp.clip(new_par, 0, K - 1)
    Tcp_new = ms.kf.Tcw @ _se3.inverse(ms.kf.Tcw[own_par])
    freeze = bad_mask & (new_par >= 0)
    Tcp = jnp.where(freeze[:, None, None], Tcp_new, ms.kf.Tcp)
    # a PREVIOUSLY-culled KF whose frozen parent is culled NOW re-anchors
    # through it: Tcp' = Tcp o Tcp_new[parent] (its lifted span_parent
    # already points at the parent's live ancestor)
    par0 = ms.kf.span_parent
    p0c = jnp.clip(par0, 0, K - 1)
    inherit = ms.kf.bad & (par0 >= 0) & bad_mask[p0c]
    Tcp = jnp.where(inherit[:, None, None], ms.kf.Tcp @ Tcp_new[p0c], Tcp)
    kf = ms.kf._replace(
        bad=ms.kf.bad | bad_mask,
        lm_id=jnp.where(bad_mask[:, None], -1, ms.kf.lm_id),
        span_parent=new_par,
        Tcp=Tcp,
    )
    return ms._replace(kf=kf, lm=lm)


# ---------------------------------------------------------------------------
# sub-map tree
# ---------------------------------------------------------------------------

def create_submap(ms: MapState, set_active: bool = True):
    """Allocate a child of the active map and optionally make it active
    (Map::createSubMap, Map.cc:50). Returns (ms, new_map_id)."""
    mid = ms.maps.n_maps
    maps = ms.maps._replace(
        parent=ms.maps.parent.at[mid].set(ms.maps.active),
        registered=ms.maps.registered.at[mid].set(False),
        n_maps=mid + 1,
        active=jnp.where(set_active, mid, ms.maps.active),
    )
    return ms._replace(maps=maps), mid


def register_submap(ms: MapState, map_id, Tse3_parent=None, tie_kf=-1) -> MapState:
    """Register a sub-map with its parent: its KFs/landmarks join parent
    queries (root resolution) and the tiepoint transform feeds BA residuals
    (Map::registerWithParent re-design)."""
    maps = ms.maps._replace(
        registered=ms.maps.registered.at[map_id].set(True),
    )
    if Tse3_parent is not None:
        maps = maps._replace(
            Tse3_parent=maps.Tse3_parent.at[map_id].set(Tse3_parent),
            tie_kf=maps.tie_kf.at[map_id].set(tie_kf),
        )
    return ms._replace(maps=maps)


def set_active_map(ms: MapState, map_id) -> MapState:
    return ms._replace(maps=ms.maps._replace(active=jnp.asarray(map_id, jnp.int32)))


def refresh_tiepoints(ms: MapState) -> MapState:
    """Re-measure every registered submap's tiepoint from the CURRENT poses
    (Tse3_parent = Tcw_origin @ Tcw_tie^-1). Used after a loop closure has
    re-placed submaps: the loop evidence supersedes the reinit-time
    extrapolated placement, and a stale tiepoint prior would drag global BA
    back toward it."""
    from hyslam_tpu.geometry import se3 as _se3

    maps = ms.maps
    n = int(np.asarray(maps.n_maps)) if not isinstance(
        maps.n_maps, int) else maps.n_maps
    Tse3 = maps.Tse3_parent
    reg = np.asarray(maps.registered)
    ties = np.asarray(maps.tie_kf)
    origin = np.asarray(ms.kf.origin & ms.kf.valid)
    kf_map = np.asarray(ms.kf.map_id)
    for m in range(min(n, MAX_MAPS)):
        if not reg[m] or ties[m] < 0:
            continue
        child = np.nonzero(origin & (kf_map == m))[0]
        if len(child) == 0:
            continue
        T = ms.kf.Tcw[int(child[0])] @ _se3.inverse(ms.kf.Tcw[int(ties[m])])
        Tse3 = Tse3.at[m].set(T)
    return ms._replace(maps=maps._replace(Tse3_parent=Tse3))


def apply_transform_to_map(ms: MapState, map_id, T: jnp.ndarray) -> MapState:
    """Rigidly move every KF pose and landmark of one sub-map:
    Tcw' = Tcw @ T^-1, X' = T X  (Initializer::transformMapSE3 /
    MapPoint::applyTransform analog for submap placement)."""
    from hyslam_tpu.geometry import se3

    Tinv = se3.inverse(T)
    in_map_kf = ms.kf.valid & (ms.kf.map_id == map_id)
    in_map_lm = ms.lm.valid & (ms.lm.map_id == map_id)
    new_Tcw = jnp.where(
        in_map_kf[:, None, None], ms.kf.Tcw @ Tinv, ms.kf.Tcw
    )
    new_pos = jnp.where(in_map_lm[:, None], se3.apply(T, ms.lm.pos), ms.lm.pos)
    return ms._replace(
        kf=ms.kf._replace(Tcw=new_Tcw), lm=ms.lm._replace(pos=new_pos)
    )
