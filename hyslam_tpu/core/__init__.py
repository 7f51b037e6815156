"""Core data model: SoA arena arrays replacing the reference's pointer graph
(src/core: Frame/KeyFrame/MapPoint/Map/KeyFrameDB/MapPointDB/Trajectory).

Design (SURVEY.md §7.1): KeyFrames and landmarks live in fixed-capacity
arrays with integer ids + validity masks; "bad"/"replaced"/"protected"
become mask/indirection columns; the covisibility graph is a dense [K, K]
weight matrix recomputed by one matmul; associations are stored on both
sides (kf.lm_id per feature slot, lm obs list) by pure functional updates.
"""

from hyslam_tpu.core.frame import FrameFeatures, Frame  # noqa: F401
from hyslam_tpu.core.mapstate import MapState, MapCaps, empty_map_state  # noqa: F401
