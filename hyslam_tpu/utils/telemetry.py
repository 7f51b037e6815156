"""Structured run telemetry: TSV logs + stage timing + device profiling.

Capability parity with the reference's observability (SURVEY.md §5):

- tracking TSV log `tracking_data.txt` with one row per frame — camera,
  frame id, state, init method result, inlier/match counts, map sizes and
  the keyframe-insertion outcome (schema from Tracking.cpp:51-55 and
  TrackingStateNormal::needNewKeyFrame:124-168).
- mapping TSV log `localmapping_data.txt` with per-keyframe job counters —
  culled / triangulated / fused landmark counts, BA cost, culled KFs
  (LandMarkCuller.cpp:52, LandMarkTriangulator.cpp:201, LandMarkFuser.cpp:108).
- stage timers replacing the reference's ad-hoc std::chrono spans
  (ImageProcessing.cpp:112-114, Tracking.cpp:151-153) with accumulating
  statistics and optional `jax.profiler` trace annotations so spans show up
  in device profiles (the reference's dead NVTX flag, tests/CMakeLists.txt:20,
  done properly).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import IO

TRACKING_COLUMNS = [
    "camera", "frame_id", "timestamp", "state", "n_motion", "n_inliers",
    "n_local", "kf_inserted", "n_seeded", "n_kfs", "n_landmarks",
]

MAPPING_COLUMNS = [
    "camera", "kf_id", "culled", "triangulated", "fused", "fuse_added",
    "ba_cost", "kf_culled",
]


class _TSVLog:
    def __init__(self, path: str, columns: list[str]):
        self.path = path
        self.columns = columns
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: IO = open(path, "w")
        self._f.write("\t".join(columns) + "\n")

    def write_row(self, **values) -> None:
        row = [str(values.get(c, "")) for c in self.columns]
        self._f.write("\t".join(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TrackingLog(_TSVLog):
    """`run_data/tracking_data.txt` analog."""

    def __init__(self, path: str = "run_data/tracking_data.txt"):
        super().__init__(path, TRACKING_COLUMNS)

    def log(self, camera: str, tel, timestamp: float = 0.0,
            n_kfs: int = 0, n_landmarks: int = 0) -> None:
        """tel: slam.tracker.TrackerTelemetry."""
        self.write_row(
            camera=camera, frame_id=tel.frame_id, timestamp=timestamp,
            state=tel.state, n_motion=tel.n_motion, n_inliers=tel.n_inliers,
            n_local=tel.n_local, kf_inserted=tel.kf_inserted,
            n_seeded=tel.n_seeded, n_kfs=n_kfs, n_landmarks=n_landmarks,
        )


class MappingLog(_TSVLog):
    """`run_data/localmapping_data.txt` analog."""

    def __init__(self, path: str = "run_data/localmapping_data.txt"):
        super().__init__(path, MAPPING_COLUMNS)

    def log(self, camera: str, kf_id: int, stats: dict) -> None:
        """stats: the dict returned by Mapper.integrate_keyframe."""
        self.write_row(camera=camera, kf_id=kf_id, **{
            k: stats.get(k, "") for k in MAPPING_COLUMNS[2:]
        })


@dataclass
class StageTimer:
    """Accumulating wall-clock spans per pipeline stage.

    with timer.span("extract"): ...   # also emits a jax.profiler
                                      # TraceAnnotation when tracing
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        try:
            import jax.profiler as _prof
            ann = _prof.TraceAnnotation(name)
        except Exception:  # pragma: no cover - profiler unavailable
            ann = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ann:
            yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return 1e3 * self.totals.get(name, 0.0) / max(n, 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name}: n={self.counts[name]} total={self.totals[name]:.3f}s "
                f"mean={self.mean_ms(name):.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace around a block (view with
    TensorBoard / xprof). The proper replacement for the reference's dead
    NVTX hooks."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
