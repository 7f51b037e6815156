"""Benchmark: the full SLAM system rate on one device at the reference's
SLAM-camera operating point (1280x720 stereo @ 1000 ORB features, 8 pyramid
levels x1.2 — config/sample_primary_config_file.yaml:27-41).

The headline metric is `system_fps`: frames/s of the FULL
System.track_stereo path — image preprocessing + batched stereo ORB
extraction + stereo matching + the tracking state machine + keyframe
insertion + ALL mapper jobs (triangulation / fusion / culling / local BA /
KF culling) on a rendered sequence, with every dispatched frame actually
executed (System.flush() before the clock stops). The production driver is
the async tracking loop (SystemConfig.async_tracking): one fused device
program per frame, no synchronous device->host fetch in steady state, host
decisions committed commit_lag frames later from an async scalar fetch
(the reference's tracking queue imposes the same decision latency,
System.cc:194).

`frontend_fps` is the rate of the fused per-frame front-end program over a
pose-CHAINED loop (each step consumes the previous step's pose, so no step
can be skipped) ending in a real fetch.

The reference publishes no fps (BASELINE.md); baseline = its real-time
design rate of 60 fps on CPU, so vs_baseline = system_fps / 60.

Prints ONE JSON line; exits 1 when a phase fails.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _render_sequence(n_total):
    import jax.numpy as jnp
    from helpers import render_world
    from hyslam_tpu.geometry import se3
    from hyslam_tpu.geometry.camera import Camera

    H, W = 720, 1280
    cam = Camera(fx=700.0, fy=700.0, cx=W / 2, cy=H / 2, width=W, height=H,
                 bf=84.0, th_depth=35.0)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-14, 14, 4000), rng.uniform(-9, 9, 4000),
                    rng.uniform(3, 45, 4000)], -1).astype(np.float32)
    T_r_off = np.asarray(se3.from_Rt(
        jnp.eye(3), jnp.asarray([-cam.baseline, 0.0, 0.0])))
    frames = []
    T = np.eye(4, dtype=np.float32)
    for _ in range(n_total):
        il, _, _ = render_world(cam, T, pts)
        ir, _, _ = render_world(cam, (T_r_off @ T).astype(np.float32), pts)
        frames.append((il, ir))
        delta = np.asarray(se3.exp(jnp.asarray(
            [0, 0.002, 0, 0, 0, -0.08], dtype=jnp.float32)))
        T = (delta @ T).astype(np.float32)
    return cam, frames


def bench_system_fps(n_warm: int = 24, n_timed: int = 60) -> float:
    """Frames/s of the full System.track_stereo path (async production
    driver), pipeline drained inside the timed window."""
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from hyslam_tpu.core.mapstate import MapCaps
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.io.config import CameraConfig, SystemConfig
    from hyslam_tpu.slam.system import System

    cam, frames = _render_sequence(n_warm + n_timed)
    cc = CameraConfig(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        width=cam.width, height=cam.height, bf=cam.bf,
        extractor=ExtractorConfig(n_features=1000, n_levels=8),
    )
    sysm = System(SystemConfig(
        cameras={"SLAM": cc}, caps=MapCaps(K=64, L=16384, F=1024, O=8),
        enable_loop_closing=False,
        async_tracking=True, commit_lag=2,
    ))
    for i in range(n_warm):
        sysm.track_stereo(*frames[i], timestamp=0.05 * i, frame_id=i)
    sysm.flush()                       # drain compiles out of the timing
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_timed):
        sysm.track_stereo(*frames[i], timestamp=0.05 * i, frame_id=i)
    sysm.flush()                       # all dispatched work must execute
    dt = time.perf_counter() - t0
    return n_timed / dt


def bench_frontend_fps(n_timed: int = 60) -> float:
    """Frames/s of the fused per-frame front-end program
    (slam.frontend.track_stereo_frame: batched stereo extraction + stereo
    match + local-map projection + pose-only LM), pose-CHAINED so every
    step must execute; ends in a real device->host fetch."""
    import jax
    import jax.numpy as jnp
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.geometry.camera import Camera
    from hyslam_tpu.slam.frontend import track_stereo_frame

    H, W = 720, 1280
    N_LANDMARKS = 4096
    cam = Camera(fx=700.0, fy=700.0, cx=W / 2, cy=H / 2, width=W, height=H,
                 bf=84.0)
    cfg = ExtractorConfig(n_features=1000)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(0, 255, (4, 2, H, W)).astype(np.float32))
    lm_pos = jnp.asarray(np.stack(
        [rng.uniform(-8, 8, N_LANDMARKS), rng.uniform(-5, 5, N_LANDMARKS),
         rng.uniform(3, 30, N_LANDMARKS)], -1).astype(np.float32))
    lm_desc = jnp.asarray(
        rng.integers(0, 2**32, (N_LANDMARKS, 8), dtype=np.uint32))
    lm_dist = jnp.linalg.norm(lm_pos, axis=-1)
    lm_normal = lm_pos / lm_dist[:, None]

    def frame_step(pair, Tcw0):
        res, _ = track_stereo_frame(
            cam, cfg, 1024, pair, Tcw0, lm_pos, lm_normal, lm_desc,
            lm_dist * 1.05, lm_dist / 1.2**8,
            jnp.ones(N_LANDMARKS, bool), th=3.0)
        return res.Tcw, res.n_inliers

    T = jnp.eye(4)
    for i in range(6):                       # compile + warm
        T, n = frame_step(imgs[i % 4], T)
    _ = np.asarray(n)
    T = jnp.eye(4)
    t0 = time.perf_counter()
    for i in range(n_timed):
        T, n = frame_step(imgs[i % 4], T)    # chained: no step skippable
    _ = np.asarray(n)                        # real fetch ends the clock
    dt = time.perf_counter() - t0
    return n_timed / dt


def main() -> int:
    import traceback

    import jax

    dev = jax.devices()[0]
    out = {
        "metric": "system_frames_per_second_1chip_1280x720_stereo_1000feat",
        "unit": "frames/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    errors = {}
    for name, fn in (("system_fps", bench_system_fps),
                     ("frontend_fps", bench_frontend_fps)):
        try:
            out[name] = round(fn(), 2)
        except Exception:   # finish the other phase, report, exit 1
            errors[name] = traceback.format_exc()[-800:]
    if "system_fps" in out:
        out["value"] = out["system_fps"]
        out["vs_baseline"] = round(out["system_fps"] / 60.0, 3)
    if errors:
        out["errors"] = errors
    print(json.dumps(out))
    return 1 if errors else 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
