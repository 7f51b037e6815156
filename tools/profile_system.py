"""Per-stage decomposition of the System tracking path on the live backend.

Host wall time per stage (preprocess / extract / stereo /
track_normal_frame / host syncs / trajectory append / keyframe
integration), device dispatch latency, and the number of separate device
dispatches per tracked frame: where a frame's time goes between the host
and the device.

Usage:  python tools/profile_system.py [--frames 40] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import jax
import jax.numpy as jnp


def bench(fn, n=20):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    dev = jax.devices()[0]
    print(f"backend: {dev.platform} ({dev.device_kind})", flush=True)

    # --- raw dispatch / transfer latency of this runtime -------------------
    one = jnp.ones((8, 8), jnp.float32)
    add = jax.jit(lambda x: x + 1.0)
    add(one).block_until_ready()
    t_dispatch = bench(lambda: add(one).block_until_ready(), 50)
    small = add(one)
    t_fetch_scalar = bench(lambda: float(small[0, 0]), 50)
    big = jnp.ones((720, 1280), jnp.float32)
    t_h2d = bench(lambda: jax.device_put(np.ones((720, 1280), np.float32)
                                         ).block_until_ready(), 20)
    print(f"dispatch+sync 8x8 add: {t_dispatch*1e3:.2f} ms")
    print(f"scalar fetch:          {t_fetch_scalar*1e3:.2f} ms")
    print(f"H2D 720x1280 f32:      {t_h2d*1e3:.2f} ms", flush=True)

    # --- build the bench system (same operating point as bench.py) ---------
    from helpers import render_world
    from hyslam_tpu.core.mapstate import MapCaps
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.geometry import se3
    from hyslam_tpu.geometry.camera import Camera
    from hyslam_tpu.io.config import CameraConfig, SystemConfig
    from hyslam_tpu.slam.system import System

    H, W = 720, 1280
    cam = Camera(fx=700.0, fy=700.0, cx=W / 2, cy=H / 2, width=W, height=H,
                 bf=84.0, th_depth=35.0)
    cc = CameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                      width=W, height=H, bf=cam.bf,
                      extractor=ExtractorConfig(n_features=1000, n_levels=8))
    sysm = System(SystemConfig(cameras={"SLAM": cc},
                               caps=MapCaps(K=64, L=16384, F=1024, O=8),
                               enable_loop_closing=False))

    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-14, 14, 4000), rng.uniform(-9, 9, 4000),
                    rng.uniform(3, 45, 4000)], -1).astype(np.float32)
    T_r_off = np.asarray(se3.from_Rt(
        jnp.eye(3), jnp.asarray([-cam.baseline, 0.0, 0.0])))
    frames = []
    T = np.eye(4, dtype=np.float32)
    print("rendering...", flush=True)
    for i in range(args.frames):
        il, _, _ = render_world(cam, T, pts)
        ir, _, _ = render_world(cam, (T_r_off @ T).astype(np.float32), pts)
        frames.append((il, ir))
        delta = np.asarray(se3.exp(jnp.asarray(
            [0, 0.002, 0, 0, 0, -0.08], dtype=jnp.float32)))
        T = (delta @ T).astype(np.float32)

    # --- instrument stages --------------------------------------------------
    stages = defaultdict(list)
    counts = defaultdict(int)

    def timed(obj, name, key=None):
        key = key or name
        orig = getattr(obj, name)

        def run(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            stages[key].append(time.perf_counter() - t0)
            counts[key] += 1
            return out

        setattr(obj, name, run)

    import hyslam_tpu.slam.system as SYSMOD
    import hyslam_tpu.slam.tracker as TRKMOD
    from hyslam_tpu.core import trajectory as TJMOD

    tk = sysm.trackers["SLAM"]
    timed(tk.mapper, "integrate_keyframe")
    timed(tk, "_update_last_frame")

    # wrap module-level fns used inside System.track_stereo
    orig_pre = SYSMOD.preprocess_image
    orig_stereo = SYSMOD.match_stereo_refined
    orig_track_normal = TRKMOD.track_normal_frame
    orig_append = TRKMOD.TJ.append

    def wrap_fn(orig, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            stages[key].append(time.perf_counter() - t0)
            counts[key] += 1
            return out
        return run

    SYSMOD.preprocess_image = wrap_fn(orig_pre, "preprocess")
    SYSMOD.match_stereo_refined = wrap_fn(orig_stereo, "stereo_match")
    TRKMOD.track_normal_frame = wrap_fn(orig_track_normal, "track_normal_dispatch")
    TRKMOD.TJ.append = wrap_fn(orig_append, "traj_append")

    fam = sysm._families["SLAM"]
    timed(fam, "extract_batch")

    # the host sync: nf.scalars fetch inside _do_normal. Time it by
    # wrapping np.asarray? Instead wrap tracker._do_normal wholesale and
    # subtract known stages.
    timed(tk, "_do_normal")
    timed(tk, "_insert_keyframe")

    # count device dispatches per frame via a trace on jitted calls
    # (pjit executions): monkeypatch ExecuteReplicated is brittle; instead
    # count pjit cache hits through jax.monitoring is unavailable — skip.

    print("tracking...", flush=True)
    per_frame = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        sysm.track_stereo(*frames[i], timestamp=0.05 * i, frame_id=i)
        per_frame.append(time.perf_counter() - t0)

    per_frame = np.asarray(per_frame)
    n_warm = min(10, args.frames // 4)
    steady = per_frame[n_warm:]
    print(f"\nper-frame wall: mean {steady.mean()*1e3:.1f} ms "
          f"median {np.median(steady)*1e3:.1f} ms  -> "
          f"{1.0/steady.mean():.2f} fps (excl. first {n_warm})")

    report = {"backend": dev.platform,
              "dispatch_ms": t_dispatch * 1e3,
              "scalar_fetch_ms": t_fetch_scalar * 1e3,
              "h2d_720p_ms": t_h2d * 1e3,
              "frame_mean_ms": float(steady.mean() * 1e3),
              "fps": float(1.0 / steady.mean()),
              "stages": {}}
    print(f"\n{'stage':28s} {'calls':>6s} {'mean ms':>9s} {'total s':>9s}")
    for k, v in sorted(stages.items(), key=lambda kv: -np.sum(kv[1])):
        v = np.asarray(v)
        # drop the first call (compile)
        vs = v[1:] if len(v) > 1 else v
        print(f"{k:28s} {len(v):6d} {vs.mean()*1e3:9.2f} {v.sum():9.2f}")
        report["stages"][k] = {"calls": int(len(v)),
                               "mean_ms": float(vs.mean() * 1e3),
                               "total_s": float(v.sum())}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
