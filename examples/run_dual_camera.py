"""Dual-camera demo: the reference's flagship use case (README.md:18-24) on
a self-contained rendered scene — a stereo SLAM camera localizes while a
monocular Imaging "documentation" camera maps through its own per-camera
map; the imaging map is finalized by the trajectory-tied Imaging Bundle
Adjustment and exported (COLMAP + Agisoft XML), mirroring
System::RunImagingBundleAdjustment (System.cc:224-265).

    python examples/run_dual_camera.py --frames 90 --out out_dual/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax.numpy as jnp

from hyslam_tpu.core.mapstate import MapCaps
from hyslam_tpu.features.extractor import ExtractorConfig
from hyslam_tpu.geometry import se3
from hyslam_tpu.io.config import CameraConfig, SystemConfig
from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams
from hyslam_tpu.slam.system import System


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--out", default="out_dual")
    args = ap.parse_args(argv)

    from helpers import DEFAULT_CAM, render_world

    cam = DEFAULT_CAM
    n = args.frames
    rng = np.random.default_rng(3)
    Ts, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n):
        Ts.append(T.copy())
        delta = np.asarray(se3.exp(jnp.asarray(
            [0.0, 0.004, 0.0, 0.0, 0.0, -0.18], dtype=jnp.float32)))
        T = (delta @ T).astype(np.float32)
    Ts = np.stack(Ts)
    centers = np.stack([-(Ts[i, :3, :3].T @ Ts[i, :3, 3]) for i in range(n)])
    pts = np.concatenate([
        c + rng.uniform([-6, -4, 2], [6, 4, 18], size=(16, 3))
        for c in centers[::2]
    ]).astype(np.float32)
    Tcam = np.asarray(se3.exp(jnp.asarray(
        [0.0, 0.06, 0.02, 0.15, -0.1, 0.0], dtype=jnp.float32)))

    ex = ExtractorConfig(n_features=400, n_levels=4)
    pol = KeyFramePolicyParams(max_kf_interval=5, n_tracked_target=80,
                               n_tracked_variance=20)
    cfg = SystemConfig(
        cameras={
            "SLAM": CameraConfig(
                fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                width=cam.width, height=cam.height, bf=cam.bf,
                extractor=ex, policy=pol),
            "Imaging": CameraConfig(
                fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                width=cam.width, height=cam.height, mono=True,
                Tcam=Tcam.tolist(), extractor=ex,
                policy=KeyFramePolicyParams(max_kf_interval=4,
                                            n_tracked_target=70,
                                            n_tracked_variance=20)),
        },
        caps=MapCaps(K=64, L=8192, F=512, O=8),
    )
    sysm = System(cfg)
    T_r = np.asarray(se3.from_Rt(jnp.eye(3),
                                 jnp.asarray([-cam.baseline, 0.0, 0.0])))

    kept = 0
    t0 = time.perf_counter()
    for i in range(n):
        il, _, _ = render_world(cam, Ts[i], pts)
        ir, _, _ = render_world(cam, (T_r @ Ts[i]).astype(np.float32), pts)
        sysm.track_stereo(il, ir, timestamp=0.1 * i, frame_id=i)
        if i % 2 == 0:
            im = render_world(cam, (Tcam @ Ts[i]).astype(np.float32), pts)[0]
            sysm.track_monocular(im, timestamp=0.1 * i, camera="Imaging")
            keep, _ = sysm.place_imaging_frame(0.1 * i)
            kept += int(bool(keep))
    wall = time.perf_counter() - t0

    print(f"{n} stereo + {n // 2} imaging frames in {wall:.1f}s; "
          f"placer kept {kept}")
    sysm.run_imaging_bundle_adjustment()

    os.makedirs(args.out, exist_ok=True)
    sysm.export_colmap(args.out)
    sysm.save_keyframes_agisoft(os.path.join(args.out, "imaging.xml"),
                                camera="Imaging")
    sysm.save_trajectory(os.path.join(args.out, "slam_traj.tsv"))

    # imaging keyframe ATE vs rendered ground truth
    tr = sysm.trackers["Imaging"]
    kf_ok = np.asarray(tr.ms.kf.valid & ~tr.ms.kf.bad)
    sel = np.nonzero(kf_ok)[0]
    est_c = np.asarray(se3.translation(se3.inverse(
        tr.ms.kf.Tcw[jnp.asarray(sel)])))
    idx = np.clip(np.round(np.asarray(tr.ms.kf.timestamp)[sel] / 0.1
                           ).astype(int), 0, n - 1)
    gt_T = np.stack([(Tcam @ Ts[i]).astype(np.float32) for i in idx])
    gt_c = np.asarray(se3.translation(se3.inverse(jnp.asarray(gt_T))))
    ate = float(np.sqrt(np.mean(np.sum((est_c - gt_c) ** 2, -1))))
    print(json.dumps({"imaging_kf_ate_m": round(ate, 4),
                      "imaging_kfs": int(kf_ok.sum()),
                      "fps": round(n / wall, 2)}))
    return 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
