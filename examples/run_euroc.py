"""Run stereo SLAM on a EuRoC MAV sequence and report ATE/RPE.

The reference is driven by external apps through HYSLAM::System
(System.h:74); this is that driver for the EuRoC ASL folder layout:

    python examples/run_euroc.py /data/euroc/MH_01_easy --frames 500 \
        --out out_euroc/

Assumes rectified images (the reference's Camera model ignores distortion,
Camera.h:4-52); for raw EuRoC data rectify upstream first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hyslam_tpu.core.mapstate import MapCaps
from hyslam_tpu.io.config import CameraConfig, SystemConfig
from hyslam_tpu.io.datasets import EurocMav
from hyslam_tpu.io.evaluate import ate_rmse, rpe
from hyslam_tpu.slam.system import System


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="EuRoC sequence root (contains mav0/)")
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--out", default="out_euroc")
    args = ap.parse_args(argv)

    ds = EurocMav(args.root)
    c = ds.calib
    cfg = SystemConfig(
        caps=MapCaps(K=512, L=32768, F=2048, O=16),
        run_data_dir=os.path.join(args.out, "run_data"),
    )
    cfg.cameras["SLAM"] = CameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height,
        bf=c.bf, th_depth=c.bf / c.fx * 40.0,
    )
    slam = System(cfg)

    stop = args.frames or None
    est, gt = [], []
    t0 = time.perf_counter()
    for fr in ds.frames(stop=stop):
        tel = slam.track_stereo(fr.img_left, fr.img_right, fr.timestamp)
        tr = slam.trackers["SLAM"]
        est.append(np.asarray(tr.last_Tcw))
        if fr.gt_Tcw is not None:
            gt.append(fr.gt_Tcw)
        if tel.frame_id % 50 == 0:
            print(f"frame {tel.frame_id}: state={tel.state} "
                  f"inliers={tel.n_inliers}", flush=True)
    wall = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    slam.save_map(os.path.join(args.out, "map.npz"))

    n = len(est)
    print(f"{n} frames in {wall:.1f}s -> {n / wall:.1f} fps")
    if len(gt) == n and n > 1:
        a = ate_rmse(np.stack(est), np.stack(gt))
        r_t, r_r = rpe(np.stack(est), np.stack(gt))
        print(f"ATE RMSE: {a:.3f} m | RPE: {r_t:.4f} m/frame, "
              f"{r_r:.4f} deg/frame")
    return 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
