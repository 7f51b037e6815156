"""Run SLAM on a TUM RGB-D sequence (e.g. fr1/desk) and report ATE
against the ground truth. Default is monocular (the SURVEY.md §7.3 second
slice); --rgbd uses the registered depth images through System.track_rgbd
(BASELINE config #3: RGB-D full pipeline on fr3/office).

    python examples/run_tum.py /data/tum/rgbd_dataset_freiburg1_desk \
        --frames 300 --out out_tum/ [--rgbd]
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
from hyslam_tpu.io.datasets import TumRgbd
from hyslam_tpu.io.evaluate import ate_rmse
from hyslam_tpu.slam.system import System


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="TUM sequence dir (rgb.txt, depth.txt, ...)")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out", default="out_tum")
    ap.add_argument("--rgbd", action="store_true",
                    help="use registered depth (System.track_rgbd); "
                         "default tracks monocular and discards depth")
    ap.add_argument("--mode", choices=["async", "sync"], default="sync",
                    help="async = zero-host-sync production driver")
    ap.add_argument("--json", default=None,
                    help="write the soak result artifact to this path")
    args = ap.parse_args(argv)

    ds = TumRgbd(args.root)
    cfg = SystemConfig(caps=MapCaps(K=256, L=16384, F=1024, O=16),
                       async_tracking=args.mode == "async")
    from hyslam_tpu.slam.mapper import MapperParams

    cfg.mapper = MapperParams(orphan_age=6)   # long-run arena policy
    cfg.cameras["SLAM"] = CameraConfig(
        fx=ds.FX, fy=ds.FY, cx=ds.CX, cy=ds.CY, width=640, height=480,
        mono=not args.rgbd,
        # virtual baseline for the synthesized stereo channel (ORB-SLAM2
        # uses ~40 px * depth-scale for TUM; bf = fx * 0.08 m here)
        bf=0.0 if not args.rgbd else ds.FX * 0.08,
    )
    slam = System(cfg)

    stop = args.frames or None
    est, ts = [], []
    t0 = time.perf_counter()
    for i, t, img, depth in ds.frames(stop=stop):
        if args.rgbd:
            tel = slam.track_rgbd(img, depth, t)
        else:
            tel = slam.track_monocular(img, t)
        n_fed = i + 1
        if tel is None or args.mode == "async":
            ts.append(t)
            continue   # async: read the trajectory at the end
        tr = slam.trackers["SLAM"]
        est.append(np.asarray(tr.last_Tcw))
        ts.append(t)
        if i % 50 == 0:
            print(f"frame {i}: state={tel.state} inliers={tel.n_inliers}",
                  flush=True)
    slam.flush()
    wall = time.perf_counter() - t0
    if not est:
        tr = slam.trackers["SLAM"]
        n = int(np.asarray(tr.traj.size))
        est = [np.asarray(tr.traj.Tcw[k]) for k in range(n)]
        ts = list(np.asarray(tr.traj.t[:n]))

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    slam.save_map(os.path.join(args.out, "map.npz"))
    frac = len(est) / max(len(ts), 1) if args.mode != "async" else \
        len(est) / max(n_fed, 1)
    print(f"{len(est)} tracked in {wall:.1f}s -> "
          f"{max(len(ts), len(est)) / wall:.1f} fps "
          f"({100.0 * frac:.1f}% tracked)")
    report = {"dataset": "tum", "mode": args.mode,
              "rgbd": bool(args.rgbd),
              "frames_tracked": len(est),
              "tracked_fraction": round(frac, 4),
              "fps": round(max(len(ts), len(est)) / wall, 2),
              "wall_s": round(wall, 1)}

    if ds.gt is not None and len(est) > 1:
        # associate gt by timestamp, build Tcw from (t xyz quat) world poses
        from hyslam_tpu.geometry import so3
        import jax.numpy as jnp

        gts = []
        for t in ts:
            j = int(np.argmin(np.abs(ds.gt[:, 0] - t)))
            tx, ty, tz, qx, qy, qz, qw = ds.gt[j, 1:8]
            R = np.asarray(so3.mat_from_quat(
                jnp.asarray([qw, qx, qy, qz], jnp.float32)))
            Twc = np.eye(4, dtype=np.float32)
            Twc[:3, :3] = R
            Twc[:3, 3] = [tx, ty, tz]
            gts.append(np.linalg.inv(Twc))
        # monocular scale is free (sim3); RGB-D is metric (se3)
        align = "se3" if args.rgbd else "sim3"
        a = ate_rmse(np.stack(est), np.stack(gts), align=align)
        print(f"ATE RMSE ({align}-aligned): {a:.4f} m")
        report["ate_rmse_m"] = round(float(a), 4)
        report["align"] = align
    if args.json:
        import json

        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.json)
    return 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
