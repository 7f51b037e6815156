"""Self-contained demo: stereo SLAM on a synthetic corridor — no dataset
needed. Exercises the full System (tracking, mapping, keyframes, exports,
viz) and reports ATE against the generated ground truth.

    python examples/run_synthetic.py --frames 40 --out out_synth/
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

from hyslam_tpu.core.mapstate import MapCaps
from hyslam_tpu.io.config import CameraConfig, SystemConfig
from hyslam_tpu.io.evaluate import ate_rmse
from hyslam_tpu.slam.system import System


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default="out_synth")
    ap.add_argument("--viz", action="store_true")
    args = ap.parse_args(argv)

    from helpers import (  # synthetic world generators shared with tests
        DEFAULT_CAM, make_trajectory, make_world, synth_frame_features,
    )

    rng = np.random.default_rng(0)
    pts = make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
    descs = rng.integers(0, 2**32, (1500, 8), dtype=np.uint32)
    traj_gt = make_trajectory(n_frames=args.frames, step=0.12,
                              yaw_rate=0.004)

    cfg = SystemConfig(caps=MapCaps(K=64, L=8192, F=512, O=8),
                       run_data_dir=os.path.join(args.out, "run_data"))
    cfg.cameras["SLAM"] = CameraConfig(
        fx=DEFAULT_CAM.fx, fy=DEFAULT_CAM.fy, cx=DEFAULT_CAM.cx,
        cy=DEFAULT_CAM.cy, width=DEFAULT_CAM.width,
        height=DEFAULT_CAM.height, bf=DEFAULT_CAM.bf,
    )
    slam = System(cfg)
    viewer = None
    if args.viz:
        from hyslam_tpu.viz import Viewer

        viewer = Viewer(out_dir=os.path.join(args.out, "viz"))

    est = []
    t0 = time.perf_counter()
    for i, T in enumerate(traj_gt):
        feats, _ = synth_frame_features(DEFAULT_CAM, T, pts, descs, rng,
                                        F=512)
        tel = slam.track_features(feats, timestamp=0.1 * i)
        tr = slam.trackers["SLAM"]
        est.append(np.asarray(tr.last_Tcw))
        if viewer is not None:
            viewer.update(tr.ms, current_Tcw=tr.last_Tcw)
        if i % 10 == 0:
            print(f"frame {i}: state={tel.state} inliers={tel.n_inliers}",
                  flush=True)
    wall = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    slam.export_colmap(args.out)
    slam.save_map(os.path.join(args.out, "map.npz"))
    if viewer is not None:
        viewer.snapshot("final")
    slam.shutdown()

    a = ate_rmse(np.stack(est), traj_gt[: len(est)])
    print(f"{len(est)} frames in {wall:.1f}s -> {len(est) / wall:.1f} fps | "
          f"ATE RMSE {a:.4f} m")
    return 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
