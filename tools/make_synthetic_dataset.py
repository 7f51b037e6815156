"""Generate a long rendered sequence ON DISK in KITTI-odometry or TUM-RGB-D
layout, so the unmodified dataset drivers (examples/run_kitti.py,
examples/run_tum.py) can be soak-tested end-to-end to ATE artifacts without
network egress (BASELINE configs #1-#3 name TUM fr1/desk, KITTI 00,
TUM fr3/office; this environment cannot download them).

The rendered world is the same sparse-constellation renderer the test suite
validates the extractor against (tests/helpers.py:render_world): each world
point splats a point-unique blob pattern, so ORB descriptors are distinctive
and viewpoint-stable. The trajectory is a closed circuit (loop-closure
opportunity at the end, like the reference's ecosystem transects).

    python tools/make_synthetic_dataset.py kitti /data/synth_kitti \
        --frames 600
    python tools/make_synthetic_dataset.py tum /data/synth_tum --frames 400

KITTI layout (hyslam_tpu/io/datasets.py:74): sequences/00/{image_0,image_1,
times.txt,calib.txt} + poses/00.txt (3x4 camera-to-world rows).
TUM layout (datasets.py:128): rgb/ + depth/ (16-bit PNG, depth*5000) +
rgb.txt/depth.txt/groundtruth.txt (ts tx ty tz qx qy qz qw, cam-to-world).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def circuit_poses(n_frames: int, radius: float, n_loops: float = 1.02):
    """Closed-circuit Tcw trajectory: camera rides a circle of `radius`
    looking along the tangent (same geometry as tests/test_longrun.py so a
    full lap revisits the start and exercises loop closing)."""
    import jax.numpy as jnp
    from hyslam_tpu.geometry import se3

    out = []
    for i in range(n_frames):
        th = 2 * np.pi * n_loops * i / n_frames
        C = np.array([radius * np.sin(th), 0.0, radius * (1 - np.cos(th))],
                     np.float32)
        # camera z-axis = tangent direction
        fwd = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
        up = np.array([0.0, -1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        Rwc = np.stack([right, up, fwd], axis=1)
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = Rwc
        Twc[:3, 3] = C
        out.append(np.linalg.inv(Twc).astype(np.float32))
    return out


def circuit_world(rng, radius: float, n_points: int,
                  wall_min=4.0, wall_max=18.0, y_range=(-4.0, 3.0)):
    """Landmarks in a band around the circuit (inner+outer walls + ground),
    so every viewpoint on the lap sees well-distributed texture."""
    th = rng.uniform(0, 2 * np.pi, n_points)
    r = radius + rng.uniform(wall_min, wall_max, n_points) * rng.choice(
        [-1.0, 1.0], n_points, p=[0.35, 0.65])
    y = rng.uniform(*y_range, n_points)
    pts = np.stack(
        [r * np.sin(th), y, radius - r * np.cos(th)], -1).astype(np.float32)
    return pts


def _write_pgm(path, img):
    img8 = np.clip(img, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img8.shape[1], img8.shape[0]))
        f.write(img8.tobytes())


def _write_png16(path, depth_m, factor=5000.0):
    from PIL import Image

    d = np.clip(depth_m * factor, 0, 65535).astype(np.uint16)
    Image.fromarray(d, mode="I;16").save(path)


def render_depth(cam, Tcw, pts, radius_px=5):
    """Dense-enough depth image: splat each visible point's z into a small
    disc (nearest-z wins) so depth is valid at the blob pixels where the
    extractor fires."""
    import jax.numpy as jnp
    from hyslam_tpu.geometry import se3 as _se3
    from hyslam_tpu.geometry.camera import project as _project

    uv, z = _project(cam, _se3.apply(jnp.asarray(Tcw), jnp.asarray(pts)))
    uv = np.asarray(uv)
    z = np.asarray(z)
    H, W = cam.height, cam.width
    depth = np.zeros((H, W), np.float32)
    vis = (z > 0.2) & (uv[:, 0] > -radius_px) & (uv[:, 0] < W + radius_px) \
        & (uv[:, 1] > -radius_px) & (uv[:, 1] < H + radius_px)
    order = np.argsort(-z[vis])  # far first; near overwrites
    ui = np.round(uv[vis][order]).astype(int)
    zi = z[vis][order]
    rr = np.arange(-radius_px, radius_px + 1)
    dy, dx = np.meshgrid(rr, rr, indexing="ij")
    disc = (dx * dx + dy * dy) <= radius_px * radius_px
    offs = np.stack([dx[disc], dy[disc]], -1)  # [D,2] (x,y)
    px = ui[:, None, 0] + offs[None, :, 0]
    py = ui[:, None, 1] + offs[None, :, 1]
    pz = np.broadcast_to(zi[:, None], px.shape)
    ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    depth[py[ok], px[ok]] = pz[ok]
    return depth


def gen_kitti(root, n_frames, seed=0, n_loops=1.02):
    from helpers import render_world
    from hyslam_tpu.geometry.camera import Camera

    W, H = 640, 360
    fx = fy = 450.0
    cx, cy = W / 2, H / 2
    baseline = 0.54  # KITTI-class stereo rig
    bf = fx * baseline
    cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy, width=W, height=H, bf=bf,
                 th_depth=40.0 * baseline)

    rng = np.random.default_rng(seed)
    radius = 40.0
    pts = circuit_world(rng, radius, 9000)
    poses = circuit_poses(n_frames, radius, n_loops)

    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq, "image_1"), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)

    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: %g 0 %g 0 0 %g %g 0 0 0 1 0\n" % (fx, cx, fy, cy))
        f.write("P1: %g 0 %g %g 0 %g %g 0 0 0 1 0\n" % (fx, cx, -bf, fy, cy))
    with open(os.path.join(seq, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write("%.6f\n" % (0.1 * i))

    T_right = np.eye(4, dtype=np.float32)
    T_right[0, 3] = -baseline
    pose_rows = []
    for i, Tcw in enumerate(poses):
        il, _, _ = render_world(cam, Tcw, pts)
        ir, _, _ = render_world(cam, (T_right @ Tcw).astype(np.float32), pts)
        _write_pgm(os.path.join(seq, "image_0", "%06d.pgm" % i), il)
        _write_pgm(os.path.join(seq, "image_1", "%06d.pgm" % i), ir)
        Twc = np.linalg.inv(Tcw.astype(np.float64))
        pose_rows.append(Twc[:3, :].reshape(-1))
        if i % 50 == 0:
            print(f"kitti frame {i}/{n_frames}", flush=True)
    np.savetxt(os.path.join(root, "poses", "00.txt"),
               np.stack(pose_rows), fmt="%.9e")
    print(f"wrote {n_frames}-frame KITTI-layout sequence to {root}")


def gen_tum(root, n_frames, seed=1, n_loops=1.02):
    from helpers import render_world
    from hyslam_tpu.geometry.camera import Camera
    from hyslam_tpu.geometry import so3
    import jax.numpy as jnp
    from hyslam_tpu.io.datasets import TumRgbd

    W, H = 640, 480
    cam = Camera(fx=TumRgbd.FX, fy=TumRgbd.FY, cx=TumRgbd.CX, cy=TumRgbd.CY,
                 width=W, height=H, bf=TumRgbd.FX * 0.08)

    rng = np.random.default_rng(seed)
    radius = 4.0  # room-scale indoor loop; keep all depths < the 16-bit
    # TUM depth ceiling (65535/5000 = 13.1 m)
    pts = circuit_world(rng, radius, 6000, wall_min=1.2, wall_max=5.0,
                        y_range=(-1.8, 1.4))
    poses = circuit_poses(n_frames, radius, n_loops)

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    frgb = open(os.path.join(root, "rgb.txt"), "w")
    fdep = open(os.path.join(root, "depth.txt"), "w")
    fgt = open(os.path.join(root, "groundtruth.txt"), "w")
    for f in (frgb, fdep, fgt):
        f.write("# synthetic TUM-layout sequence\n")
    from PIL import Image

    for i, Tcw in enumerate(poses):
        t = 0.1 * i
        img, _, _ = render_world(cam, Tcw, pts)
        depth = render_depth(cam, Tcw, pts)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, "rgb", "%.6f.png" % t))
        _write_png16(os.path.join(root, "depth", "%.6f.png" % t), depth)
        frgb.write("%.6f rgb/%.6f.png\n" % (t, t))
        fdep.write("%.6f depth/%.6f.png\n" % (t, t))
        Twc = np.linalg.inv(Tcw.astype(np.float64))
        q = np.asarray(so3.quat_from_mat(jnp.asarray(
            Twc[:3, :3].astype(np.float32))))  # [w,x,y,z]
        fgt.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n" % (
            t, Twc[0, 3], Twc[1, 3], Twc[2, 3], q[1], q[2], q[3], q[0]))
        if i % 50 == 0:
            print(f"tum frame {i}/{n_frames}", flush=True)
    for f in (frgb, fdep, fgt):
        f.close()
    print(f"wrote {n_frames}-frame TUM-layout sequence to {root}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("layout", choices=["kitti", "tum"])
    ap.add_argument("root")
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loops", type=float, default=1.02,
                    help="fraction of the circuit covered: per-frame motion"
                         " scales with loops/frames, so short CI sequences"
                         " should use a small value to keep the motion"
                         " magnitude of the full-length soak")
    args = ap.parse_args(argv)
    if args.layout == "kitti":
        gen_kitti(args.root, args.frames, args.seed, args.loops)
    else:
        gen_tum(args.root, args.frames, args.seed, args.loops)
    return 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
