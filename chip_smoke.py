#!/usr/bin/env python3
"""Smoke test of the stereo SLAM path on the GPU.

    python chip_smoke.py              # one card: phases (a)-(d)
    python chip_smoke.py --cards 4    # four cards: the distributed solvers

Phases on one card:

(a) device: kind, `nvidia-smi` name and power limit, JAX version, compile
    cache directory;
(b) pose LM: the Triton kernel (ops/pose_opt_pallas.py) against the plain
    XLA solver at N=1024 (stereo, mono, 25% outliers), both on the card;
(c) main path: `System.track_stereo` at the reference's SLAM camera
    (1280x720 stereo, bf=84, 1000 ORB features, 8 levels x1.2), shipped
    arena caps, async tracking with the loop-closing worker, on a rendered
    sequence; then one global BA over the resulting map;
(d) the last line of standard output: one JSON object with the device.

`--cards 4` runs only the distributed solvers (1-D and 2-D BA meshes, the
edge-sharded pose graph) against the one-card solvers. Each of them runs
under a watchdog: a phase that outlives its limit (a collective waiting on
a card that took another branch) prints every thread's stack and ends the
process with exit code 1.

Every phase logs its start, so the last `phase ...: start` line names the
one that failed. Exits non-zero, printing no result line, when JAX finds no
GPU or any phase fails. One process drives the card(s).
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# phase (b): kernel vs plain solver (float32 reduction order differs)
POSE_TOL_RAD = 1e-4
POSE_TOL_M = 1e-4
INLIER_TOL = 2

# phase (c): the rendered sequence and its bounds
N_FRAMES = 60
N_WARM = 20            # frames before the timed window (compiles land here)
FRAME_DT = 0.05
MIN_KEYFRAMES = 3
MIN_TRACKED = 0.9
ATE_BOUND_M = 0.05     # CPU run of the same seed: see CHANGES.md

# --cards 4: distributed vs one-card solvers on the same problem. Both
# minimize the same cost, which must agree to 1%. The poses agree less
# tightly: the K=512 chain has one fixed keyframe, and the CG solve of the
# reduced system stops at its tolerance, so float32 reduction order (psum
# over cards vs one card) moves the iterate along weakly observed
# directions far down the 153 m chain (0.27 m / 7e-3 rad at most on a
# 4-device CPU mesh).
DIST_COST_RTOL = 1e-2
DIST_POSE_TOL_RAD = 2e-2
DIST_POSE_TOL_M = 0.5
DIST_PG_GAP = 5e-2     # max |Sim3 param| gap of the pose graph (CPU: 1.5e-2)
# The pose-graph problem is consistent: both solvers take its cost from
# ~885 down to the float32 floor (~1.7e-5 on an H100), where the one-card
# solver differs from itself run to run by 4 % (scatter-add order). Costs
# agree within 1 % or within 1e-7 of the starting cost.
DIST_PG_COST_ATOL_START = 1e-7
# compile + 1 + reps solves of one distributed solver; a hang outlives it
DIST_PHASE_LIMIT_S = 240


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str, limit_s: float | None = None):
    """Log the phase's start and duration; past `limit_s` seconds dump
    every thread's stack to stderr and exit the process (code 1)."""
    log(f"phase {name}: start")
    t0 = time.perf_counter()
    if limit_s:
        faulthandler.dump_traceback_later(limit_s, exit=True)
    try:
        yield
    finally:
        if limit_s:
            faulthandler.cancel_dump_traceback_later()
    log(f"phase {name}: done in {time.perf_counter() - t0:.1f} s")


def _helpers():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import helpers

    return helpers


def _timed(fn, reps: int, warm: bool = True) -> float:
    """Mean seconds per call of fn, each call waited for; `warm` first
    makes one untimed call (pass False when fn has already run)."""
    import jax

    if warm:
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


# --------------------------------------------------------------- (a) device

def phase_device() -> str:
    import jax

    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"device_kind: {dev.device_kind}  count: {len(jax.devices())}")
    log("nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"jax {jax.__version__}  compile cache: {cache}")
    return smi


# -------------------------------------------------------------- (b) pose LM

def pose_problem(rng, n: int, variant: str):
    """N-observation pose problem: a perturbed pose against noisy
    projections of a random world (`variant`: stereo | mono | outliers)."""
    import jax.numpy as jnp

    h = _helpers()
    cam = h.DEFAULT_CAM
    pts = h.make_world(rng, n)
    T_true = h.make_trajectory(3)[2]
    uv, ur, vis, stereo = h.observe(
        cam, T_true, pts, noise=0.3, rng=rng,
        stereo_frac=0.0 if variant == "mono" else 1.0)
    if variant == "outliers":
        out = rng.choice(n, n // 4, replace=False)
        uv[out] += (rng.uniform(30, 120, (len(out), 2))
                    * rng.choice([-1, 1], (len(out), 2)))
    T0 = h.perturb_pose(rng, T_true, rot=0.03, trans=0.15)
    return cam, (jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(uv),
                 jnp.asarray(ur), jnp.ones(n, jnp.float32),
                 jnp.asarray(vis), jnp.asarray(stereo & vis))


def phase_pose_lm(n: int = 1024, reps: int = 50) -> dict:
    import jax

    from hyslam_tpu.ops.pose_opt_pallas import pose_optimization_pallas
    from hyslam_tpu.solver.pose_opt import (
        pose_optimization,
        pose_optimization_fast,
    )

    h = _helpers()
    rng = np.random.default_rng(0)
    times = {}
    for variant in ("stereo", "mono", "outliers"):
        cam, args = pose_problem(rng, n, variant)
        with jax.default_matmul_precision("highest"):
            ref = pose_optimization(cam, *args)
        got = pose_optimization_fast(cam, *args)
        d_rot, d_t = h.pose_error(np.asarray(got.Tcw), np.asarray(ref.Tcw))
        d_rot = float(np.radians(d_rot))
        d_inl = abs(int(got.num_inliers) - int(ref.num_inliers))
        log(f"pose_lm {variant}: d_rot {d_rot:.3e} rad  d_t {d_t:.3e} m  "
            f"inliers {int(got.num_inliers)} vs {int(ref.num_inliers)}")
        if not (d_rot <= POSE_TOL_RAD and d_t <= POSE_TOL_M
                and d_inl <= INLIER_TOL):
            raise AssertionError(
                f"pose LM kernel disagrees with the plain solver on "
                f"{variant}: {d_rot} rad, {d_t} m, {d_inl} inliers")
        if variant == "stereo":
            times["kernel_ms"] = 1e3 * _timed(
                lambda: pose_optimization_pallas(cam, *args), reps)
            times["xla_ms"] = 1e3 * _timed(
                lambda: pose_optimization(cam, *args), reps)
    log(f"pose_lm N={n}: kernel {times['kernel_ms']:.4f} ms/call  "
        f"xla {times['xla_ms']:.4f} ms/call")
    return times


# ------------------------------------------------------------ (c) main path

def slam_camera():
    """The reference's SLAM camera (sample_primary_config_file.yaml:27-41)."""
    from hyslam_tpu.geometry.camera import Camera

    H, W = 720, 1280
    return Camera(fx=700.0, fy=700.0, cx=W / 2, cy=H / 2, width=W,
                  height=H, bf=84.0, th_depth=35.0)


def render_sequence(cam, n_frames: int, seed: int = 0):
    """Stereo pairs of a seeded world along a forward path with slight
    yaw; returns (frames [(left, right)], ground-truth Tcw [n,4,4])."""
    import jax.numpy as jnp

    from hyslam_tpu.geometry import se3

    h = _helpers()
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-14, 14, 4000), rng.uniform(-9, 9, 4000),
                    rng.uniform(3, 45, 4000)], -1).astype(np.float32)
    T_r = np.asarray(se3.from_Rt(
        jnp.eye(3), jnp.asarray([-cam.baseline, 0.0, 0.0])))
    delta = np.asarray(se3.exp(jnp.asarray(
        [0, 0.002, 0, 0, 0, -0.08], dtype=jnp.float32)))
    frames, gt = [], []
    T = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        il, _, _ = h.render_world(cam, T, pts)
        ir, _, _ = h.render_world(cam, (T_r @ T).astype(np.float32), pts)
        frames.append((il, ir))
        gt.append(T)
        T = (delta @ T).astype(np.float32)
    return frames, np.stack(gt)


def run_system(n_frames: int = N_FRAMES, n_warm: int = N_WARM,
               seed: int = 0, loop_closing: bool = True) -> dict:
    """Track a rendered sequence through System.track_stereo with the
    production driver; every dispatched frame and mapper job has executed
    when this returns. Returns the run's metrics and the System."""
    import jax

    from hyslam_tpu.core.mapstate import MapCaps
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.io.config import CameraConfig, SystemConfig
    from hyslam_tpu.io.evaluate import ate_rmse
    from hyslam_tpu.slam.system import System

    cam = slam_camera()
    frames, gt = render_sequence(cam, n_frames, seed)
    cc = CameraConfig(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
        height=cam.height, bf=cam.bf, th_depth=cam.th_depth,
        extractor=ExtractorConfig(n_features=1000, n_levels=8,
                                  scale_factor=1.2),
    )
    sysm = System(SystemConfig(
        cameras={"SLAM": cc}, caps=MapCaps(),
        enable_loop_closing=loop_closing, async_tracking=True,
    ))
    tr = sysm.trackers["SLAM"]

    def feed(i):
        sysm.track_stereo(*frames[i], timestamp=FRAME_DT * i, frame_id=i)

    def drain():
        """flush + a real host fetch of the map and the last mapper
        counters: every queued device program has run afterwards."""
        sysm.flush()
        stats = [t.mapper_stats for t in tr.telemetry if t.mapper_stats]
        return jax.device_get((tr.ms.kf.Tcw, tr.ms.lm.pos, tr.ms.next_kf,
                               stats[-1] if stats else {}))

    t0 = time.perf_counter()
    for i in range(n_warm):
        feed(i)
    drain()
    t_warm = time.perf_counter() - t0
    per_frame = []
    t1 = time.perf_counter()
    for i in range(n_warm, n_frames):
        ts = time.perf_counter()
        feed(i)
        per_frame.append(time.perf_counter() - ts)
    _, _, next_kf, mapper_counters = drain()
    t_timed = time.perf_counter() - t1

    n = int(np.asarray(tr.traj.size))
    est = np.asarray(tr.traj.Tcw[:n])
    idx = np.clip(np.round(np.asarray(tr.traj.t[:n]) / FRAME_DT).astype(int),
                  0, n_frames - 1)
    return {
        "system": sysm,
        "state": tr.state.name,
        "keyframes": int(next_kf),
        "tracked_fraction": n / n_frames,
        "ate_m": ate_rmse(est, gt[idx]),
        "warm_s": t_warm,
        "fps": (n_frames - n_warm) / t_timed,
        "dispatch_ms_median": 1e3 * float(np.median(per_frame)),
        "mapper_counters": {k: np.asarray(v).tolist()
                            for k, v in mapper_counters.items()},
    }


def phase_system() -> dict:
    from hyslam_tpu.slam.global_ba import run_global_ba

    r = run_system()
    sysm = r.pop("system")
    log(f"system: state {r['state']}  keyframes {r['keyframes']}  tracked "
        f"{r['tracked_fraction']:.3f}  ATE {r['ate_m']:.4f} m")
    log(f"system: {r['fps']:.2f} frames/s over frames {N_WARM}-"
        f"{N_FRAMES - 1} (per-frame {1e3 / r['fps']:.1f} ms, dispatch "
        f"median {r['dispatch_ms_median']:.1f} ms); first {N_WARM} frames "
        f"incl. compile {r['warm_s']:.1f} s")
    log(f"system: last mapper counters {r['mapper_counters']}")
    failures = []
    if r["state"] != "NORMAL":
        failures.append(f"state {r['state']} != NORMAL")
    if r["keyframes"] < MIN_KEYFRAMES:
        failures.append(f"{r['keyframes']} keyframes < {MIN_KEYFRAMES}")
    if r["tracked_fraction"] < MIN_TRACKED:
        failures.append(f"tracked {r['tracked_fraction']} < {MIN_TRACKED}")
    if not r["ate_m"] < ATE_BOUND_M:
        failures.append(f"ATE {r['ate_m']} m >= {ATE_BOUND_M} m")

    tr = sysm.trackers["SLAM"]
    cam = sysm.cameras["SLAM"]
    t0 = time.perf_counter()
    _, cost0 = run_global_ba(tr.ms, cam, n_iters=0)
    _, cost = run_global_ba(tr.ms, cam, n_iters=10)
    log(f"global BA: cost {cost0:.6g} -> {cost:.6g} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    if not (np.isfinite(cost) and cost <= cost0):
        failures.append(f"global BA cost {cost0} -> {cost}")
    sysm.shutdown()
    if failures:
        raise AssertionError("main path: " + "; ".join(failures))
    return r


# ------------------------------------------------------------ --cards 4

def pose_graph_problem(K: int, n_dev: int):
    """Drifted Sim3 chain of K keyframes with loop edges every 64
    keyframes; edges padded to a multiple of n_dev."""
    import jax
    import jax.numpy as jnp

    from hyslam_tpu.geometry import sim3

    xi = jnp.asarray([0.0, 0.0, 2 * np.pi / K, 0.0, 0.4, 0.0, 0.0])
    drift = sim3.exp(jnp.asarray([0.0, 0.0, 0.002, 0.0, 0.01, 0.0, 0.0]))
    k = jnp.arange(K, dtype=jnp.float32)[:, None]
    g_true = jax.vmap(sim3.exp)(k * xi)
    step_est = sim3.log(sim3.compose(drift, sim3.exp(xi)))
    g_est = jax.vmap(sim3.exp)(k * step_est)
    ei = list(range(K - 1)) + list(range(0, K - 64, 64)) + [0]
    ej = list(range(1, K)) + list(range(64, K, 64)) + [K - 1]
    pad = (-len(ei)) % n_dev
    valid = jnp.asarray([True] * len(ei) + [False] * pad)
    ei = jnp.asarray(ei + [0] * pad, jnp.int32)
    ej = jnp.asarray(ej + [0] * pad, jnp.int32)
    meas = jax.vmap(lambda i, j: sim3.compose(
        g_true[j], sim3.inverse(g_true[i])))(ei, ej)
    fixed = jnp.arange(K) == 0
    return g_est, fixed, ei, ej, meas, valid


def _pose_gap(Ta, Tb):
    """Largest rotation (rad, from the Frobenius gap of the rotation
    blocks) and translation (m) difference of two [K,4,4] pose stacks."""
    dR = np.linalg.norm(Ta[:, :3, :3] - Tb[:, :3, :3], axis=(1, 2))
    return (float(np.max(dR)) / np.sqrt(2.0),
            float(np.max(np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]))))


def run_multicard(n_dev: int = 4, K: int = 512, L: int = 65536, O: int = 8,
                  n_iters: int = 10, reps: int = 3) -> dict:
    """Distributed BA (1-D and 2-D meshes) and pose graph against the
    one-card solvers on the same problem; iters/s on one card and on
    n_dev."""
    import jax
    import jax.numpy as jnp

    from bench_multihost import build_problem
    from hyslam_tpu.parallel.dist_ba import (
        distributed_bundle_adjustment,
        distributed_bundle_adjustment_2d,
    )
    from hyslam_tpu.parallel.dist_pose_graph import distributed_pose_graph
    from hyslam_tpu.parallel.mesh import make_mesh, make_mesh_2d
    from hyslam_tpu.solver.ba import bundle_adjustment
    from hyslam_tpu.solver.pose_graph import _edge_residual, optimize_pose_graph

    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"{n_dev} devices needed, "
                           f"{len(jax.devices())} found")
    mesh = make_mesh(n_dev)
    mesh2 = make_mesh_2d(n_dev, kf=2)
    for m in (mesh, mesh2):
        ids = {d.id for d in m.devices.reshape(-1)}
        if len(ids) != n_dev:
            raise AssertionError(f"mesh {m.shape} spans devices {ids}")
    log(f"meshes: 1-D {dict(mesh.shape)}  2-D {dict(mesh2.shape)} over "
        f"devices {sorted(d.id for d in mesh.devices.reshape(-1))}")

    out, failures = {}, []
    limit = DIST_PHASE_LIMIT_S
    with phase("ba_reference", limit):
        prob = build_problem(K=K, L=L, O=O)
        ref = bundle_adjustment(prob, n_iters=n_iters)
        ref_T = np.asarray(ref.kf_Tcw)

    def check_ba(name, fn):
        with phase(name, limit):
            res = fn()
            cost, ref_cost = float(res.cost), float(ref.cost)
            d_rot, d_t = _pose_gap(np.asarray(res.kf_Tcw), ref_T)
            ips = n_iters / _timed(fn, reps, warm=False)
        out[name] = {"iters_per_s": ips, "cost": cost, "d_rot": d_rot,
                     "d_t": d_t}
        log(f"{name}: {ips:.3f} iters/s  cost {cost:.6g} (1 card "
            f"{ref_cost:.6g})  max pose gap {d_rot:.2e} rad {d_t:.2e} m")
        if not (abs(cost - ref_cost) <= DIST_COST_RTOL * ref_cost
                and d_rot <= DIST_POSE_TOL_RAD and d_t <= DIST_POSE_TOL_M):
            failures.append(name)

    g0, fixed, ei, ej, meas, valid = pose_graph_problem(K, n_dev)

    def pg_cost(g):
        r = jax.vmap(_edge_residual)(g[ei], g[ej], meas)
        return float(jnp.sum(valid * jnp.sum(r * r, -1)))

    def check_pg(name, fn):
        with phase(name, limit):
            g = fn()
            cost = pg_cost(g)
            gap = float(np.max(np.abs(np.asarray(g) - np.asarray(g_ref))))
            ips = 20 / _timed(fn, reps, warm=False)
        out[name] = {"iters_per_s": ips, "cost": cost, "max_gap": gap}
        log(f"{name}: {ips:.3f} iters/s  cost {cost:.6g} (1 card "
            f"{ref_cost:.6g}, start {start_cost:.6g})  max gap {gap:.2e}")
        if not (np.isfinite(cost) and gap <= DIST_PG_GAP
                and abs(cost - ref_cost) <= DIST_COST_RTOL * ref_cost
                + DIST_PG_COST_ATOL_START * start_cost):
            failures.append(name)

    def pg_1card():
        return optimize_pose_graph(g0, fixed, ei, ej, meas, valid,
                                   solver="dense")

    check_ba("ba_1card", lambda: bundle_adjustment(prob, n_iters=n_iters))
    check_ba("ba_1d", lambda: distributed_bundle_adjustment(
        prob, mesh, n_iters=n_iters))
    with phase("pose_graph_reference", limit):
        g_ref = pg_1card()
        ref_cost, start_cost = pg_cost(g_ref), pg_cost(g0)
    check_pg("pose_graph_1card", pg_1card)
    check_pg("pose_graph_dist", lambda: distributed_pose_graph(
        g0, fixed, ei, ej, meas, valid, mesh))
    # last: the only solver whose collectives span two mesh axes
    check_ba("ba_2d", lambda: distributed_bundle_adjustment_2d(
        prob, mesh2, n_iters=n_iters))
    if failures:
        raise AssertionError(f"distributed solvers disagree: {failures}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    with phase("device"):
        phase_device()
    if args.cards == 4:
        run_multicard(n_dev=4)
    else:
        with phase("pose_lm"):
            phase_pose_lm()
        with phase("system"):
            phase_system()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
