"""BA scaling benchmark: LM iterations/s of distributed bundle adjustment
at 1 device vs N devices (BASELINE.md: BA iters/s at 1 chip / 1 host /
N hosts).

On a machine with fewer devices, run it on a virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python bench_multihost.py

Prints one JSON line per mesh size with ba_iters_per_s and the scaling
efficiency vs 1 device.
"""

from __future__ import annotations

import json
import time

import numpy as np


def build_problem(K=64, L=65536, O=8, seed=0):
    import jax.numpy as jnp
    from hyslam_tpu.solver.ba import BAObservations, BAProblem, CamArrays

    rng = np.random.default_rng(seed)
    fx = fy = 450.0
    cx, cy, bf = 320.0, 240.0, 45.0
    pts = np.stack([rng.uniform(-10, 10, L), rng.uniform(-6, 6, L),
                    rng.uniform(4, 40, L)], -1).astype(np.float32)
    kf_T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_T[:, 2, 3] = -0.3 * np.arange(K)
    obs_kf = rng.integers(0, K, (L, O)).astype(np.int32)
    pc = np.einsum("loij,lj->loi", kf_T[obs_kf][..., :3, :3], pts) + \
        kf_T[obs_kf][..., :3, 3]
    z = np.maximum(pc[..., 2], 0.5)
    uv = np.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy],
                  -1).astype(np.float32)
    uv += rng.normal(0, 0.4, uv.shape).astype(np.float32)
    return BAProblem(
        kf_Tcw=jnp.asarray(kf_T),
        kf_fixed=jnp.asarray(np.arange(K) < 1),
        cams=CamArrays(fx=jnp.full(K, fx), fy=jnp.full(K, fy),
                       cx=jnp.full(K, cx), cy=jnp.full(K, cy),
                       bf=jnp.full(K, bf)),
        lm_pos=jnp.asarray(
            pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        lm_valid=jnp.ones(L, bool),
        obs=BAObservations(
            kf=jnp.asarray(obs_kf), uv=jnp.asarray(uv),
            ur=(jnp.asarray(uv[..., 0]) - bf / jnp.asarray(z)),
            inv_sigma2=jnp.ones((L, O), jnp.float32),
            stereo=jnp.ones((L, O), bool),
            valid=jnp.asarray(z > 0.5),
        ),
    )


def run_at(n_devices: int, prob, n_iters=10, reps=3):
    import jax
    from hyslam_tpu.parallel.mesh import make_mesh
    from hyslam_tpu.parallel.dist_ba import distributed_bundle_adjustment

    mesh = make_mesh(n_devices)
    res = distributed_bundle_adjustment(prob, mesh, n_iters=n_iters)
    jax.block_until_ready(res.kf_Tcw)   # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        res = distributed_bundle_adjustment(prob, mesh, n_iters=n_iters)
    jax.block_until_ready(res.kf_Tcw)
    dt = (time.perf_counter() - t0) / reps
    return n_iters / dt, float(res.cost)


def main(out_path=None):
    import jax

    n_dev = len(jax.devices())
    prob = build_problem()
    sweep = [d for d in (1, 2, 4, 8) if d <= n_dev]
    rows, base_ips = [], None
    for d in sweep:
        ips, cost = run_at(d, prob)
        if base_ips is None:
            base_ips = ips
        row = {
            "metric": "ba_iters_per_s", "devices": d,
            "value": round(ips, 2), "unit": "iters/s",
            "scaling_efficiency": round(ips / (base_ips * d), 3),
            "cost": cost,
        }
        if d > 1 and jax.devices()[0].platform == "cpu":
            # virtual CPU devices share the same physical cores: this run
            # validates the sharded path, not real scaling
            row["note"] = "virtual-device mesh; efficiency not meaningful"
        rows.append(row)
        print(json.dumps(row))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"platform": jax.devices()[0].platform,
                       "problem": {"K": 64, "L": 65536, "O": 8},
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    import sys

    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(out_path=sys.argv[1] if len(sys.argv) > 1 else None)
