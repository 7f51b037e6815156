"""BA throughput on one device (BASELINE: "BA iterations/s at 1 chip").

Sweeps bundle_adjustment over K keyframes at L=65536 landmarks / O=8
observation slots, for both the dense Schur path (materializes the
[6K,6K] reduced system via rank-3C matmul chunks) and the matrix-free
block-Jacobi PCG path, and reports measured iterations/s plus an analytic
FLOP estimate -> achieved FLOP/s. Roofline shares need a peak table keyed
by device kind, which this tool does not keep.

FLOP model per LM iteration (counts multiply-adds as 2 FLOPs):
  linearize:     ~700 * L * O       (residuals, jacobians, Hpp/V/W einsums)
  dense Schur:   216 * L * K^2      (Zf^T Zf chunk matmuls)
  dense solve:   (2/3) * (6K)^3     (Cholesky-class)
  CG:            n_cg * (4 * 36 * L * O + 2 * 36 * K)   (two Y-products
                 + diag precond per step; n_cg = 200 maxiter bound)
  backsub:       ~60 * L * O

    python tools/bench_ba.py [out.json]
"""

from __future__ import annotations

import json
import sys
import time

sys.path.insert(0, ".")

from bench_multihost import build_problem  # noqa: E402


def flops_per_iter(K: int, L: int, O: int, solver: str, n_cg: int = 200):
    lin = 700.0 * L * O
    back = 60.0 * L * O
    if solver == "dense":
        schur = 216.0 * L * K * K
        solve = (2.0 / 3.0) * (6 * K) ** 3
        return lin + schur + solve + back
    cg = n_cg * (4.0 * 36 * L * O + 2.0 * 36 * K)
    return lin + cg + back


def run(K: int, solver: str, L=65536, O=8, n_iters=10, reps=3):
    import jax
    from hyslam_tpu.solver.ba import bundle_adjustment

    import numpy as np

    prob = build_problem(K=K, L=L, O=O)
    res = bundle_adjustment(prob, n_iters=n_iters, solver=solver)
    _ = np.asarray(res.cost)                   # compile + warm (real fetch)
    t0 = time.perf_counter()
    for _ in range(reps):
        # chain the reps (each consumes the previous poses) and end with a
        # real device->host fetch, so every rep has executed
        res = bundle_adjustment(prob._replace(kf_Tcw=res.kf_Tcw),
                                n_iters=n_iters, solver=solver)
    _ = np.asarray(res.cost)
    dt = (time.perf_counter() - t0) / reps
    ips = n_iters / dt
    fl = flops_per_iter(K, L, O, solver)
    return {
        "K": K, "L": L, "O": O, "solver": solver,
        "iters_per_s": round(ips, 2),
        "s_per_iter": round(dt / n_iters, 4),
        "est_tflops_per_iter": round(fl / 1e12, 3),
        "achieved_tflops": round(ips * fl / 1e12, 2),
        "final_cost": float(res.cost),
    }


def main(out_path=None):
    import jax

    dev = jax.devices()[0]
    rows = []
    for K, solver in [(64, "dense"), (256, "dense"),
                      (256, "cg"), (1024, "cg"), (2048, "cg")]:
        try:
            row = run(K, solver)
        except Exception as e:   # record it, finish the sweep, exit 1
            row = {"K": K, "solver": solver, "error": repr(e)[:300]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"platform": dev.platform, "kind": dev.device_kind,
                       "rows": rows}, f, indent=1)
    return int(any("error" in r for r in rows))


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main(out_path=sys.argv[1] if len(sys.argv) > 1
                          else None))
