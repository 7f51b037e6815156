"""Pose-only LM in one GPU kernel (Pallas, Triton route).

The plain solver (solver/pose_opt.py) lowers each LM iteration to a handful
of fused kernels plus a 6x6 `linalg.solve`, inside two nested scans: several
hundred small launches per call, each a reduction over N observations. Here
the complete Optimizer::PoseOptimization schedule -- 4 rounds x 10 LM
iterations, Huber weights, chi2 outlier reclassification between rounds --
runs in ONE program of one thread block:

- residuals and Jacobians are [N]-vector expressions held in registers,
- the 6x6 normal equations are 21+6 block reductions,
- the Cholesky solve and the SE(3) update are unrolled scalar arithmetic.

N is padded to a power of two (Triton's block shapes); padded rows repeat
the last observation with `valid` = 0, so they are finite and carry no
weight. The pose travels through the loop carry as R (9) + t (3) scalars.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.solver.robust import CHI2_MONO, CHI2_STEREO

# warps of the single block: 8 x 32 threads hold 4 observations each at
# N=1024, which keeps the 18 Jacobian rows in registers
NUM_WARPS = 8


def _chol6_solve(H, b):
    """Unrolled 6x6 Cholesky solve on scalar values. H: [6][6] nested list
    of scalars (symmetric), b: [6] list. Returns [6] list."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = H[i][i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-12))
        for j in range(i + 1, 6):
            s = H[j][i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s / L[i][i]
    # forward substitution L y = b
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _so3_exp_scalars(w0, w1, w2):
    """Rodrigues on scalars -> 9 rotation entries (f32-safe small-angle)."""
    t2 = w0 * w0 + w1 * w1 + w2 * w2
    small = t2 < 0.25
    st2 = jnp.where(small, 1.0, t2)
    t = jnp.sqrt(st2)
    t4 = t2 * t2
    A = jnp.where(small, 1.0 - t2 / 6.0 + t4 / 120.0, jnp.sin(t) / t)
    sh = jnp.sin(0.5 * t)
    B = jnp.where(small, 0.5 - t2 / 24.0 + t4 / 720.0, 2.0 * sh * sh / st2)
    r00 = 1.0 + B * (-w2 * w2 - w1 * w1)
    r01 = -A * w2 + B * w0 * w1
    r02 = A * w1 + B * w0 * w2
    r10 = A * w2 + B * w0 * w1
    r11 = 1.0 + B * (-w2 * w2 - w0 * w0)
    r12 = -A * w0 + B * w1 * w2
    r20 = -A * w1 + B * w0 * w2
    r21 = A * w0 + B * w1 * w2
    r22 = 1.0 + B * (-w1 * w1 - w0 * w0)
    return (r00, r01, r02, r10, r11, r12, r20, r21, r22), (A, B)


def _se3_exp_scalars(xi):
    """xi: 6 scalars (w, v) -> (R 9 scalars, t 3 scalars)."""
    w0, w1, w2, v0, v1, v2 = xi
    R, (A, B) = _so3_exp_scalars(w0, w1, w2)
    t2 = w0 * w0 + w1 * w1 + w2 * w2
    small = t2 < 0.25
    st2 = jnp.where(small, 1.0, t2)
    t4 = t2 * t2
    C = jnp.where(
        small, 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0,
        (1.0 - A) / st2,
    )
    # V = I + B*hat + C*hat^2 ; t = V v
    # hat @ v = w x v
    cx = w1 * v2 - w2 * v1
    cy = w2 * v0 - w0 * v2
    cz = w0 * v1 - w1 * v0
    # hat^2 @ v = w x (w x v)
    c2x = w1 * cz - w2 * cy
    c2y = w2 * cx - w0 * cz
    c2z = w0 * cy - w1 * cx
    tx = v0 + B * cx + C * c2x
    ty = v1 + B * cy + C * c2y
    tz = v2 + B * cz + C * c2z
    return R, (tx, ty, tz)


def _compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): R = Ra Rb, t = Ra tb + ta (scalar 3x3)."""
    R = [None] * 9
    for i in range(3):
        for j in range(3):
            R[3 * i + j] = (
                Ra[3 * i + 0] * Rb[0 + j]
                + Ra[3 * i + 1] * Rb[3 + j]
                + Ra[3 * i + 2] * Rb[6 + j]
            )
    t = [
        Ra[0] * tb[0] + Ra[1] * tb[1] + Ra[2] * tb[2] + ta[0],
        Ra[3] * tb[0] + Ra[4] * tb[1] + Ra[5] * tb[2] + ta[1],
        Ra[6] * tb[0] + Ra[7] * tb[1] + Ra[8] * tb[2] + ta[2],
    ]
    return R, t


def _make_kernel(cam: Camera, n_rounds: int, iters_per_round: int):
    fx, fy, cx, cy, bf = cam.fx, cam.fy, cam.cx, cam.cy, cam.bf

    def kernel(T0_ref, X0_ref, X1_ref, X2_ref, u_ref, v_ref, ur_ref,
               is2_ref, valid_ref, st_ref, Tout_ref, c2_ref):
        X0 = X0_ref[...]
        X1 = X1_ref[...]
        X2 = X2_ref[...]
        u_o = u_ref[...]
        v_o = v_ref[...]
        ur_o = ur_ref[...]
        is2 = is2_ref[...]
        valid = valid_ref[...]
        st = st_ref[...]
        th_vec = jnp.where(st > 0, CHI2_STEREO, CHI2_MONO)
        stm = (st > 0).astype(jnp.float32)

        # the pose enters and leaves as a flat [16] row-major 4x4: scalars
        # are picked out of (and put back into) the block with iota selects
        lane = jax.lax.broadcasted_iota(jnp.int32, (16,), 0)
        T0 = T0_ref[...]

        def pick(k):
            return jnp.sum(jnp.where(lane == k, T0, 0.0))

        def residual_terms(R, t):
            px = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0]
            py = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1]
            pz = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2]
            zs = jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
            iz = 1.0 / zs
            iz2 = iz * iz
            ru = fx * px * iz + cx - u_o
            rv = fy * py * iz + cy - v_o
            rr = jnp.where(st > 0, fx * px * iz + cx - bf * iz - ur_o, 0.0)
            c2 = is2 * (ru * ru + rv * rv + rr * rr)
            c2 = jnp.where(pz > 0.05, c2, 1e9)
            return px, py, pz, iz, iz2, ru, rv, rr, c2

        def weighted_cost(use_huber, active, ru, rv, rr, c2):
            hub = jnp.where(
                use_huber,
                jnp.where(c2 <= th_vec, 1.0,
                          jnp.sqrt(th_vec / jnp.maximum(c2, 1e-12))),
                1.0,
            )
            w = is2 * hub * active
            return w, jnp.sum(w * (ru * ru + rv * rv + rr * rr))

        def one_round(ridx, rstate):
            Rt, active = rstate
            use_huber = ridx < 2   # the reference drops the kernel after 2

            def lm_iter(_i, istate):
                (R, t), lam, _ = istate
                px, py, pz, iz, iz2, ru, rv, rr, c2 = residual_terms(R, t)
                w, cost = weighted_cost(use_huber, active, ru, rv, rr, c2)

                # Jacobian rows (d resid / d (omega, upsilon)):
                # J_u = fx*iz*dpx - fx*px*iz2*dpz ; dp/ddelta = [-hat(p)|I]
                # dpx/dd = (0, pz, -py, 1, 0, 0)
                # dpy/dd = (-pz, 0, px, 0, 1, 0)
                # dpz/dd = (py, -px, 0, 0, 0, 1)
                au = fx * iz
                av = fy * iz
                bu = fx * px * iz2
                bv = fy * py * iz2
                zero = jnp.zeros_like(au)
                Ju = [-bu * py, au * pz + bu * px, -au * py, au, zero, -bu]
                Jv = [-av * pz - bv * py, bv * px, av * px, zero, av, -bv]
                br = (fx * px - bf) * iz2
                Jr = [j * stm for j in
                      (-br * py, au * pz + br * px, -au * py, au, zero, -br)]

                # normal equations (upper triangle) + gradient
                H = [[None] * 6 for _ in range(6)]
                g = [None] * 6
                for i in range(6):
                    gi = -(Ju[i] * ru + Jv[i] * rv + Jr[i] * rr)
                    g[i] = jnp.sum(w * gi)
                    for j in range(i, 6):
                        hij = Ju[i] * Ju[j] + Jv[i] * Jv[j] + Jr[i] * Jr[j]
                        H[i][j] = jnp.sum(w * hij)
                for i in range(6):
                    for j in range(i):
                        H[i][j] = H[j][i]
                for i in range(6):
                    H[i][i] = H[i][i] + lam * jnp.maximum(H[i][i], 1e-6)

                dx = _chol6_solve(H, g)
                finite = jnp.isfinite(dx[0])
                for d in dx[1:]:
                    finite = finite & jnp.isfinite(d)
                Rd, td = _se3_exp_scalars(dx)
                Rn, tn = _compose(Rd, td, R, t)
                _, _, _, _, _, ru2, rv2, rr2, c22 = residual_terms(Rn, tn)
                _, cost2 = weighted_cost(use_huber, active, ru2, rv2, rr2,
                                         c22)
                accept = (cost2 < cost) & finite
                R_out = [jnp.where(accept, Rn[i], R[i]) for i in range(9)]
                t_out = [jnp.where(accept, tn[i], t[i]) for i in range(3)]
                lam_out = jnp.clip(
                    jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6
                )
                return ((R_out, t_out), lam_out,
                        jnp.where(accept, cost2, cost))

            init = (Rt, jnp.float32(1e-3), jnp.float32(np.inf))
            (Rt, _, _) = jax.lax.fori_loop(
                0, iters_per_round, lm_iter, init
            )
            R, t = Rt
            c2 = residual_terms(R, t)[-1]
            active_next = (valid > 0) & (c2 <= th_vec)
            return (Rt, active_next.astype(jnp.float32))

        R0 = [pick(4 * i + j) for i in range(3) for j in range(3)]
        t0 = [pick(4 * i + 3) for i in range(3)]
        ((R, t), _) = jax.lax.fori_loop(
            0, n_rounds, one_round, ((R0, t0), valid)
        )
        c2_ref[...] = residual_terms(R, t)[-1]
        flat = {4 * i + j: R[3 * i + j] for i in range(3) for j in range(3)}
        flat.update({4 * i + 3: t[i] for i in range(3)})
        out = jnp.where(lane == 15, 1.0, 0.0)
        for k, val in flat.items():
            out = jnp.where(lane == k, val, out)
        Tout_ref[...] = out

    return kernel


def padded_size(n: int) -> int:
    """Block length for n observations: the next power of two (>= 16)."""
    return max(16, 1 << (int(n) - 1).bit_length())


@partial(jax.jit, static_argnames=("cam", "n_rounds", "iters_per_round",
                                   "interpret"))
def pose_optimization_pallas(
    cam: Camera,
    Tcw0: jnp.ndarray,
    X: jnp.ndarray,          # [N, 3]
    uv: jnp.ndarray,         # [N, 2]
    ur: jnp.ndarray,         # [N]
    inv_sigma2: jnp.ndarray, # [N]
    valid: jnp.ndarray,      # [N] bool
    stereo: jnp.ndarray,     # [N] bool
    n_rounds: int = 4,
    iters_per_round: int = 10,
    interpret: bool = False,
):
    """The whole pose-LM schedule in one kernel launch.

    Returns (Tcw [4,4], chi2 [N]) -- chi2 of every row at the final pose,
    1e9 behind the camera, as solver.pose_opt computes it. `interpret`
    runs the kernel through the Pallas interpreter (CPU tests only)."""
    N = X.shape[0]
    Np = padded_size(N)

    def col(a, fill_valid=False):
        a = a.astype(jnp.float32)
        if Np == N:
            return a
        if fill_valid:   # padded rows carry no weight
            return jnp.pad(a, (0, Np - N))
        return jnp.pad(a, (0, Np - N), mode="edge")

    operands = (
        Tcw0.astype(jnp.float32).reshape(16),
        col(X[:, 0]), col(X[:, 1]), col(X[:, 2]),
        col(uv[:, 0]), col(uv[:, 1]), col(ur), col(inv_sigma2),
        col(valid, fill_valid=True), col(stereo),
    )
    Tout, c2 = pl.pallas_call(
        _make_kernel(cam, n_rounds, iters_per_round),
        out_shape=(
            jax.ShapeDtypeStruct((16,), jnp.float32),
            jax.ShapeDtypeStruct((Np,), jnp.float32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="pose_lm",
    )(*operands)
    return Tout.reshape(4, 4), c2[:N]
