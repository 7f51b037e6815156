"""Matmul-precision pinning for the solver stack.

JAX's default matmul precision on the GPU runs f32 dot products in TF32
(10-bit mantissa) on the tensor cores. The LM/Schur/pose-graph solvers
accumulate normal equations and compose pose chains where that rounding
visibly moves the optimum (an earlier reduced-precision backend showed it:
loop closure stopped reducing ATE while every solver test passed on f32
CPU).

`f32` wraps a solver entry point so everything traced inside it uses full
float32 matmuls; tiny fixed-size contractions in geometry ops additionally
pin `precision=HIGHEST` at the call site (free: 3x3/4x4 contractions are
far too small for the tensor cores to matter).
"""

from __future__ import annotations

import functools

import jax

# per-op pin for small geometry contractions
HIGHEST = jax.lax.Precision.HIGHEST


def f32(fn):
    """Decorator: trace/run `fn` under full-float32 matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
