"""hyslam_tpu — a SLAM/SfM engine for the GPU (JAX / XLA / Pallas).

A from-scratch re-design of the capabilities of bmhopkinson/hyslam (an
ORB-SLAM2-derived hybrid SLAM/SfM system for ecosystem mapping) as batched
array programs, run on an NVIDIA GPU:

- ORB feature extraction / descriptor matching as batched XLA programs
  (:mod:`hyslam_tpu.ops`, :mod:`hyslam_tpu.features`), the per-frame pose LM
  as one Pallas kernel (Triton route) on the GPU,
- the state-machine tracker and job-based mapper re-expressed as batched JAX
  programs over SoA map arenas (:mod:`hyslam_tpu.slam`, :mod:`hyslam_tpu.core`),
- g2o's LM bundle adjustment replaced by a JAX Levenberg-Marquardt solver with
  dense Schur-complement reduction (:mod:`hyslam_tpu.solver`),
- multi-camera, recursive multi-map/sub-map trees, per-frame trajectories, and
  dual-camera imaging BA preserved as first-class subsystems,
- multi-device scaling via jax.sharding meshes + psum-reduced Schur assembly
  (:mod:`hyslam_tpu.parallel`).

See SURVEY.md at the repo root for the structural map of the reference system
(citations of the form ``file:line`` in module docstrings point into
``/root/reference``, the reference implementation this engine re-creates).
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/solver correctness requires true float32 accumulation: on the GPU
# float32 matmuls otherwise run in TF32 (10-bit mantissa), whose rounding
# moves pose math (3x3 Rodrigues products, Schur blocks) off the float32
# result the solvers' tolerances assume. Kernels whose inputs are exact in bf16
# (descriptor Hamming matmuls) opt back in explicitly with
# precision=DEFAULT / preferred_element_type.
_jax.config.update("jax_default_matmul_precision", "highest")

from hyslam_tpu.geometry import se3, so3, sim3  # noqa: F401
