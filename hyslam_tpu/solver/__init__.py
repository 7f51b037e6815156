"""Nonlinear least-squares solvers: the array-native replacement for the
reference's g2o Levenberg-Marquardt stack (src/optimizers/*, Thirdparty/g2o).

Design (SURVEY.md §7.1): residuals/Jacobians are batched closed-form jnp;
map-point marginalization (g2o setMarginalized, BundleAdjustment.cc:221) is a
dense Schur complement assembled with einsum/segment_sum and solved with a
dense Cholesky factorization; robust Huber weighting and the reference's
chi2 outlier-demotion schedule are preserved.
"""

from hyslam_tpu.solver.pose_opt import pose_optimization  # noqa: F401
from hyslam_tpu.solver.ba import bundle_adjustment  # noqa: F401
