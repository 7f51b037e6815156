"""Geometry core: SO(3)/SE(3)/Sim(3) Lie groups, camera models, closed-form
alignment and triangulation.

This is the array-native replacement for the reference's scattered pose math
(cv::Mat 4x4 composition in src/core, g2o SE3Quat/Sim3 in Thirdparty/g2o,
`util/Converter.h` conversions, `optimizers/OptHelpers.h` Horn alignment).
Everything is batched, differentiable jnp operating on float32 arrays:

- poses are row-stacked homogeneous matrices ``[..., 4, 4]`` (Tcw = world->cam),
- tangent vectors are ``[..., 6]`` ordered (omega, upsilon) like g2o SE3Quat,
- Sim3 elements are ``(s, R, t)`` triples or ``[..., 8]`` packed vectors.
"""

from hyslam_tpu.geometry import se3, sim3, so3  # noqa: F401
from hyslam_tpu.geometry.camera import Camera  # noqa: F401
