"""Multi-device / multi-host scaling: device meshes + distributed bundle
adjustment via Schur-complement reduction over psum (SURVEY.md §2.10 —
the reference is single-process; this is the scale-out design this
build adds: keyframes replicated, landmark/observation blocks sharded)."""

from hyslam_tpu.parallel.mesh import make_mesh  # noqa: F401
from hyslam_tpu.parallel.dist_ba import distributed_bundle_adjustment  # noqa: F401
