"""Headless visualization layer (capability parity with src/viz:
Viewer.h, FrameDrawer.h, MapDrawer.h).

The reference renders into a Pangolin/OpenGL window from a dedicated
thread; an accelerator host has no display, so this package renders the same
artifacts — annotated current-frame images and a 3D map view (points,
keyframe frusta, covisibility graph, trajectory, current camera) — into
numpy RGB images written as PNG, either on demand or fps-paced from the
Viewer loop.
"""

from hyslam_tpu.viz.frame_drawer import FrameDrawer, draw_frame
from hyslam_tpu.viz.map_drawer import MapDrawer, draw_map
from hyslam_tpu.viz.viewer import Viewer
from hyslam_tpu.viz.draw2d import write_png

__all__ = [
    "FrameDrawer", "draw_frame", "MapDrawer", "draw_map", "Viewer",
    "write_png",
]
