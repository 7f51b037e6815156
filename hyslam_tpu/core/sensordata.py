"""Per-keyframe auxiliary sensor data: GPS, IMU orientation, pressure depth.

Capability parity with src/core/SensorData.h:17-94 — GPS position
(lat/lon or a local metric frame) with per-axis error, an absolute
orientation quaternion from an AHRS IMU, and a scalar depth (pressure)
reading, each with a validity flag.

array-native design: instead of a per-KeyFrame member object, sensor readings
live in a SoA arena aligned 1:1 with the KeyFrame arena slots, so bundle
adjustment gathers them as arrays and turns them into batched unary pose
residuals (hyslam_tpu.solver.priors; reference behavior in
src/optimizers/BundleAdjustment.cc:60-180).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

# WGS84 ellipsoid
_WGS84_A = 6378137.0
_WGS84_E2 = 6.69437999014e-3


class SensorData(NamedTuple):
    """One frame's sensor record (host-side; SensorData.h:17-94).

    gps_rel:  (x, y, z) position in the local metric GPS frame
    gps_err:  per-axis 1-sigma error (same units)
    quat:     absolute orientation (w, x, y, z) of the camera (world->cam)
    depth:    scalar depth from pressure
    """

    gps_rel: Sequence[float] = (0.0, 0.0, 0.0)
    gps_err: Sequence[float] = (1.0, 1.0, 1.0)
    gps_valid: bool = False
    quat: Sequence[float] = (1.0, 0.0, 0.0, 0.0)
    quat_valid: bool = False
    depth: float = 0.0
    depth_valid: bool = False


class SensorArena(NamedTuple):
    """Per-keyframe sensor arrays, slot-aligned with the KeyFrame arena."""

    gps: jnp.ndarray         # [K, 3]
    gps_err: jnp.ndarray     # [K, 3]
    gps_valid: jnp.ndarray   # [K] bool
    quat: jnp.ndarray        # [K, 4] (w, x, y, z)
    quat_valid: jnp.ndarray  # [K] bool
    depth: jnp.ndarray       # [K]
    depth_valid: jnp.ndarray # [K] bool


def empty_sensor_arena(K: int) -> SensorArena:
    return SensorArena(
        gps=jnp.zeros((K, 3), jnp.float32),
        gps_err=jnp.ones((K, 3), jnp.float32),
        gps_valid=jnp.zeros((K,), bool),
        quat=jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (K, 1)),
        quat_valid=jnp.zeros((K,), bool),
        depth=jnp.zeros((K,), jnp.float32),
        depth_valid=jnp.zeros((K,), bool),
    )


def set_sensor(arena: SensorArena, k: int, sd: SensorData) -> SensorArena:
    """Functional write of one keyframe's sensor record."""
    return SensorArena(
        gps=arena.gps.at[k].set(jnp.asarray(sd.gps_rel, jnp.float32)),
        gps_err=arena.gps_err.at[k].set(jnp.asarray(sd.gps_err, jnp.float32)),
        gps_valid=arena.gps_valid.at[k].set(bool(sd.gps_valid)),
        quat=arena.quat.at[k].set(jnp.asarray(sd.quat, jnp.float32)),
        quat_valid=arena.quat_valid.at[k].set(bool(sd.quat_valid)),
        depth=arena.depth.at[k].set(float(sd.depth)),
        depth_valid=arena.depth_valid.at[k].set(bool(sd.depth_valid)),
    )


def latlon_to_relative(lat, lon, alt, lat0: float, lon0: float,
                       alt0: float = 0.0) -> np.ndarray:
    """Geodetic (deg) -> local east/north/up metric coordinates about a
    reference point (the reference's lat-lon -> UTM-relative conversion,
    SensorData.h GPS accessors; local-tangent form avoids a UTM dependency
    and is equivalent over survey-site extents)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    alt = np.asarray(alt, np.float64)
    phi = math.radians(lat0)
    s, c = math.sin(phi), math.cos(phi)
    # radii of curvature at the reference latitude
    den = math.sqrt(1.0 - _WGS84_E2 * s * s)
    Rn = _WGS84_A / den                        # prime vertical
    Rm = _WGS84_A * (1.0 - _WGS84_E2) / den**3  # meridian
    east = np.radians(lon - lon0) * (Rn + alt0) * c
    north = np.radians(lat - lat0) * (Rm + alt0)
    up = alt - alt0
    return np.stack([east, north, up], axis=-1).astype(np.float32)
