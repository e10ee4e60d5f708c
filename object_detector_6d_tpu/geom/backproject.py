"""Depth -> organized point cloud back-projection (reference L1).

Mirrors depthTo3d / depthTo3dSparse (depth.hpp:291-312), verified against
the oracle to float32 precision: x = z*(u-cx)/fx, y = z*(v-cy)/fy, with
u16 input first rescaled to meters (0 -> NaN) exactly like the oracle.

This is pure fused elementwise work under jit; the (u-cx)/fx grids are
constants folded by XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.core.intrinsics import Intrinsics, pixel_grid
from object_detector_6d_tpu.geom.depth import rescale_depth


@jax.jit
def depth_to_3d(depth: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Organized cloud [H, W, 3] (meters) from depth [H, W] and 3x3 K.

    Integer depth is treated as millimeters (converted to meters, 0 -> NaN);
    float depth is used as-is, matching the oracle.
    """
    z = rescale_depth(depth)
    H, W = z.shape
    intr = Intrinsics.from_matrix(K)
    u, v = pixel_grid(H, W)
    x = z * (u - intr.cx) / intr.fx
    y = z * (v - intr.cy) / intr.fy
    return jnp.stack([x, y, z], axis=-1)


@jax.jit
def depth_to_3d_sparse(u: jnp.ndarray, v: jnp.ndarray, z: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Back-project sparse pixel lists (depthTo3dSparse, depth.hpp:297-299).

    ``z`` must already be metric (float); use rescale_depth for raw u16.
    """
    intr = Intrinsics.from_matrix(K)
    return intr.reproject(jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32), z)
