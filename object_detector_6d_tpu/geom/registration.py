"""Depth registration & frame warping (reference N6 registerDepth
depth.hpp:267-289, and warpFrame depth.hpp:~1164).

Both are scatter-style reprojections:

* ``register_depth``: reproject a depth image from one camera's frame
  into another camera (extrinsics Rt, target intrinsics K2), z-buffered.
* ``warp_frame``: warp a depth (+ optional image) by a rigid transform
  within the same camera — the "render the frame as seen after moving
  by Rt" op used by odometry testing.

Device formulation: the scatter is a ``.at[idx].min()`` over flat
pixel indices (XLA scatter-min) — no host loops; invalid/occluded pixels
resolve by depth ordering exactly like a z-buffer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.core.intrinsics import Intrinsics, pixel_grid
from object_detector_6d_tpu.geom.depth import rescale_depth


def _project_scatter_depth(points, K_target, out_h, out_w):
    """Scatter camera-frame points into a z-buffered depth image [H, W]."""
    intr = Intrinsics.from_matrix(K_target)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    u = jnp.round(intr.fx * x / z + intr.cx).astype(jnp.int32)
    v = jnp.round(intr.fy * y / z + intr.cy).astype(jnp.int32)
    ok = (u >= 0) & (u < out_w) & (v >= 0) & (v < out_h) & (z > 0) & jnp.isfinite(z)
    flat = jnp.where(ok, v * out_w + u, out_h * out_w)  # sentinel slot
    big = jnp.float32(jnp.inf)
    zz = jnp.where(ok, z, big)
    depth = jnp.full((out_h * out_w + 1,), big, jnp.float32)
    depth = depth.at[flat.reshape(-1)].min(zz.reshape(-1))
    depth = depth[:-1].reshape(out_h, out_w)
    return jnp.where(jnp.isfinite(depth), depth, jnp.nan)


@functools.partial(jax.jit, static_argnames=("out_shape",))
def register_depth(
    depth: jnp.ndarray,
    K_src: jnp.ndarray,
    K_dst: jnp.ndarray,
    Rt: jnp.ndarray,
    out_shape: tuple,
) -> jnp.ndarray:
    """Reproject ``depth`` (u16 mm or f32 m) into a second camera.

    ``Rt`` maps source-camera points into the target camera frame.
    Returns f32 meters with NaN holes (no dilation of missing data).
    """
    z = rescale_depth(depth)
    H, W = z.shape
    intr = Intrinsics.from_matrix(K_src)
    u, v = pixel_grid(H, W)
    pts = jnp.stack(
        [z * (u - intr.cx) / intr.fx, z * (v - intr.cy) / intr.fy, z], -1
    )
    Rt = jnp.asarray(Rt, jnp.float32)
    pts = jnp.matmul(pts, Rt[:3, :3].T,
                     precision=jax.lax.Precision.HIGHEST) + Rt[:3, 3]
    return _project_scatter_depth(pts, K_dst, out_shape[0], out_shape[1])


@functools.partial(jax.jit, static_argnames=())
def warp_frame(
    depth: jnp.ndarray,
    K: jnp.ndarray,
    Rt: jnp.ndarray,
    image: jnp.ndarray | None = None,
):
    """Warp a depth frame (and optionally an image) by a rigid transform
    within the same camera (cv::rgbd::warpFrame semantics: forward warp
    with z-buffering; unobserved target pixels are NaN/0).
    """
    z = rescale_depth(depth)
    H, W = z.shape
    intr = Intrinsics.from_matrix(K)
    u, v = pixel_grid(H, W)
    pts = jnp.stack(
        [z * (u - intr.cx) / intr.fx, z * (v - intr.cy) / intr.fy, z], -1
    )
    Rt = jnp.asarray(Rt, jnp.float32)
    pts = jnp.matmul(pts, Rt[:3, :3].T,
                     precision=jax.lax.Precision.HIGHEST) + Rt[:3, 3]
    x, y, zz = pts[..., 0], pts[..., 1], pts[..., 2]
    un = jnp.round(intr.fx * x / zz + intr.cx).astype(jnp.int32)
    vn = jnp.round(intr.fy * y / zz + intr.cy).astype(jnp.int32)
    ok = (un >= 0) & (un < W) & (vn >= 0) & (vn < H) & (zz > 0) & jnp.isfinite(zz)
    flat = jnp.where(ok, vn * W + un, H * W)
    big = jnp.float32(jnp.inf)
    zflat = jnp.where(ok, zz, big).reshape(-1)
    zbuf = jnp.full((H * W + 1,), big, jnp.float32).at[flat.reshape(-1)].min(zflat)
    warped_depth = jnp.where(jnp.isfinite(zbuf[:-1]), zbuf[:-1], jnp.nan).reshape(H, W)
    if image is None:
        return warped_depth
    # winner-takes-pixel for the image: scatter where this source pixel won
    won = jnp.abs(zbuf[flat] - jnp.where(ok, zz, big)) < 1e-9
    img_flat = jnp.zeros((H * W + 1,) + image.shape[2:], image.dtype)
    src_vals = jnp.where(
        won.reshape(-1)[..., None] if image.ndim == 3 else won.reshape(-1),
        image.reshape(-1, *image.shape[2:]),
        0,
    )
    tgt = jnp.where(won, flat, H * W).reshape(-1)
    img_flat = img_flat.at[tgt].max(src_vals)
    return warped_depth, img_flat[:-1].reshape(image.shape)
