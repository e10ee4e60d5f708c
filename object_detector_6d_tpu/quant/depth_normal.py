"""Depth-normal modality: bit-exact quantized surface normals, on device.

Re-implements the reference stack's DepthNormal modality
(linemod.hpp:200-240; the compiled quantizedNormals routine in
libopencv_rgbd.so.4.6.0, reverse-engineered and verified bit-exact this
session — see tests/test_depth_normal.py):

1. For each interior pixel (y, x in [5, dim-6)) with depth d <
   distance_threshold, take 8 ring samples at radius 5 and accumulate a
   bilateral-masked 2x2 least-squares system for the depth gradient
   (samples with |delta| >= difference_threshold are dropped).
2. Form the un-normalized normal (1150*ddx, 1150*ddy, -det*d) in f32,
   normalize, and quantize the direction via a 20x20 lookup
   (vy, vx) = (int(ny*10+10), int(nx*10+10)) -> one-hot byte.
3. 5x5 numeric median filter over the one-hot bytes (ops/median.py).

Instead of the CPU's per-pixel scalar loop, every step is expressed as
shifted whole-image arithmetic: 8 static shifts, fused elementwise int32
math, one 400-entry gather, and a histogram median — all elementwise and
jit-compiled as one fused XLA program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.core.config import DepthNormalParams
from object_detector_6d_tpu.ops.lut import NORMAL_LUT_2D
from object_detector_6d_tpu.ops.median import median5_onehot_u8

_RING_RADIUS = 5
# (dx, dy) ring sample offsets, matching the oracle's 8 accumBilateral calls.
_RING = tuple(
    (dx, dy)
    for dy in (-_RING_RADIUS, 0, _RING_RADIUS)
    for dx in (-_RING_RADIUS, 0, _RING_RADIUS)
    if not (dx == 0 and dy == 0)
)


def _shift(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """img[y+dy, x+dx] with zero fill (border excluded by the interior mask)."""
    H, W = img.shape
    pad_y = (max(-dy, 0), max(dy, 0))
    pad_x = (max(-dx, 0), max(dx, 0))
    p = jnp.pad(img, (pad_y, pad_x))
    return p[pad_y[1] : pad_y[1] + H, pad_x[1] : pad_x[1] + W]


def ring_gradient(d: jnp.ndarray, difference_threshold: int,
                  inclusive: bool = False):
    """Bilateral-masked ring least-squares depth gradient (the oracle's
    8 accumBilateral calls). ``d`` int32 [H, W] raw depth. Returns
    (ddx, ddy, det) int32 — the un-divided LS solution: the gradient is
    (ddx/det, ddy/det). Shared by the DepthNormal quantizer (strict
    ``|delta| < threshold``, bit-exact vs linemod.cpp) and the
    real-valued RgbdNormals LINEMOD method (geom/normals.py —
    normal.cpp accepts ``|delta| <= threshold``; measured: a 50 mm step
    moves its normals, a 51 mm step does not, while the quantizer's
    cutoff is at 49/50)."""
    A0 = jnp.zeros_like(d)
    A1 = jnp.zeros_like(d)
    A3 = jnp.zeros_like(d)
    b0 = jnp.zeros_like(d)
    b1 = jnp.zeros_like(d)
    for dx, dy in _RING:
        delta = _shift(d, dx, dy) - d
        ok = (jnp.abs(delta) <= difference_threshold if inclusive
              else jnp.abs(delta) < difference_threshold)
        f = ok.astype(jnp.int32)
        A0 = A0 + f * (dx * dx)
        A1 = A1 + f * (dx * dy)
        A3 = A3 + f * (dy * dy)
        b0 = b0 + f * dx * delta
        b1 = b1 + f * dy * delta

    det = A0 * A3 - A1 * A1
    ddx = A3 * b0 - A1 * b1
    ddy = -A1 * b0 + A0 * b1
    return ddx, ddy, det


def interior_mask(H: int, W: int):
    """The oracle's valid interior: ring radius in from every border
    (note the asymmetric -1 on the far edges, measured)."""
    u, v = jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy")
    return (
        (v >= _RING_RADIUS)
        & (v < H - _RING_RADIUS - 1)
        & (u >= _RING_RADIUS)
        & (u < W - _RING_RADIUS - 1)
    )


@functools.partial(jax.jit, static_argnames=("distance_threshold", "difference_threshold"))
def quantized_normals(
    depth_u16: jnp.ndarray,
    distance_threshold: int = 2000,
    difference_threshold: int = 50,
) -> jnp.ndarray:
    """Quantized normal image [H, W] u8 with values in {0,1,2,...,128}.

    ``depth_u16``: raw sensor depth (u16 semantics; any int dtype), in the
    same unit the thresholds are expressed in (mm for the defaults).
    """
    d = depth_u16.astype(jnp.int32)
    H, W = d.shape
    ddx, ddy, det = ring_gradient(d, difference_threshold)

    nx = (1150 * ddx).astype(jnp.float32)
    ny = (1150 * ddy).astype(jnp.float32)
    nz = (-det * d).astype(jnp.float32)
    norm2 = nx * nx + ny * ny + nz * nz
    norm = jnp.sqrt(norm2)
    inv = jnp.float32(1.0) / norm
    nxn = nx * inv
    nyn = ny * inv

    vx = (nxn * jnp.float32(10.0) + jnp.float32(10.0)).astype(jnp.int32)
    vy = (nyn * jnp.float32(10.0) + jnp.float32(10.0)).astype(jnp.int32)
    # The oracle's NORMAL_LUT is exactly the 8-sector octant map
    # bin = floor((atan2(vy-10, vx-10) + 22.5deg) / 45deg) mod 8
    # (verified cell-for-cell against the compiled table, ops/lut.py) —
    # computed arithmetically here: a handful of compares instead of a
    # gather. Integer cells never land exactly on the
    # irrational tan(22.5deg) boundaries, so f32 compares are exact.
    cx = (vx - 10).astype(jnp.float32)
    cy = (vy - 10).astype(jnp.float32)
    t = jnp.float32(0.41421356)  # tan(22.5 deg)
    acx = jnp.abs(cx)
    acy = jnp.abs(cy)
    horiz = acy <= t * acx
    vert = acx <= t * acy
    bin_h = jnp.where(cx >= 0, 0, 4)
    bin_v = jnp.where(cy >= 0, 2, 6)
    bin_d = jnp.where(
        cy >= 0, jnp.where(cx >= 0, 1, 3), jnp.where(cx >= 0, 7, 5)
    )
    bins = jnp.where(horiz, bin_h, jnp.where(vert, bin_v, bin_d))
    q = (jnp.int32(1) << bins).astype(jnp.uint8)

    valid = interior_mask(H, W) & (d < distance_threshold) & (norm > 0)
    q = jnp.where(valid, q, 0).astype(jnp.uint8)

    return median5_onehot_u8(q)


class DepthNormal:
    """Depth-normal modality front end (mirrors linemod::DepthNormal)."""

    name = "DepthNormal"

    def __init__(self, params: DepthNormalParams | None = None):
        self.params = params or DepthNormalParams()

    def quantize(self, depth_u16: jnp.ndarray) -> jnp.ndarray:
        return quantized_normals(
            depth_u16,
            distance_threshold=self.params.distance_threshold,
            difference_threshold=self.params.difference_threshold,
        )
