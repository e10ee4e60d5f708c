"""Color-gradient modality: bit-exact quantized orientations, on device.

Re-implements the reference stack's ColorGradient modality
(linemod.hpp:163-198) and is verified bit-exact against the OpenCV 4.6
oracle (tests/test_color_gradient.py):

1. 7x7 Gaussian smoothing of the BGR image. The sigma-0 7-tap kernel is
   exactly dyadic ([8,28,56,72,56,28,8]/256), so the whole blur is exact
   integer arithmetic: two separable passes in int32, one rounding shift
   ((acc + 2^15) >> 16), replicate borders.
2. 3x3 Sobel dx/dy per channel (int32, replicate borders).
3. Per pixel, select the channel with the largest squared gradient
   magnitude (first max wins).
4. Orientation in degrees via cv::fastAtan2's exact f32 polynomial,
   quantized to 16 bins (round-half-even, matching convertTo) and folded
   mod 8 (gradient direction is a line, not a ray).
5. Hysteresis: 1-pixel border zeroed, then for pixels with squared
   magnitude > weak_threshold^2, a 3x3 majority vote over the 8 bins
   (>= 5 of 9 votes required) produces the one-hot byte 1 << bin.

Layout note: all internal images are **channel-first** [3, H, W] so the
minor dimension is W; channel selection is computed with
compares/wheres, not gathers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.core.config import ColorGradientParams

_GAUSS7 = (8, 28, 56, 72, 56, 28, 8)


def _pad_edge(x, pads):
    return jnp.pad(x, pads, mode="edge")


def _sep7_cf(img: jnp.ndarray) -> jnp.ndarray:
    """Exact integer 7x7 Gaussian; img [C, H, W] int32 -> int32."""
    H, W = img.shape[1], img.shape[2]
    p = _pad_edge(img, ((0, 0), (0, 0), (3, 3)))
    t = sum(k * p[:, :, i : i + W] for i, k in enumerate(_GAUSS7))
    p = _pad_edge(t, ((0, 0), (3, 3), (0, 0)))
    o = sum(k * p[:, i : i + H] for i, k in enumerate(_GAUSS7))
    return jnp.clip((o + (1 << 15)) >> 16, 0, 255)


def _sobel_cf(s: jnp.ndarray):
    """3x3 Sobel dx, dy on [C, H, W] int32, replicate borders."""
    H, W = s.shape[1], s.shape[2]
    px = _pad_edge(s, ((0, 0), (0, 0), (1, 1)))
    gx = px[:, :, 2:] - px[:, :, :-2]
    py = _pad_edge(gx, ((0, 0), (1, 1), (0, 0)))
    dx = py[:, :-2] + 2 * py[:, 1:-1] + py[:, 2:]
    py = _pad_edge(s, ((0, 0), (1, 1), (0, 0)))
    gy = py[:, 2:] - py[:, :-2]
    px = _pad_edge(gy, ((0, 0), (0, 0), (1, 1)))
    dy = px[:, :, :-2] + 2 * px[:, :, 1:-1] + px[:, :, 2:]
    return dx, dy


def fast_atan2_deg(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """cv::fastAtan2: degrees in [0, 360), ~0.3 deg accuracy, exact f32."""
    P1 = jnp.float32(0.9997878412794807 * (180 / jnp.pi))
    P3 = jnp.float32(-0.3258083974640975 * (180 / jnp.pi))
    P5 = jnp.float32(0.1555786518463281 * (180 / jnp.pi))
    P7 = jnp.float32(-0.04432655554792128 * (180 / jnp.pi))
    eps = jnp.float32(1.1920929e-07)
    ax, ay = jnp.abs(x), jnp.abs(y)
    swap = ax < ay
    c = jnp.where(swap, ax / (ay + eps), ay / (ax + eps)).astype(jnp.float32)
    c2 = c * c
    a = (((P7 * c2 + P5) * c2 + P3) * c2 + P1) * c
    a = jnp.where(swap, jnp.float32(90.0) - a, a)
    a = jnp.where(x < 0, jnp.float32(180.0) - a, a)
    a = jnp.where(y < 0, jnp.float32(360.0) - a, a)
    return a


def _box3_sum(x: jnp.ndarray) -> jnp.ndarray:
    """3x3 zero-padded box sum over trailing [H, W] dims."""
    H, W = x.shape[-2], x.shape[-1]
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (0, 0)])
    x = p[..., 0:H, :] + p[..., 1 : H + 1, :] + p[..., 2 : H + 2, :]
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, 0), (1, 1)])
    return p[..., :, 0:W] + p[..., :, 1 : W + 1] + p[..., :, 2 : W + 2]


@functools.partial(jax.jit, static_argnames=("weak_threshold",))
def quantized_orientations(
    bgr: jnp.ndarray, weak_threshold: float = 10.0
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quantize a [H, W, 3] u8 image -> (one-hot u8 [H, W], mag f32 [H, W]).

    The magnitude channel is the squared gradient magnitude of the
    selected channel (the oracle's ``magnitude`` image), used by template
    extraction with the strong threshold.
    """
    img = jnp.moveaxis(bgr.astype(jnp.int32), -1, 0)  # [3, H, W]
    s = _sep7_cf(img)
    dx, dy = _sobel_cf(s)
    mag = (dx * dx + dy * dy).astype(jnp.float32)  # [3, H, W]

    # channel with max squared magnitude, first max wins (channel order)
    m0, m1, m2 = mag[0], mag[1], mag[2]
    sel1 = (m1 > m0) & (m1 >= m2)
    sel2 = (m2 > m0) & (m2 > m1)
    sel0 = ~(sel1 | sel2)
    smag = jnp.where(sel0, m0, jnp.where(sel1, m1, m2))
    sdx = jnp.where(sel0, dx[0], jnp.where(sel1, dx[1], dx[2])).astype(jnp.float32)
    sdy = jnp.where(sel0, dy[0], jnp.where(sel1, dy[1], dy[2])).astype(jnp.float32)

    ang = fast_atan2_deg(sdy, sdx)
    q16 = jnp.clip(jnp.rint(ang * jnp.float32(16.0 / 360.0)), 0, 255).astype(jnp.int32)
    q8 = q16 & 7

    H, W = q8.shape
    u = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    v = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    border = (v == 0) | (v == H - 1) | (u == 0) | (u == W - 1)
    q8 = jnp.where(border, 0, q8)

    # 3x3 vote counts <= 9 < 16, so all eight bins pack into ONE uint32
    # as 4-bit fields (bin 7 sits in the sign bits — hence unsigned):
    # a single packed box sum instead of eight plane box sums.
    packed = (jnp.uint32(1) << (4 * q8).astype(jnp.uint32)).astype(jnp.uint32)
    votes = _box3_sum(packed)
    best = jnp.zeros_like(q8)
    best_votes = (votes & 15).astype(jnp.int32)
    for k in range(1, 8):
        vk = ((votes >> (4 * k)) & 15).astype(jnp.int32)
        win = vk > best_votes  # strict: first max wins, like argmax
        best = jnp.where(win, k, best)
        best_votes = jnp.maximum(best_votes, vk)
    strong = (smag > jnp.float32(weak_threshold) ** 2) & (best_votes >= 5) & ~border
    return (
        jnp.where(strong, (1 << best).astype(jnp.uint8), 0).astype(jnp.uint8),
        smag,
    )


class ColorGradient:
    """Color-gradient modality front end (mirrors linemod::ColorGradient)."""

    name = "ColorGradient"

    def __init__(self, params: ColorGradientParams | None = None):
        self.params = params or ColorGradientParams()

    def quantize(self, bgr: jnp.ndarray) -> jnp.ndarray:
        q, _ = quantized_orientations(bgr, weak_threshold=self.params.weak_threshold)
        return q
