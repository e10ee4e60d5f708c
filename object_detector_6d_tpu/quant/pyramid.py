"""Quantized pyramids: per-level quantized images + template extraction.

Mirrors the reference's Modality::process -> QuantizedPyramid protocol
(linemod.hpp:55-161) for the two LINEMOD modalities:

* ColorGradient: level l+1 re-quantizes cv::pyrDown of the image.
  ``pyr_down_u8`` reproduces cv::pyrDown bit-exactly (5-tap [1,4,6,4,1]
  kernel, integer arithmetic with (acc+128)>>8 rounding, reflect-101
  borders, even-index decimation — verified in tests).
* DepthNormal: level l+1 nearest-neighbor subsamples the *quantized*
  level-l image (the oracle's resize(INTER_NEAREST, 0.5) == [::2, ::2]).

Masks follow the oracle's INTER_NEAREST halving ([::2, ::2]).
num_features halves per level (63 -> 31 with the defaults).

Quantization itself runs as jitted device programs (quant/color_gradient.py,
quant/depth_normal.py); extraction is host-side (quant/features.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu.quant.color_gradient import quantized_orientations
from object_detector_6d_tpu.quant.depth_normal import quantized_normals
from object_detector_6d_tpu.quant.features import (
    Template,
    extract_color_gradient,
    extract_depth_normal,
)

_PYR5 = (1, 4, 6, 4, 1)


def _reflect101_pad(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Pad by 2 on both sides of ``axis`` with BORDER_REFLECT_101."""
    n = x.shape[axis]

    def take(idx):
        return jax.lax.index_in_dim(x, idx, axis=axis, keepdims=True)

    left = jnp.concatenate([take(2), take(1)], axis=axis)
    right = jnp.concatenate([take(n - 2), take(n - 3)], axis=axis)
    return jnp.concatenate([left, x, right], axis=axis)


def _decimate_even(x: jnp.ndarray, n_out: int, axis: int) -> jnp.ndarray:
    """x[..., 0::2, ...] via a [..., n, 2] reshape + static index (a
    relayout compilers handle natively, where a strided slice on the
    minor axes can lower to per-element shuffles)."""
    n = x.shape[axis]
    if n < 2 * n_out:  # odd length: one dummy tail column/row
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, 2 * n_out - n)
        x = jnp.pad(x, pad)
    x = jax.lax.slice_in_dim(x, 0, 2 * n_out, axis=axis)
    shp = x.shape[:axis] + (n_out, 2) + x.shape[axis + 1:]
    return jax.lax.index_in_dim(x.reshape(shp), 0, axis + 1, keepdims=False)


@jax.jit
def pyr_down_u8(img: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact cv::pyrDown for u8 images [H, W, C] or [H, W].

    Layout: internally channel-first ([C, H, W], minor axis W); each
    separable pass runs the 5-tap filter densely (contiguous slices
    XLA fuses into one vectorized expression) and then drops the odd
    outputs with a reshape-based decimation — same integer math
    bit-for-bit as filter-then-decimate.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[:2]
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    x = jnp.moveaxis(img.astype(jnp.int32), -1, 0)  # [C, H, W]
    p = _reflect101_pad(x, axis=2)
    t = sum(
        k * jax.lax.slice_in_dim(p, i, i + W, axis=2)
        for i, k in enumerate(_PYR5)
    )
    t = _decimate_even(t, Wo, axis=2)
    p = _reflect101_pad(t, axis=1)
    o = sum(
        k * jax.lax.slice_in_dim(p, i, i + H, axis=1)
        for i, k in enumerate(_PYR5)
    )
    o = _decimate_even(o, Ho, axis=1)
    out = jnp.clip((o + 128) >> 8, 0, 255).astype(jnp.uint8)
    out = jnp.moveaxis(out, 0, -1)
    return out[..., 0] if squeeze else out


class ColorGradientPyramid:
    """Per-frame quantized color-gradient pyramid."""

    def __init__(
        self,
        bgr: np.ndarray,
        params: ColorGradientParams | None = None,
        levels: int = 2,
        mask: Optional[np.ndarray] = None,
    ):
        self.params = params or ColorGradientParams()
        self.levels = levels
        self._quantized: List[np.ndarray] = []
        self._magnitude: List[np.ndarray] = []
        self._masks: List[Optional[np.ndarray]] = []
        src = jnp.asarray(bgr)
        m = None if mask is None else np.asarray(mask) > 0
        for lvl in range(levels):
            q, mag = quantized_orientations(src, weak_threshold=self.params.weak_threshold)
            self._quantized.append(np.asarray(q))
            self._magnitude.append(np.asarray(mag))
            self._masks.append(m)
            if lvl + 1 < levels:
                src = pyr_down_u8(src)
                if m is not None:
                    m = m[::2, ::2]

    def quantize(self, level: int = 0) -> np.ndarray:
        return self._quantized[level]

    def extract_template(self, level: int) -> Optional[Template]:
        nf = self.params.num_features >> level
        return extract_color_gradient(
            self._quantized[level],
            self._magnitude[level],
            self._masks[level],
            nf,
            self.params.strong_threshold,
            level,
        )


class DepthNormalPyramid:
    """Per-frame quantized depth-normal pyramid."""

    def __init__(
        self,
        depth_u16: np.ndarray,
        params: DepthNormalParams | None = None,
        levels: int = 2,
        mask: Optional[np.ndarray] = None,
    ):
        self.params = params or DepthNormalParams()
        self.levels = levels
        q = np.asarray(
            quantized_normals(
                jnp.asarray(depth_u16),
                distance_threshold=self.params.distance_threshold,
                difference_threshold=self.params.difference_threshold,
            )
        )
        m = None if mask is None else np.asarray(mask) > 0
        self._quantized = [q]
        self._masks: List[Optional[np.ndarray]] = [m]
        for _ in range(1, levels):
            q = q[::2, ::2]
            self._quantized.append(q)
            if m is not None:
                m = m[::2, ::2]
            self._masks.append(m)

    def quantize(self, level: int = 0) -> np.ndarray:
        return self._quantized[level]

    def extract_template(self, level: int) -> Optional[Template]:
        # pyrDown halves num_features AND extract_threshold per level.
        nf = self.params.num_features >> level
        thr = self.params.extract_threshold >> level
        return extract_depth_normal(
            self._quantized[level],
            self._masks[level],
            nf,
            thr,
            level,
        )
