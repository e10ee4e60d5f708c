"""5x5 median filter over small-alphabet u8 images, by counting.

The LINEMOD depth-normal quantizer post-filters its one-hot orientation
image with a numeric 5x5 median (the canonical implementation calls
cv::medianBlur(ksize=5) on the quantized bytes; border handling is
replicate). A generic per-pixel sort of 25 values is a poor fit for
vector hardware, but the quantized image only ever holds the 9 byte values
{0, 1, 2, 4, ..., 128} — so the median is computed by *counting*: build a
cumulative histogram over the 9 values with two separable 5x5 box sums and
select the first value whose cumulative count reaches 13. Everything is
elementwise adds and compares — work that XLA fuses.

HBM-traffic note: a window count never exceeds 25, so four 8-bit count
fields pack into one int32 with no cross-field carry. The eight one-hot
codes therefore need only TWO packed int32 planes through the separable
box sums (instead of eight), and the count for code 0 is 25 minus the
rest — a ~4x cut in box-sum traffic (the stage is bandwidth-bound:
measured 3.4 ms -> see tools/prof_quant.py for the per-stage harness).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_CODES = np.array([0, 1, 2, 4, 8, 16, 32, 64, 128], dtype=np.uint8)


def _box5_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Separable 5x5 box sum with replicate padding. x: [..., H, W] int32."""
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(2, 2), (0, 0)], mode="edge")
    x = sum(p[..., i : i + x.shape[-2], :] for i in range(5))
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, 0), (2, 2)], mode="edge")
    return sum(p[..., :, i : i + x.shape[-1]] for i in range(5))


def median5_onehot_u8(img: jnp.ndarray) -> jnp.ndarray:
    """Numeric 5x5 median of an image over the alphabet {0,1,2,4,...,128}.

    Bit-exact with cv::medianBlur(CV_8U, ksize=5) for inputs restricted to
    that alphabet (verified in tests/test_depth_normal.py).
    """
    x = img.astype(jnp.int32)
    # pack the eight one-hot indicator planes into two int32 images,
    # four 8-bit count fields each (window counts <= 25 < 256: no carry)
    lo = jnp.zeros_like(x)
    hi = jnp.zeros_like(x)
    for k in range(4):
        lo = lo + (((x >> k) & 1) << (8 * k))
        hi = hi + (((x >> (k + 4)) & 1) << (8 * k))
    lo = _box5_sum(lo)
    hi = _box5_sum(hi)
    counts = [(lo >> (8 * k)) & 255 for k in range(4)] + [
        (hi >> (8 * k)) & 255 for k in range(4)
    ]
    # median = first code whose cumulative count reaches 13 (of 25);
    # count for code 0 is 25 minus the rest, and codes are 0 then powers
    # of two so the result is arithmetic — no gather.
    cum = 25
    for c in counts:
        cum = cum - c
    val = jnp.zeros_like(x)
    done = cum >= 13  # code 0 is already the median
    for k, c in enumerate(counts):
        cum = cum + c
        hit = ~done & (cum >= 13)
        val = jnp.where(hit, jnp.int32(1) << k, val)
        done = done | hit
    return val.astype(jnp.uint8)
