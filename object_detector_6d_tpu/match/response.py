"""Orientation spreading + response maps (reference linemod.cpp hot path).

``spread``: OR of the quantized one-hot image over the forward TxT
neighborhood — dst(y, x) = OR_{0<=r,c<T} src(y+r, x+c) (the oracle's
orUnaligned8u loop). Computed separably with log-step doubling: a
forward window-T OR per axis is 3 shifted ORs (window doubles each
step), so T=8 costs 6 shifted ORs instead of 64 — and the small op
count keeps XLA from spilling unfused intermediates when several
(level, modality) spreads share one program (measured 3x end-to-end).

``response_maps``: for each of the 8 orientations i, the max cosine
score against any orientation present in the spread byte:
R[i](y,x) = max_{j in bits(s)} (4 - circ_dist(i, j)), 0 for empty s.
The oracle bakes this into a 256-byte SIMILARITY_LUT applied to the
lsb/msb nibbles; we rotate the spread byte so orientation i sits at
bit 0 and resolve the circular distance with a 5-step priority select
over fixed bit masks — arithmetic-identical (ops/lut.py), no gather.

Both fuse into one XLA program; output feeds the template sweep
(match/sweep.py, match/program.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.ops.lut import similarity_table


def _shift_fwd(a: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """a shifted k pixels toward the origin along axis, zero-filled."""
    pad = [(0, 0), (0, 0)]
    pad[axis] = (0, k)
    sl = [slice(None), slice(None)]
    sl[axis] = slice(k, None)
    return jnp.pad(a, pad)[tuple(sl)]


@functools.partial(jax.jit, static_argnames=("t",))
def spread(quantized: jnp.ndarray, t: int) -> jnp.ndarray:
    """OR-spread over the forward t x t window. [H, W] u8 -> [H, W] u8."""
    x = quantized
    for axis in (0, 1):
        # log-step doubling: after the loop `acc` covers offsets
        # [0, done); one final shift by t-done (< done) completes [0, t).
        acc = x
        done = 1
        while done * 2 <= t:
            acc = acc | _shift_fwd(acc, done, axis)
            done *= 2
        if done < t:
            acc = acc | _shift_fwd(acc, t - done, axis)
        x = acc
    return x


@jax.jit
def response_maps(spread_img: jnp.ndarray) -> jnp.ndarray:
    """Spread image [H, W] u8 -> response maps [8, H, W] u8 (values 0..4)."""
    s = spread_img.astype(jnp.int32)
    table = similarity_table()  # [8 ori, 8 bit]; row 0 = score by distance
    # bit masks of the rotated byte grouped by circular distance 4..0
    dist_masks = ((1 << 4), (1 << 3) | (1 << 5), (1 << 2) | (1 << 6),
                  (1 << 1) | (1 << 7), 1)
    dist_vals = tuple(int(table[0, d]) for d in (4, 3, 2, 1, 0))
    outs = []
    for i in range(8):
        r = ((s >> i) | (s << (8 - i))) & 0xFF  # rotate: bit 0 = orientation i
        v = jnp.zeros_like(s)
        for mask, val in zip(dist_masks, dist_vals):  # nearest bit wins last
            v = jnp.where((r & mask) != 0, jnp.int32(val), v)
        outs.append(v)
    return jnp.stack(outs).astype(jnp.uint8)
