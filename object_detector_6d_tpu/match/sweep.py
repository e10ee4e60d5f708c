"""Template sweep as a batched convolution (the framework's perf core).

The reference CPU implementation reorganizes response maps into "linear
memories" and strided u8 sums (cache-friendly SSE). On an accelerator the same math
is a *convolution*: for templates encoded as one-hot kernels
K[t, ori, dy, dx] (1 where template t has a feature with that
orientation at that offset),

    score[t, r, c] = sum_f R[label_f, r*T + fy_f, c*T + fx_f]
                   = conv(R, K) with window stride T,

which XLA maps onto the matrix units. Inputs are cast to bf16 (response
values 0..4 and one-hot kernels are exact in bf16) with f32 accumulation
(exact for integer sums < 2^24), so scores are bit-identical to integer
accumulation.

Valid anchors: the oracle evaluates every T-grid anchor (r*T, c*T) with
the per-template span r <= H/T - ceil(h/T), c <= W/T - ceil(w/T); out-of-
span entries here are masked to 0 (the oracle's flat linear-memory loop
instead writes wrap-around garbage there — an artifact, deviation
documented in tests/test_match.py).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.quant.features import Template


def pack_kernels(
    templates: Sequence[Template], kh: int, kw: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Templates (same pyramid level, one modality) -> one-hot kernel stack.

    Returns (kernels [n, 8, kh, kw] f32, sizes [n, 2] (w, h) int32).
    Features outside (kh, kw) would be silently dropped; callers pass the
    max bbox so none are.
    """
    n = len(templates)
    K = np.zeros((n, 8, kh, kw), np.float32)
    sizes = np.zeros((n, 2), np.int32)
    for i, t in enumerate(templates):
        sizes[i] = (t.width, t.height)
        for f in t.features:
            K[i, f.label, f.y, f.x] += 1.0
    return K, sizes


@functools.partial(jax.jit, static_argnames=("t_stride", "grid_h", "grid_w"))
def conv_sweep(
    responses: jnp.ndarray,  # [8, H, W] u8
    kernels: jnp.ndarray,  # [n, 8, kh, kw] f32 one-hot
    t_stride: int,
    grid_h: int,
    grid_w: int,
) -> jnp.ndarray:
    """Raw similarity sums [n, grid_h, grid_w] (int32) at T-grid anchors."""
    kh, kw = kernels.shape[2], kernels.shape[3]
    H, W = responses.shape[1], responses.shape[2]
    # Pad so every T-grid anchor (r*T, c*T), r<grid_h, c<grid_w is evaluated.
    need_h = (grid_h - 1) * t_stride + kh
    need_w = (grid_w - 1) * t_stride + kw
    R = responses.astype(jnp.bfloat16)[None]  # [1, 8, H, W]
    R = jnp.pad(R, ((0, 0), (0, 0), (0, max(0, need_h - H)), (0, max(0, need_w - W))))
    out = jax.lax.conv_general_dilated(
        R,
        kernels.astype(jnp.bfloat16),
        window_strides=(t_stride, t_stride),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
    )
    return out[0].astype(jnp.int32)  # [n, grid_h, grid_w]


def span_mask(
    sizes: np.ndarray, t_stride: int, height: int, width: int, grid_h: int, grid_w: int
) -> np.ndarray:
    """Bool [n, grid_h, grid_w]: anchors where the template fits the image.

    Oracle span: r <= H/T - hf, c <= W/T - wf with wf = (w-1)/T + 1
    (linemod.cpp similarity(): span_x = W - wf, inclusive).
    """
    n = sizes.shape[0]
    gw = width // t_stride
    gh = height // t_stride
    wf = (sizes[:, 0] - 1) // t_stride + 1
    hf = (sizes[:, 1] - 1) // t_stride + 1
    span_x = gw - wf  # inclusive max c
    span_y = gh - hf
    r = np.arange(grid_h)[None, :, None]
    c = np.arange(grid_w)[None, None, :]
    return (r <= span_y[:, None, None]) & (c <= span_x[:, None, None])


@functools.partial(jax.jit, static_argnames=("t_stride", "win"))
def local_scores(
    responses: jnp.ndarray,  # [8, H, W] u8 (level-l response maps)
    kernels: jnp.ndarray,  # [n_cand, 8, kh, kw] f32 (per-candidate template)
    anchors: jnp.ndarray,  # [n_cand, 2] int32 (x0, y0) top-left T-grid anchor
    t_stride: int,
    win: int = 16,
) -> jnp.ndarray:
    """Per-candidate local sweep: scores [n_cand, win, win] over T-grid
    anchors (x0 + c*T, y0 + r*T). Implements the oracle's similarityLocal
    16x16 refinement window as a vmapped small convolution."""
    kh, kw = kernels.shape[2], kernels.shape[3]
    pad_h = (win - 1) * t_stride + kh
    pad_w = (win - 1) * t_stride + kw
    Rp = jnp.pad(responses.astype(jnp.bfloat16), ((0, 0), (0, pad_h), (0, pad_w)))

    def one(anchor, kernel):
        window = jax.lax.dynamic_slice(
            Rp, (0, anchor[1], anchor[0]), (8, pad_h, pad_w)
        )
        out = jax.lax.conv_general_dilated(
            window[None],
            kernel[None].astype(jnp.bfloat16),
            window_strides=(t_stride, t_stride),
            padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.float32,
        )
        return out[0, 0]

    return jax.vmap(one)(anchors, kernels).astype(jnp.int32)
