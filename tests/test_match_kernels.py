"""The fused match program's stages against plain numpy references.

Spread + response maps, the coarse template sweep and the level-0
refine are integer computations: each must equal a direct numpy
formulation exactly, at small shapes and at the production frame
width (chip_smoke.py repeats the real-width checks on the GPU).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.match import program as mp
from object_detector_6d_tpu.match.response import response_maps, spread


def _np_spread(q, t):
    H, W = q.shape
    p = np.zeros((H + t, W + t), np.uint8)
    p[:H, :W] = q
    out = np.zeros_like(q)
    for r in range(t):
        for c in range(t):
            out |= p[r:r + H, c:c + W]
    return out


def _np_response(s):
    """R[i] = max over orientations j present in s of 4 - circdist(i, j)."""
    out = np.zeros((8,) + s.shape, np.uint8)
    for i in range(8):
        for j in range(8):
            d = min(abs(i - j), 8 - abs(i - j))
            has = ((s >> j) & 1).astype(bool)
            out[i] = np.where(has, np.maximum(out[i], 4 - d), out[i])
    return out


@pytest.mark.parametrize("t,H,W", [(5, 48, 160), (8, 48, 160), (5, 480, 640)])
def test_response_spread_vs_numpy(t, H, W):
    """response_maps(spread(q, t)) == the direct numpy OR-spread and
    max-similarity over random one-hot orientation frames."""
    rng = np.random.RandomState(7 + t + H)
    q = (1 << rng.randint(0, 8, (H, W))).astype(np.uint8)
    q[rng.rand(H, W) < 0.4] = 0  # unquantized pixels
    got = np.asarray(response_maps(spread(jnp.asarray(q), t)))
    np.testing.assert_array_equal(got, _np_response(_np_spread(q, t)))


def _np_tiles(D, plane, r0, c0, nfeat):
    K = plane.shape[0]
    out = np.zeros((K, 16, 16), np.int64)
    for k in range(K):
        for f in range(nfeat[k]):
            out[k] += D[plane[k, f], r0[k, f]:r0[k, f] + 16,
                        c0[k, f]:c0[k, f] + 16]
    return out


def _refine_case(rng, P, Hp, Wp, K, F):
    D = rng.randint(0, 5, (P, Hp, Wp)).astype(np.int8)
    plane = rng.randint(0, P, (K, F)).astype(np.int32)
    r0 = rng.randint(0, Hp - 15, (K, F)).astype(np.int32)  # incl. last row
    c0 = rng.randint(0, Wp - 15, (K, F)).astype(np.int32)
    nfeat = rng.randint(0, F + 1, (K,)).astype(np.int32)
    nfeat[0] = 0  # an invalid top-K slot sweeps nothing
    nfeat[-1] = F
    return D, plane, r0, c0, nfeat


@pytest.mark.parametrize("shape", [(6, 40, 50, 5, 9), "production"])
def test_refine_tiles_vs_numpy(shape):
    """The level-0 refine stage == numpy tile sums, with zero-feature
    slots and unaligned tile starts; "production" is the 640x480 plane
    stack (T0=5, 16 candidates, 63 feature slots)."""
    rng = np.random.RandomState(11)
    if shape == "production":
        P, Hp, Wp = mp.refine_planes_shape((480, 640), 5, 32)
        shape = (P, Hp, Wp, 16, 63)
    D, plane, r0, c0, nfeat = _refine_case(rng, *shape)
    got = np.asarray(jax.jit(mp.refine_tiles)(D, plane, r0, c0, nfeat))
    np.testing.assert_array_equal(got, _np_tiles(D, plane, r0, c0, nfeat))


def test_refine_tiles_batched_over_frames():
    """vmapped over a frame axis (how the batched program calls it)."""
    rng = np.random.RandomState(3)
    cases = [_refine_case(rng, 4, 33, 41, 3, 5) for _ in range(2)]
    stacked = [np.stack(x) for x in zip(*cases)]
    got = np.asarray(jax.jit(jax.vmap(mp.refine_tiles))(*stacked))
    for b, case in enumerate(cases):
        np.testing.assert_array_equal(got[b], _np_tiles(*case))


def _np_coarse(D, k):
    nT, _, kd, _ = k.shape
    oh, ow = D.shape[1] - kd + 1, D.shape[2] - kd + 1
    out = np.zeros((nT, oh, ow), np.int64)
    for t in range(nT):
        for p, i, j in zip(*np.nonzero(k[t])):
            out[t] += int(k[t, p, i, j]) * D[p, i:i + oh, j:j + ow].astype(np.int64)
    return out


@pytest.mark.parametrize("nT,P,kd,Hn,Wn", [(3, 8, 3, 12, 17), (5, 512, 8, 37, 47)])
def test_coarse_sweep_vs_numpy(nT, P, kd, Hn, Wn):
    """coarse_sweep in its chosen operand dtype == an int64 numpy sum;
    the second case is one 640x480 frame's level-1 plane stack (T1=8)
    with sparse one-hot feature-count kernels."""
    rng = np.random.RandomState(nT)
    D = rng.randint(0, 5, (P, Hn, Wn)).astype(np.uint8)
    k = np.zeros((nT, P, kd, kd), np.int8)
    for t in range(nT):
        for _ in range(63):
            k[t, rng.randint(P), rng.randint(kd), rng.randint(kd)] += 1
    got = np.asarray(jax.jit(mp.coarse_sweep)(D, jnp.asarray(k)))
    np.testing.assert_array_equal(got, _np_coarse(D, k))
