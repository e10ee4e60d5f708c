"""Plane extraction from organized clouds (reference N5: RgbdPlane,
depth.hpp:327-457; block-merge segmentation).

Device/host split of the reference's block-based algorithm:

* device (one jitted program): per-block least-squares plane fits —
  block centroids/covariances are batched 3x3 eigen problems; block
  validity from the curvature ratio (smallest/total eigenvalue);
  per-pixel plane assignment (point-to-plane distance + normal
  agreement) once planes are known.
* host (tiny data): greedy union of the ~hundreds of block planes into
  global planes over the 4-adjacent block graph (angle + distance
  thresholds — the reference's merge step), then one more device pass
  assigns every pixel to its best plane.

Output mirrors RgbdPlane: a label image ([H, W] u8, 255 = no plane) and
plane coefficients [K, 4] with unit normals, n.p + d = 0, d >= 0
convention matching the oracle (normals oriented toward the camera).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("block_size",))
def _block_planes(points: jnp.ndarray, block_size: int):
    """Per-block plane fits. Returns (normals [nB,3], ds [nB], mse [nB],
    valid [nB], centroids [nB,3])."""
    H, W, _ = points.shape
    bh, bw = H // block_size, W // block_size
    p = points[: bh * block_size, : bw * block_size]
    blocks = p.reshape(bh, block_size, bw, block_size, 3).transpose(0, 2, 1, 3, 4)
    blocks = blocks.reshape(bh * bw, block_size * block_size, 3)
    finite = jnp.isfinite(blocks).all(-1)
    w = finite.astype(jnp.float32)
    cnt = jnp.maximum(w.sum(-1), 1.0)
    b0 = jnp.where(finite[..., None], blocks, 0.0)
    mean = b0.sum(1) / cnt[:, None]
    centered = jnp.where(finite[..., None], blocks - mean[:, None, :], 0.0)
    cov = jnp.einsum("bki,bkj->bij", centered, centered,
                     precision=jax.lax.Precision.HIGHEST) / cnt[:, None, None]
    evals, evecs = jnp.linalg.eigh(cov)
    normal = evecs[..., 0]
    # orient toward camera (-z half-space; camera looks down +z)
    flip = normal[:, 2] > 0
    normal = jnp.where(flip[:, None], -normal, normal)
    d = -jnp.sum(normal * mean, -1)
    mse = evals[:, 0]
    total = jnp.maximum(evals.sum(-1), 1e-12)
    valid = (w.sum(-1) > 0.5 * block_size * block_size) & (
        mse / total < 1e-2
    )
    return normal, d, mse, valid, mean


@functools.partial(jax.jit, static_argnames=())
def _assign_pixels(points, normals, ds, active, dist_threshold):
    """Per-pixel best plane by |n.p + d| (masked by ``active``)."""
    dist = jnp.abs(
        jnp.einsum("hwi,ki->hwk", jnp.nan_to_num(points), normals,
                   precision=jax.lax.Precision.HIGHEST)
        + ds[None, None, :]
    )
    dist = jnp.where(active[None, None, :], dist, jnp.inf)
    best = jnp.argmin(dist, -1)
    bestd = jnp.take_along_axis(dist, best[..., None], -1)[..., 0]
    ok = (bestd < dist_threshold) & jnp.isfinite(points).all(-1)
    return jnp.where(ok, best, 255).astype(jnp.uint8)


@dataclasses.dataclass
class PlaneExtraction:
    labels: np.ndarray  # [H, W] u8, 255 = none
    coefficients: np.ndarray  # [K, 4]


def extract_planes(
    points: np.ndarray,
    block_size: int = 40,
    angle_threshold_deg: float = 10.0,
    dist_threshold: float = 0.01,
    min_blocks: int = 2,
    max_planes: int = 16,
) -> PlaneExtraction:
    """RgbdPlane-style segmentation of an organized cloud [H, W, 3]."""
    points = np.asarray(points, np.float32)
    H, W, _ = points.shape
    bh, bw = H // block_size, W // block_size
    normal, d, mse, valid, mean = (
        np.asarray(x) for x in _block_planes(jnp.asarray(points), block_size)
    )

    # host: union of adjacent similar block planes
    cos_thr = np.cos(np.deg2rad(angle_threshold_deg))
    parent = np.arange(bh * bw)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def similar(i, j):
        if not (valid[i] and valid[j]):
            return False
        if np.dot(normal[i], normal[j]) < cos_thr:
            return False
        return abs(np.dot(normal[i], mean[j]) + d[i]) < dist_threshold

    for by in range(bh):
        for bx in range(bw):
            i = by * bw + bx
            for nj in ((by, bx + 1), (by + 1, bx)):
                if nj[0] < bh and nj[1] < bw:
                    j = nj[0] * bw + nj[1]
                    if similar(i, j):
                        pa, pb = find(i), find(j)
                        if pa != pb:
                            parent[pb] = pa

    groups = {}
    for i in range(bh * bw):
        if valid[i]:
            groups.setdefault(find(i), []).append(i)
    planes = []
    for members in groups.values():
        if len(members) < min_blocks:
            continue
        ns = normal[members]
        ref = ns[0]
        ns = np.where((ns @ ref)[:, None] < 0, -ns, ns)
        n_mean = ns.mean(0)
        n_mean /= np.linalg.norm(n_mean)
        centroid = mean[members].mean(0)
        planes.append((n_mean, -float(np.dot(n_mean, centroid)), len(members)))
    planes.sort(key=lambda t: -t[2])
    planes = planes[:max_planes]

    if not planes:
        return PlaneExtraction(
            np.full((H, W), 255, np.uint8), np.zeros((0, 4), np.float32)
        )
    Kn = np.stack([p[0] for p in planes]).astype(np.float32)
    Kd = np.array([p[1] for p in planes], np.float32)
    pad = max_planes - len(planes)
    Kn_p = np.pad(Kn, ((0, pad), (0, 0)))
    Kd_p = np.pad(Kd, (0, pad))
    active = np.zeros(max_planes, bool)
    active[: len(planes)] = True
    labels = np.asarray(
        _assign_pixels(
            jnp.asarray(points), jnp.asarray(Kn_p), jnp.asarray(Kd_p),
            jnp.asarray(active), jnp.float32(dist_threshold),
        )
    )
    coeffs = np.concatenate([Kn, Kd[:, None]], -1)
    return PlaneExtraction(labels, coeffs)
