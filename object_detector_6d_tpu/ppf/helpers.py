"""Point-cloud helpers (reference N14: ppf_helpers.hpp:64-146).

Device replacements: FLANN trees become brute-force distance
matmuls (knn), PCA normals batch the per-point covariance eigen-solve,
downsampling is a voxel-hash segment mean. PLY I/O lives in io/ply.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def sample_pc_uniform(pc: np.ndarray, sample_step: int) -> np.ndarray:
    """Every sample_step-th point (samplePCUniform)."""
    return np.asarray(pc)[::sample_step]


def sample_pc_by_quantization(
    pc: np.ndarray, relative_sample_step: float = 0.05
) -> np.ndarray:
    """Voxel-grid downsampling (samplePCByQuantization): one averaged
    point per occupied voxel; voxel size = relative step x bbox extent."""
    pc = np.asarray(pc, np.float32)
    xyz = pc[:, :3]
    lo = xyz.min(0)
    hi = xyz.max(0)
    extent = float(np.linalg.norm(hi - lo))
    step = max(relative_sample_step * extent, 1e-9)
    keys = np.floor((xyz - lo) / step).astype(np.int64)
    flat = (keys[:, 0] << 42) + (keys[:, 1] << 21) + keys[:, 2]
    uniq, inv = np.unique(flat, return_inverse=True)
    out = np.zeros((len(uniq), pc.shape[1]), np.float64)
    np.add.at(out, inv, pc.astype(np.float64))
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    out /= counts[:, None]
    if pc.shape[1] >= 6:
        nrm = out[:, 3:6]
        n = np.linalg.norm(nrm, axis=-1, keepdims=True)
        out[:, 3:6] = np.divide(nrm, n, out=np.zeros_like(nrm), where=n > 0)
    return out.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("k",))
def knn(query: jnp.ndarray, points: jnp.ndarray, k: int = 1):
    """Brute-force k-nearest-neighbors by matmul (replaces FLANN).

    Returns (indices [Q, k], sq_distances [Q, k])."""
    q2 = jnp.sum(query * query, -1, keepdims=True)
    p2 = jnp.sum(points * points, -1)[None, :]
    d2 = q2 + p2 - 2.0 * _mm(query, points.T)
    neg, idx = jax.lax.top_k(-d2, k)
    return idx, -neg


@functools.partial(jax.jit, static_argnames=("k",))
def compute_normals_pc3d(
    pc: jnp.ndarray, k: int = 12, viewpoint: jnp.ndarray | None = None
) -> jnp.ndarray:
    """PCA normals from k nearest neighbors (computeNormalsPC3d).

    Returns [N, 6] xyz+normal, normals oriented toward ``viewpoint``
    (origin by default)."""
    xyz = pc[:, :3]
    idx, _ = knn(xyz, xyz, k)
    nbrs = xyz[idx]  # [N, k, 3]
    mean = nbrs.mean(1, keepdims=True)
    centered = nbrs - mean
    cov = jnp.einsum("nki,nkj->nij", centered, centered,
                     precision=jax.lax.Precision.HIGHEST)
    # smallest eigenvector of the 3x3 covariance
    w, v = jnp.linalg.eigh(cov)
    normal = v[..., 0]
    vp = jnp.zeros(3, xyz.dtype) if viewpoint is None else viewpoint
    to_vp = vp[None, :] - xyz
    flip = jnp.sum(normal * to_vp, -1, keepdims=True) < 0
    normal = jnp.where(flip, -normal, normal)
    return jnp.concatenate([xyz, normal], -1)


def transform_pc_pose(pc: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Transform xyz (+rotate normals) by a 4x4 pose (transformPCPose)."""
    pc = np.asarray(pc, np.float32)
    pose = np.asarray(pose, np.float32)
    out = pc.copy()
    out[:, :3] = pc[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    if pc.shape[1] >= 6:
        out[:, 3:6] = pc[:, 3:6] @ pose[:3, :3].T
    return out


def add_noise_pc(pc: np.ndarray, scale: float, seed: int = 0) -> np.ndarray:
    """Gaussian position noise (addNoisePC)."""
    rng = np.random.RandomState(seed)
    out = np.asarray(pc, np.float32).copy()
    out[:, :3] += rng.normal(0, scale, out[:, :3].shape).astype(np.float32)
    return out
