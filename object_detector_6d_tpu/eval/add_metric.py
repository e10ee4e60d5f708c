"""Pose-accuracy metrics: ADD / ADD-S / ADD-0.1d (reference eval layer).

ADD (Hinterstoisser et al.): mean distance between model points under the
estimated and ground-truth poses. ADD-S (symmetric objects): mean
closest-point distance. A pose is "correct" at threshold k*d if its
ADD(-S) is below k times the model diameter (k = 0.1 for the standard
ADD-0.1d accuracy the reference reports).

Batched jnp implementations; ADD-S uses the same matmul brute-force
nearest-neighbor as the ICP.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _apply(T, pts):
    return _mm(pts, jnp.swapaxes(T[..., :3, :3], -1, -2)) + T[..., None, :3, 3]


@jax.jit
def add_distance(pose_est: jnp.ndarray, pose_gt: jnp.ndarray, model_pts: jnp.ndarray):
    """ADD: mean ||T_e x - T_g x||. Broadcasts over leading pose axes."""
    pe = _apply(jnp.asarray(pose_est, jnp.float32), model_pts)
    pg = _apply(jnp.asarray(pose_gt, jnp.float32), model_pts)
    return jnp.mean(jnp.linalg.norm(pe - pg, axis=-1), axis=-1)


@jax.jit
def adds_distance(pose_est: jnp.ndarray, pose_gt: jnp.ndarray, model_pts: jnp.ndarray):
    """ADD-S: mean closest-point distance (symmetric objects)."""
    pe = _apply(jnp.asarray(pose_est, jnp.float32), model_pts)
    pg = _apply(jnp.asarray(pose_gt, jnp.float32), model_pts)
    d2 = (
        jnp.sum(pe * pe, -1)[..., :, None]
        + jnp.sum(pg * pg, -1)[..., None, :]
        - 2.0 * _mm(pe, jnp.swapaxes(pg, -1, -2))
    )
    return jnp.mean(jnp.sqrt(jnp.maximum(jnp.min(d2, axis=-1), 0.0)), axis=-1)


def model_diameter(model_pts: np.ndarray) -> float:
    """Max pairwise distance (object diameter)."""
    pts = jnp.asarray(model_pts, jnp.float32)
    d2 = (
        jnp.sum(pts * pts, -1)[:, None]
        + jnp.sum(pts * pts, -1)[None, :]
        - 2.0 * _mm(pts, pts.T)
    )
    return float(jnp.sqrt(jnp.maximum(jnp.max(d2), 0.0)))


def add_accuracy(
    poses_est,
    poses_gt,
    model_pts,
    diameter: float | None = None,
    k: float = 0.1,
    symmetric: bool = False,
) -> float:
    """ADD(-S)-k*d accuracy over a batch of frames (fraction correct)."""
    model_pts = jnp.asarray(model_pts, jnp.float32)
    if diameter is None:
        diameter = model_diameter(model_pts)
    fn = adds_distance if symmetric else add_distance
    d = np.asarray(fn(jnp.asarray(poses_est), jnp.asarray(poses_gt), model_pts))
    return float((d < k * diameter).mean())
