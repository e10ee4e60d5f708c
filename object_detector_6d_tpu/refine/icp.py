"""Batched point-to-plane ICP with SE(3) updates (reference L4).

Plays the role of ppf_match_3d::ICP::registerModelToScene (icp.hpp:80-162;
Picky ICP + multi-resolution + robust outlier rejection, point-to-plane
linearization after Kok-Lim Low), redesigned for a batched device program:

* hypotheses are a leading batch axis (one vmapped program refines 100s
  of poses at once — the reference loops one hypothesis at a time);
* correspondences are **brute-force nearest neighbor by matmul**
  (one [N, M] distance matmul per iteration) instead of a FLANN k-d
  tree — dense matmul replaces pointer chasing, and is exact instead
  of approximate;
* robust rejection uses the median-absolute-deviation scaled by
  ``rejection_scale`` (the reference's robust threshold);
* the 6x6 normal equations of the point-to-plane linearization are
  solved in f32 (HIGHEST-precision matmuls) and retracted with SE3.exp;
* multi-resolution runs coarse -> fine over ``num_levels`` strided
  subsamples of the model cloud; iteration counts are static per level
  with convergence masking (update norm < tolerance), jit-stable.

Conventions match the oracle (measured, SURVEY.md section 3.3): clouds are
[N, 6] xyz+normal, the model moves, the scene stays fixed, the returned
pose maps model -> scene; scene normals drive the point-to-plane metric.
Parity: recovers injected SE(3) perturbations to <=1e-4 (tests).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.core.config import ICPParams
from object_detector_6d_tpu.core.se3 import SE3

_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _nearest_scene(model_pts, scene_pts, scene_valid):
    """Indices + squared distances of scene NN for each model point.

    model_pts [N, 3], scene_pts [M, 3]; one matmul for the cross
    term. Invalid scene rows are pushed to +inf.
    """
    m2 = jnp.sum(model_pts * model_pts, axis=-1, keepdims=True)  # [N,1]
    s2 = jnp.sum(scene_pts * scene_pts, axis=-1)[None, :]  # [1,M]
    cross = _mm(model_pts, scene_pts.T)  # [N,M]
    d2 = m2 + s2 - 2.0 * cross
    d2 = jnp.where(scene_valid[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=-1)
    return idx, jnp.take_along_axis(d2, idx[:, None], axis=-1)[:, 0]


def _solve6(A, b):
    """Solve the 6x6 normal equations with relative Levenberg damping.

    Degenerate directions (e.g. rotation about a sphere's center, where
    point-to-plane residuals vanish identically) would otherwise amplify
    f32 noise into large spurious updates."""
    lam = 1e-6 * jnp.trace(A) + 1e-12
    A = A + lam * jnp.eye(6, dtype=A.dtype)
    return jnp.linalg.solve(A, b)


def _p2pl_step(pose, model_pc, scene_pts, scene_nrm, scene_valid, sample_mask, rejection_scale, max_corr_dist=None):
    """One point-to-plane iteration: associate, reject, solve, retract.

    ``max_corr_dist``: optional absolute correspondence cap on top of the
    MAD rule — occluded model points otherwise latch onto whatever
    surface is nearest and drag the pose (config-3 robustness)."""
    mp = SE3.apply(pose, model_pc[:, :3])
    idx, d2 = _nearest_scene(mp, scene_pts, scene_valid)
    q = scene_pts[idx]
    n = scene_nrm[idx]

    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    big = jnp.float32(1e30)
    d_masked = jnp.where(sample_mask, d, big)
    # mask-aware robust statistics: nanmedian ignores masked samples
    # (jnp.median would return NaN for any partially-masked batch and the
    # rejection threshold would collapse to 0, freezing the pose)
    d_nan = jnp.where(sample_mask, d, jnp.nan)
    med = jnp.nan_to_num(jnp.nanmedian(d_nan))
    mad = jnp.nan_to_num(jnp.nanmedian(jnp.abs(d_nan - med)))
    sigma = jnp.float32(1.4826) * mad
    thr = med + rejection_scale * sigma
    if max_corr_dist is not None:
        thr = jnp.minimum(thr, max_corr_dist)
    w = (sample_mask & (d_masked <= thr) & jnp.isfinite(d_masked)).astype(jnp.float32)

    r = jnp.sum((mp - q) * n, axis=-1)  # signed point-to-plane residual
    # Rotation parametrized about the (weighted) model centroid: with the
    # camera-frame origin ~1.3 m away, origin-centered rotations alias
    # translations (ill-conditioned normal equations) and Gauss-Newton
    # diverges; centering is also what the canonical icp.cpp does
    # (mean-point subtraction before minimization).
    wsum0 = jnp.maximum(jnp.sum(w), 1.0)
    c = jnp.sum(mp * w[:, None], axis=0) / wsum0
    J = jnp.concatenate([jnp.cross(mp - c, n), n], axis=-1)  # [N, 6]
    Jw = J * w[:, None]
    A = _mm(Jw.T, J)
    b = -_mm(Jw.T, r[:, None])[:, 0]
    x = _solve6(A, b)
    dT = SE3.exp(x)
    # conjugate by the centroid shift: rotate about c, not the origin
    shift = SE3.from_rt(jnp.eye(3, dtype=pose.dtype), c)
    unshift = SE3.from_rt(jnp.eye(3, dtype=pose.dtype), -c)
    new_pose = SE3.compose(shift, SE3.compose(dT, SE3.compose(unshift, pose)))
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    residual = jnp.sum(jnp.abs(r) * w) / wsum
    return new_pose, jnp.linalg.norm(x), residual


@dataclasses.dataclass
class ICP:
    """Point-to-plane ICP (mirrors ppf_match_3d::ICP, icp.hpp:117)."""

    iterations: int = 250
    tolerance: float = 0.005
    rejection_scale: float = 2.5
    num_levels: int = 6

    @classmethod
    def from_params(cls, p: ICPParams) -> "ICP":
        return cls(p.iterations, p.tolerance, p.rejection_scale, p.num_levels)

    def register_model_to_scene(
        self,
        model_pc: np.ndarray,
        scene_pc: np.ndarray,
        poses: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Refine pose hypotheses; returns (residuals [B], poses [B, 4, 4]).

        ``model_pc`` [N, 6], ``scene_pc`` [M, 6] (xyz + normal). ``poses``
        [B, 4, 4] initial model->scene transforms (identity if omitted);
        single-pose input ([4, 4]) is accepted and returned unbatched,
        mirroring the oracle's single/multi entry points (icp.hpp:139,152).
        """
        model_pc = np.asarray(model_pc, np.float32)
        scene_pc = np.asarray(scene_pc, np.float32)
        single = poses is not None and np.ndim(poses) == 2
        if poses is None:
            poses = np.eye(4, dtype=np.float32)[None]
        poses = np.asarray(poses, np.float32).reshape(-1, 4, 4)
        residuals, out = _icp_run(
            jnp.asarray(model_pc),
            jnp.asarray(scene_pc),
            jnp.asarray(poses),
            self.iterations,
            jnp.float32(self.tolerance),
            jnp.float32(self.rejection_scale),
            self.num_levels,
        )
        residuals = np.asarray(residuals)
        out = np.asarray(out)
        if single:
            return float(residuals[0]), out[0]
        return residuals, out


@functools.partial(jax.jit, static_argnames=("iterations", "num_levels"))
def _icp_run(model_pc, scene_pc, poses, iterations, tolerance, rejection_scale, num_levels):
    """vmapped multi-resolution ICP over the hypothesis batch."""
    N = model_pc.shape[0]
    scene_pts = scene_pc[:, :3]
    scene_nrm = scene_pc[:, 3:6]
    scene_valid = jnp.isfinite(scene_pts).all(axis=-1) & jnp.isfinite(scene_nrm).all(axis=-1)
    scene_pts = jnp.nan_to_num(scene_pts)
    scene_nrm = jnp.nan_to_num(scene_nrm)

    def refine_one(pose0):
        pose = pose0
        residual = jnp.float32(0.0)
        for level in range(num_levels - 1, -1, -1):
            stride = 1 << level
            n_lvl = max(1, N // stride)
            # static strided subsample of the model for this level;
            # NaN-padded model rows are masked out (fixed-size batching)
            sample = model_pc[::stride][:n_lvl]
            mask = jnp.isfinite(sample[:, :3]).all(-1)
            sample = jnp.nan_to_num(sample)
            iters = max(1, iterations // num_levels)

            def body(carry):
                i, pose, _res, _upd = carry
                new_pose, upd, res = _p2pl_step(
                    pose, sample, scene_pts, scene_nrm, scene_valid, mask, rejection_scale
                )
                return i + 1, new_pose, res, upd

            def cond(carry):
                i, _pose, _res, upd = carry
                return (i < iters) & (upd >= tolerance)

            _, pose, residual, _ = jax.lax.while_loop(
                cond, body, (0, pose, residual, jnp.float32(1e9))
            )
        return residual, pose

    residuals, out_poses = jax.vmap(refine_one)(poses)
    return residuals, out_poses
