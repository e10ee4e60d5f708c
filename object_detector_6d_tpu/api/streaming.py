"""Streaming multi-camera detection (BASELINE config 5: 4x30 FPS RGB-D).

``StreamingDetector.process`` runs the whole N-camera tick as ONE
device call: PoseDetector.detect_fused_batch jits match -> geometry ->
hypothesis lift -> projective ICP over the frame batch
(api/detect_program.py), so dispatch and transfer are paid once per
tick, not once per camera.

Per-frame failure isolation: an empty camera yields an empty list; a
frame whose coarse-candidate count overflows the program's static
capacity falls back to the host-orchestrated path for that frame only
(the stream never stalls — SURVEY.md section 5 failure-handling plan).

``process_host`` keeps the previous three-call host-orchestrated tick
(batched geometry + batched NN-ICP, per-camera match) as a reference
path for parity debugging.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.api.pipeline import PoseDetector, _icp_run_multi
from object_detector_6d_tpu.core.intrinsics import Intrinsics
from object_detector_6d_tpu.core.se3 import SE3
from object_detector_6d_tpu.geom.backproject import depth_to_3d
from object_detector_6d_tpu.geom.normals import normals_fals
from object_detector_6d_tpu.refine.icp import _p2pl_step
from object_detector_6d_tpu.refine.pose import Pose, cluster_poses


@functools.partial(jax.jit, static_argnames=("iterations", "num_levels"))
def _icp_pairs(models, scenes, poses, iterations, tolerance, rejection_scale, num_levels):
    """ICP where each hypothesis has its own model AND scene cloud."""
    N = models.shape[1]

    def refine_one(model_pc, scene_pc, pose0):
        scene_pts = jnp.nan_to_num(scene_pc[:, :3])
        scene_nrm = jnp.nan_to_num(scene_pc[:, 3:6])
        scene_valid = jnp.isfinite(scene_pc).all(-1)
        pose = pose0
        residual = jnp.float32(0.0)
        for level in range(num_levels - 1, -1, -1):
            stride = 1 << level
            n_lvl = max(1, N // stride)
            sample = jnp.nan_to_num(model_pc[::stride][:n_lvl])
            mask = jnp.isfinite(model_pc[::stride][:n_lvl, :3]).all(-1)
            iters = max(1, iterations // num_levels)

            def body(carry):
                i, pose, _res, _upd = carry
                new_pose, upd, res = _p2pl_step(
                    pose, sample, scene_pts, scene_nrm, scene_valid, mask, rejection_scale
                )
                return i + 1, new_pose, res, upd

            def cond(carry):
                i, _p, _r, upd = carry
                return (i < iters) & (upd >= tolerance)

            _, pose, residual, _ = jax.lax.while_loop(
                cond, body, (0, pose, residual, jnp.float32(1e9))
            )
        return residual, pose

    return jax.vmap(refine_one)(models, scenes, poses)


@functools.lru_cache(maxsize=4)
def _geometry_fn(k_bytes: bytes, shape: Tuple[int, int]):
    """Batched geometry program for a fixed K (host-precomputed FALS)."""
    from object_detector_6d_tpu.geom.normals import FalsNormals

    K = np.frombuffer(k_bytes, np.float64).reshape(3, 3)
    est = FalsNormals(shape[0], shape[1], K)
    Kj = jnp.asarray(K)

    @jax.jit
    def run(depths):
        def one(d):
            cloud = depth_to_3d(d, Kj)
            return jnp.concatenate([cloud, est(cloud)], -1)

        return jax.vmap(one)(depths)

    return run


def _batched_geometry(depths, K):
    """[N, H, W] u16 -> scene clouds+normals [N, H, W, 6] (shared K)."""
    K = np.ascontiguousarray(np.asarray(K, np.float64))
    fn = _geometry_fn(K.tobytes(), depths.shape[1:])
    return fn(depths)


class StreamingDetector:
    """Multi-camera streaming front end over a trained PoseDetector."""

    def __init__(
        self,
        pose_detector: PoseDetector,
        n_cameras: int = 4,
        scene_stride: int = 4,
    ):
        self.det = pose_detector
        self.n_cameras = n_cameras
        self.scene_stride = scene_stride

    def process(
        self,
        depths: np.ndarray,  # [N, H, W] u16
        K: np.ndarray,  # shared intrinsics (per-camera K: call per group)
        rgbs: Optional[np.ndarray] = None,  # [N, H, W, 3]
        match_threshold: Optional[float] = None,
    ) -> List[List[Pose]]:
        """One fused device call for the whole camera batch."""
        return self.det.detect_fused_batch(
            np.asarray(depths), K, rgbs, match_threshold=match_threshold
        )

    def process_host(
        self,
        depths: np.ndarray,  # [N, H, W] u16
        K: np.ndarray,  # shared intrinsics (per-camera K: call per group)
        rgbs: Optional[np.ndarray] = None,  # [N, H, W, 3]
        match_threshold: Optional[float] = None,
    ) -> List[List[Pose]]:
        det = self.det
        p = det.params
        thr = p.match_threshold if match_threshold is None else match_threshold
        N = depths.shape[0]

        # 1. match every frame (fused program per frame; the detector
        #    caches programs per shape so this stays on-device)
        all_matches = []
        for i in range(N):
            sources = det._sources(None if rgbs is None else rgbs[i], depths[i])
            all_matches.append(det.detector.match(sources, thr)[: p.max_hypotheses])

        # 2. one batched geometry pass
        scene6 = np.asarray(_batched_geometry(jnp.asarray(depths), K))
        intr = Intrinsics.from_matrix(np.asarray(K))
        H, W = depths.shape[1:]

        # 3. lift all hypotheses across cameras
        hyps = []  # (camera, Match, rec, pose0)
        for cam, matches in enumerate(all_matches):
            cloud = scene6[cam, :, :, :3]
            for m in matches:
                rec = det.views.get((m.class_id, m.template_id))
                if rec is None:
                    continue
                bw, bh = rec.bbox[2], rec.bbox[3]
                y0, y1 = max(0, m.y), min(H, m.y + bh + 1)
                x0, x1 = max(0, m.x), min(W, m.x + bw + 1)
                zwin = cloud[y0:y1, x0:x1, 2]
                z = float(np.nanmedian(zwin)) if np.isfinite(zwin).any() else float("nan")
                if not np.isfinite(z):
                    continue
                target = np.asarray(intr.reproject(m.x + bw / 2.0, m.y + bh / 2.0, z))
                pose0 = np.eye(4, dtype=np.float32)
                pose0[:3, 3] = target - rec.anchor_point
                hyps.append((cam, m, rec, pose0))
        if not hyps:
            return [[] for _ in range(N)]

        # 4. one batched ICP over all (camera, hypothesis) pairs
        s = self.scene_stride
        scenes_sub = scene6[:, ::s, ::s].reshape(N, -1, 6)
        models = np.stack([h[2].model_cloud for h in hyps])
        poses0 = np.stack([h[3] for h in hyps])
        scene_per_hyp = scenes_sub[[h[0] for h in hyps]]
        icp = p.icp
        residuals, poses = _icp_pairs(
            jnp.asarray(models),
            jnp.asarray(scene_per_hyp),
            jnp.asarray(poses0),
            icp.iterations,
            jnp.float32(icp.tolerance),
            jnp.float32(icp.rejection_scale),
            icp.num_levels,
        )
        residuals = np.asarray(residuals)
        poses = np.asarray(poses)

        # 5. per-camera scoring + NMS
        out: List[List[Pose]] = [[] for _ in range(N)]
        per_cam: Dict[int, List[Pose]] = {}
        for i, (cam, m, rec, _p0) in enumerate(hyps):
            pose = poses[i]
            if rec.view_pose is not None:
                pose = pose @ rec.view_pose
            per_cam.setdefault(cam, []).append(
                Pose(
                    pose=np.asarray(pose, np.float64),
                    residual=float(residuals[i]),
                    num_votes=int(round(m.similarity * 100)),
                    class_id=m.class_id,
                    template_id=m.template_id,
                    match_x=m.x,
                    match_y=m.y,
                    match_similarity=m.similarity,
                )
            )
        for cam, plist in per_cam.items():
            clusters = cluster_poses(
                plist, translation_threshold=p.nms_radius_px / float(intr.fx)
            )
            out[cam] = [c.mean_pose() for c in clusters]
        return out
