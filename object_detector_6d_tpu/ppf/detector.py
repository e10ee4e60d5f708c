"""PPF global 6D detector (reference N13: PPF3DDetector,
ppf_match_3d.hpp:79-172; Drost et al., CVPR 2010).

Template-free hypothesis source: point-pair features F(p1,n1,p2,n2) =
(||d||, angle(n1,d), angle(n2,d), angle(n1,n2)) vote in a Hough space
over (model reference point, in-plane rotation alpha).

Device redesign of the reference's C++:

* the open-addressing ``hashtable_int`` (N15) becomes a **sorted key
  table + binary search** — model pair keys are sorted once at train
  time; scene lookups are ``searchsorted`` + a capped contiguous range
  read, which vectorizes (no pointer chasing);
* training computes all N^2 pair features as one batched jnp program;
* matching vmaps over scene reference points: each builds its pair
  features against the whole sampled scene, looks up matching model
  pairs, and scatter-adds votes into its (model point, alpha) table;
* pose clustering reuses refine/pose.cluster_poses.

Angle/distance quantization follows the reference defaults (30 angle
bins, relative distance step), and alpha is computed with the standard
"align reference point+normal to the x-axis" construction.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.core.se3 import SE3
from object_detector_6d_tpu.ppf.helpers import sample_pc_by_quantization
from object_detector_6d_tpu.refine.pose import Pose, cluster_poses

_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

_NUM_ANGLE_BINS = 30


def _align_to_x(p: jnp.ndarray, n: jnp.ndarray):
    """Transform taking point p to origin and normal n onto +x.

    Returns (R [3,3], t [3]). Standard PPF construction."""
    n = n / (jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    # rotation about axis = n x ex by angle(n, ex)
    ex = jnp.array([1.0, 0.0, 0.0], n.dtype)
    axis = jnp.cross(n, ex)
    axis_norm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    # degenerate: n parallel to ex
    safe_axis = jnp.where(axis_norm > 1e-7, axis / (axis_norm + 1e-12), jnp.array([0.0, 1.0, 0.0], n.dtype))
    cosang = jnp.clip(jnp.sum(n * ex, -1), -1.0, 1.0)
    ang = jnp.arccos(cosang)
    from object_detector_6d_tpu.core.se3 import so3_exp

    R = so3_exp(safe_axis * ang[..., None])
    t = -_mm(R, p[..., None])[..., 0]
    return R, t


def _pair_features(p1, n1, p2, n2):
    """4D PPF (d, angle(n1,d), angle(n2,d), angle(n1,n2))."""
    d = p2 - p1
    dist = jnp.linalg.norm(d, axis=-1)
    dn = d / (dist[..., None] + 1e-12)

    def ang(a, b):
        return jnp.arccos(jnp.clip(jnp.sum(a * b, -1), -1.0, 1.0))

    return dist, ang(n1, dn), ang(n2, dn), ang(n1, n2)


def _alpha(p_r, n_r, p_i):
    """In-plane angle of p_i after aligning (p_r, n_r) to the x-axis."""
    R, t = _align_to_x(p_r, n_r)
    q = _mm(R, p_i[..., None])[..., 0] + t
    return jnp.arctan2(-q[..., 2], q[..., 1])


@dataclasses.dataclass
class PPFDetector:
    """Mirrors ppf_match_3d::PPF3DDetector(relative_sampling_step,
    relative_distance_step, num_angles)."""

    relative_sampling_step: float = 0.05
    relative_distance_step: float = 0.05
    num_angles: int = _NUM_ANGLE_BINS

    # trained state
    model_sampled: Optional[np.ndarray] = None
    model_diameter: float = 0.0
    _keys_sorted: Optional[np.ndarray] = None
    _vals_i: Optional[np.ndarray] = None
    _vals_alpha: Optional[np.ndarray] = None

    def train_model(self, model_pc: np.ndarray) -> None:
        """Build the sorted pair-feature table from a [N, 6] model cloud."""
        model = sample_pc_by_quantization(
            np.asarray(model_pc, np.float32), self.relative_sampling_step
        )
        self.model_sampled = model
        xyz = model[:, :3]
        lo, hi = xyz.min(0), xyz.max(0)
        self.model_diameter = float(np.linalg.norm(hi - lo))
        keys, alphas, idx_i = _train_pairs(
            jnp.asarray(model),
            jnp.float32(self.relative_distance_step * self.model_diameter),
            self.num_angles,
        )
        keys = np.asarray(keys).reshape(-1)
        alphas = np.asarray(alphas).reshape(-1)
        idx_i = np.asarray(idx_i).reshape(-1)
        valid = keys >= 0
        keys, alphas, idx_i = keys[valid], alphas[valid], idx_i[valid]
        order = np.argsort(keys, kind="stable")
        self._keys_sorted = keys[order]
        self._vals_i = idx_i[order].astype(np.int32)
        self._vals_alpha = alphas[order].astype(np.float32)

    def write(self, path: str) -> None:
        """Serialize the trained detector (PPF3DDetector::write,
        ppf_match_3d.hpp:144). The canonical library DECLARES read/write
        but never implements them (no symbols in
        libopencv_surface_matching.so.4.6.0 — linking fails [measured]),
        so there is no oracle format to match; we store the trained
        state as npz, which round-trips exactly."""
        if self._keys_sorted is None:
            raise ValueError("detector is untrained; nothing to write")
        np.savez_compressed(
            path,
            relative_sampling_step=self.relative_sampling_step,
            relative_distance_step=self.relative_distance_step,
            num_angles=self.num_angles,
            model_sampled=self.model_sampled,
            model_diameter=self.model_diameter,
            keys_sorted=self._keys_sorted,
            vals_i=self._vals_i,
            vals_alpha=self._vals_alpha,
        )

    @classmethod
    def read(cls, path: str) -> "PPFDetector":
        """Load a detector written by :meth:`write` (trained state)."""
        g = np.load(path)
        det = cls(
            relative_sampling_step=float(g["relative_sampling_step"]),
            relative_distance_step=float(g["relative_distance_step"]),
            num_angles=int(g["num_angles"]),
        )
        det.model_sampled = g["model_sampled"]
        det.model_diameter = float(g["model_diameter"])
        det._keys_sorted = g["keys_sorted"]
        det._vals_i = g["vals_i"]
        det._vals_alpha = g["vals_alpha"]
        return det

    def match(
        self,
        scene_pc: np.ndarray,
        relative_scene_sample_step: float = 0.2,
        relative_scene_distance: float = 0.03,
        max_results: int = 8,
        matches_per_pair: int = 8,
    ) -> List[Pose]:
        """Detect the trained model in a [M, 6] scene cloud."""
        assert self.model_sampled is not None, "train_model first"
        scene = sample_pc_by_quantization(
            np.asarray(scene_pc, np.float32), relative_scene_distance
        )
        stride = max(1, int(round(1.0 / relative_scene_sample_step)))
        ref_idx = np.arange(0, len(scene), stride)
        votes, pose_params = _match_refs(
            jnp.asarray(scene),
            jnp.asarray(ref_idx.astype(np.int32)),
            jnp.asarray(self.model_sampled),
            jnp.asarray(self._keys_sorted),
            jnp.asarray(self._vals_i),
            jnp.asarray(self._vals_alpha),
            jnp.float32(self.relative_distance_step * self.model_diameter),
            self.num_angles,
            matches_per_pair,
        )
        votes = np.asarray(votes)
        pose_params = np.asarray(pose_params)  # [R, 4, 4]
        poses = [
            Pose(pose=pose_params[r].astype(np.float64), num_votes=int(votes[r]))
            for r in range(len(ref_idx))
            if votes[r] > 0
        ]
        clusters = cluster_poses(
            poses,
            rotation_threshold_rad=np.deg2rad(30.0),
            translation_threshold=0.1 * self.model_diameter,
            per_class=False,
        )
        return [c.mean_pose() for c in clusters[:max_results]]


@functools.partial(jax.jit, static_argnames=("num_angles",))
def _train_pairs(model, dist_step, num_angles):
    xyz = model[:, :3]
    nrm = model[:, 3:6]
    N = xyz.shape[0]
    p1 = xyz[:, None, :]
    n1 = nrm[:, None, :]
    p2 = xyz[None, :, :]
    n2 = nrm[None, :, :]
    dist, a1, a2, a3 = _pair_features(p1, n1, p2, n2)
    angle_step = jnp.pi / num_angles
    kd = (dist / dist_step).astype(jnp.int32)
    k1 = (a1 / angle_step).astype(jnp.int32)
    k2 = (a2 / angle_step).astype(jnp.int32)
    k3 = (a3 / angle_step).astype(jnp.int32)
    key = ((kd * 64 + k1) * 64 + k2) * 64 + k3
    eye = jnp.eye(N, dtype=bool)
    key = jnp.where(eye, -1, key)
    alpha = _alpha(
        jnp.broadcast_to(p1, (N, N, 3)).reshape(-1, 3),
        jnp.broadcast_to(n1, (N, N, 3)).reshape(-1, 3),
        jnp.broadcast_to(p2, (N, N, 3)).reshape(-1, 3),
    ).reshape(N, N)
    idx_i = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    return key, alpha, idx_i


@functools.partial(jax.jit, static_argnames=("num_angles", "matches_per_pair"))
def _match_refs(
    scene, ref_idx, model, keys_sorted, vals_i, vals_alpha, dist_step, num_angles, matches_per_pair
):
    s_xyz = scene[:, :3]
    s_nrm = scene[:, 3:6]
    m_xyz = model[:, :3]
    m_nrm = model[:, 3:6]
    Nm = m_xyz.shape[0]
    angle_step = jnp.pi / num_angles
    n_alpha = 2 * num_angles

    def one_ref(r):
        p_r = s_xyz[r]
        n_r = s_nrm[r]
        dist, a1, a2, a3 = _pair_features(p_r[None], n_r[None], s_xyz, s_nrm)
        kd = (dist / dist_step).astype(jnp.int32)
        k1 = (a1 / angle_step).astype(jnp.int32)
        k2 = (a2 / angle_step).astype(jnp.int32)
        k3 = (a3 / angle_step).astype(jnp.int32)
        key = ((kd * 64 + k1) * 64 + k2) * 64 + k3
        alpha_s = _alpha(p_r[None], n_r[None], s_xyz)

        start = jnp.searchsorted(keys_sorted, key)
        # capped range read per scene pair
        offs = jnp.arange(matches_per_pair)
        idx = start[:, None] + offs[None, :]
        idx_c = jnp.clip(idx, 0, keys_sorted.shape[0] - 1)
        hit = (keys_sorted[idx_c] == key[:, None]) & (idx < keys_sorted.shape[0])
        m_i = vals_i[idx_c]
        alpha_m = vals_alpha[idx_c]
        # vote bin: alpha = alpha_m - alpha_s  in [-2pi, 2pi] -> [0, n_alpha)
        da = alpha_m - alpha_s[:, None]
        da = jnp.mod(da + 2 * jnp.pi, 2 * jnp.pi)
        a_bin = jnp.minimum((da / (2 * jnp.pi / n_alpha)).astype(jnp.int32), n_alpha - 1)
        flat_bin = jnp.where(hit, m_i * n_alpha + a_bin, Nm * n_alpha)
        acc = jnp.zeros((Nm * n_alpha + 1,), jnp.int32)
        acc = acc.at[flat_bin.reshape(-1)].add(1)
        acc = acc[:-1]
        best = jnp.argmax(acc)
        best_votes = acc[best]
        best_i = best // n_alpha
        best_a = (best % n_alpha).astype(jnp.float32) * (2 * jnp.pi / n_alpha)
        # pose: T = T_sg^-1 . Rx(alpha) . T_mg
        R_m, t_m = _align_to_x(m_xyz[best_i], m_nrm[best_i])
        R_s, t_s = _align_to_x(p_r, n_r)
        T_mg = SE3.from_rt(R_m, t_m)
        T_sg = SE3.from_rt(R_s, t_s)
        ca, sa = jnp.cos(best_a), jnp.sin(best_a)
        Rx = jnp.array([[1, 0, 0], [0, 0, 0], [0, 0, 0]], jnp.float32)
        Rx = Rx.at[1, 1].set(ca).at[1, 2].set(-sa).at[2, 1].set(sa).at[2, 2].set(ca)
        T = SE3.compose(SE3.inverse(T_sg), SE3.compose(SE3.from_rt(Rx, jnp.zeros(3, jnp.float32)), T_mg))
        return best_votes, T

    votes, poses = jax.vmap(one_ref)(ref_idx)
    return votes, poses
