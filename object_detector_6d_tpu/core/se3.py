"""SE(3) rigid transforms: exp/log maps, quaternion dual form, batching.

Plays the role of the reference stack's ``Pose3D`` (pose_3d.hpp:70-131):
a pose is kept as a 4x4 homogeneous matrix with helpers for the
quaternion dual form (``updatePose(q, t)``), composition (``appendPose``)
and SE(3) exponential updates used by the ICP solver (icp.hpp; the
Kok-Lim Low linearization produces a twist that we retract with
``SE3.exp``).

All functions are pure jnp and broadcast over leading batch axes, so the
multi-hypothesis ICP can simply ``vmap``/batch over poses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Default-precision f32 matmuls may run in reduced precision (TF32 on a
# GPU); pose math needs full f32.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def hat(w):
    """Skew-symmetric matrix of ``w`` [..., 3] -> [..., 3, 3]."""
    w = jnp.asarray(w)
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w):
    """Rodrigues: rotation vector [..., 3] -> rotation matrix [..., 3, 3]."""
    w = jnp.asarray(w)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + 1e-32)
    # Stable small-angle coefficients sin(t)/t and (1-cos t)/t^2.
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(w)
    WW = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def so3_log(R):
    """Rotation matrix [..., 3, 3] -> rotation vector [..., 3]."""
    R = jnp.asarray(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = theta < 1e-6
    scale = jnp.where(small, 0.5 + theta**2 / 12.0, theta / (2.0 * jnp.sin(jnp.where(small, 1.0, theta))))
    return vee * scale[..., None]


class SE3:
    """Namespace of pure functions over [..., 4, 4] homogeneous transforms."""

    @staticmethod
    def identity(dtype=jnp.float32, batch_shape=()):
        return jnp.broadcast_to(jnp.eye(4, dtype=dtype), (*batch_shape, 4, 4))

    @staticmethod
    def from_rt(R, t):
        """Rotation [..., 3, 3] + translation [..., 3] -> [..., 4, 4]."""
        R = jnp.asarray(R)
        t = jnp.asarray(t)
        batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
        R = jnp.broadcast_to(R, (*batch, 3, 3))
        t = jnp.broadcast_to(t, (*batch, 3))
        top = jnp.concatenate([R, t[..., :, None]], axis=-1)
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), (*batch, 1, 4)
        )
        return jnp.concatenate([top, bottom], axis=-2)

    @staticmethod
    def rotation(T):
        return jnp.asarray(T)[..., :3, :3]

    @staticmethod
    def translation(T):
        return jnp.asarray(T)[..., :3, 3]

    @staticmethod
    def exp(twist):
        """Twist [..., 6] (rotation w, translation v) -> [..., 4, 4].

        Matches the ICP update convention: rotation applied via Rodrigues,
        translation taken verbatim (Kok-Lim Low linearized update, the same
        retraction the canonical icp.cpp applies per iteration).
        """
        twist = jnp.asarray(twist)
        w, v = twist[..., :3], twist[..., 3:]
        return SE3.from_rt(so3_exp(w), v)

    @staticmethod
    def log(T):
        """[..., 4, 4] -> twist [..., 6] (exact inverse of a from_rt-style
        (R, t) pair: rotation vector and raw translation)."""
        return jnp.concatenate(
            [so3_log(SE3.rotation(T)), SE3.translation(T)], axis=-1
        )

    @staticmethod
    def compose(A, B):
        """A @ B with broadcasting over leading axes."""
        return _mm(jnp.asarray(A), jnp.asarray(B))

    @staticmethod
    def inverse(T):
        R = SE3.rotation(T)
        t = SE3.translation(T)
        Rt = jnp.swapaxes(R, -1, -2)
        return SE3.from_rt(Rt, -(_mm(Rt, t[..., None]))[..., 0])

    @staticmethod
    def apply(T, pts):
        """Transform points [..., N, 3] (or [..., 3]) by T [..., 4, 4]."""
        R = SE3.rotation(T)
        t = SE3.translation(T)
        pts = jnp.asarray(pts)
        if pts.ndim >= 2 and pts.shape[-2:] != (3,):
            return _mm(pts, jnp.swapaxes(R, -1, -2)) + t[..., None, :]
        return (_mm(R, pts[..., None]))[..., 0] + t

    @staticmethod
    def rotate(T, vecs):
        """Rotate direction vectors (normals) without translating."""
        R = SE3.rotation(T)
        return _mm(vecs, jnp.swapaxes(R, -1, -2))

    @staticmethod
    def to_quat(T):
        """[..., 4, 4] -> unit quaternion [..., 4] (w, x, y, z), w >= 0.

        Same convention as Pose3D's quaternion dual form (pose_3d.hpp).
        Shepperd's method, branch-free via jnp.where.
        """
        R = SE3.rotation(T)
        m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
        m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
        m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
        tr = m00 + m11 + m22
        # Four candidate constructions; pick the numerically best.
        qw0 = jnp.sqrt(jnp.maximum(0.0, 1.0 + tr)) / 2
        q0 = jnp.stack(
            [
                qw0,
                (m21 - m12) / (4 * qw0 + 1e-32),
                (m02 - m20) / (4 * qw0 + 1e-32),
                (m10 - m01) / (4 * qw0 + 1e-32),
            ],
            axis=-1,
        )
        qx1 = jnp.sqrt(jnp.maximum(0.0, 1.0 + m00 - m11 - m22)) / 2
        q1 = jnp.stack(
            [
                (m21 - m12) / (4 * qx1 + 1e-32),
                qx1,
                (m01 + m10) / (4 * qx1 + 1e-32),
                (m02 + m20) / (4 * qx1 + 1e-32),
            ],
            axis=-1,
        )
        qy2 = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 + m11 - m22)) / 2
        q2 = jnp.stack(
            [
                (m02 - m20) / (4 * qy2 + 1e-32),
                (m01 + m10) / (4 * qy2 + 1e-32),
                qy2,
                (m12 + m21) / (4 * qy2 + 1e-32),
            ],
            axis=-1,
        )
        qz3 = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 - m11 + m22)) / 2
        q3 = jnp.stack(
            [
                (m10 - m01) / (4 * qz3 + 1e-32),
                (m02 + m20) / (4 * qz3 + 1e-32),
                (m12 + m21) / (4 * qz3 + 1e-32),
                qz3,
            ],
            axis=-1,
        )
        cond0 = (tr > 0.0)[..., None]
        cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
        cond2 = (m11 >= m22)[..., None]
        q = jnp.where(cond0, q0, jnp.where(cond1, q1, jnp.where(cond2, q2, q3)))
        q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
        return jnp.where(q[..., :1] < 0, -q, q)

    @staticmethod
    def from_quat(q, t=None):
        """Unit quaternion [..., 4] (w, x, y, z) (+ optional t) -> [..., 4, 4]."""
        q = jnp.asarray(q)
        q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        R = jnp.stack(
            [
                jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
                jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
                jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
            ],
            axis=-2,
        )
        if t is None:
            t = jnp.zeros((*q.shape[:-1], 3), dtype=q.dtype)
        return SE3.from_rt(R, t)
