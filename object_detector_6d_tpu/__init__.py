"""object_detector_6d_tpu — accelerator-native depth-based 6D object detection.

A JAX / XLA framework with the capabilities of the depth-based
6D object detector ``haoruozhang/object_detector_6d`` (LINEMOD-style
template matching + point-to-plane ICP refinement), run on the GPU:

* depth -> point-cloud back-projection and surface normals as fused XLA
  programs (``geom``),
* quantized gradient/normal modalities with bit-parity to the canonical
  OpenCV 4.6 contrib implementation (``quant``),
* the LINEMOD template sweep as one batched convolution over all
  templates and image offsets (``match``),
* batched point-to-plane ICP with per-hypothesis SE(3) solves on device
  (``refine``),
* hypothesis scoring + NMS in device memory (``api``), and
* template-bank / hypothesis / camera sharding over a ``jax.sharding.Mesh``
  (``parallel``).

Public API mirrors the reference: build a :class:`Detector`, add templates
(or read a ``templates_%s.yml.gz`` store), and call
``detect(depth, K) -> list of 6D poses``.
"""

from object_detector_6d_tpu.version import __version__

# Public API surface (lazy submodule attributes keep import light).
from object_detector_6d_tpu.api.detector import Detector, Match
from object_detector_6d_tpu.api.pipeline import PoseDetector
from object_detector_6d_tpu.refine.icp import ICP
from object_detector_6d_tpu.refine.pose import Pose, PoseCluster, cluster_poses

from object_detector_6d_tpu.core.config import (
    ColorGradientParams,
    DepthNormalParams,
    DetectorParams,
    ICPParams,
)
from object_detector_6d_tpu.core.intrinsics import Intrinsics
from object_detector_6d_tpu.core.se3 import SE3

__all__ = [
    "__version__",
    "Detector",
    "Match",
    "PoseDetector",
    "ICP",
    "Pose",
    "PoseCluster",
    "cluster_poses",
    "ColorGradientParams",
    "DepthNormalParams",
    "DetectorParams",
    "ICPParams",
    "Intrinsics",
    "SE3",
]
