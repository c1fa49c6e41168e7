"""3D object detection (port): VoteNet over the sparse-conv backbone.

The PointNet++ ops run through hand-written sm_90a kernels
(``csrc/detect_ops.cu``, wrapped in ``detect.kernels``): FPS, ball query
and the row gather with its scatter-add backward.  The heads are torch
modules with flax's BatchNorm semantics, the loss and the Adam trainer are
plain torch, and NMS / AP stay host numpy as in the JAX package.
"""

from pointcontrast_tpu_torch.detect.ops import (
    ball_query,
    furthest_point_sample,
    gather,
    gather_points,
    group_points,
)
