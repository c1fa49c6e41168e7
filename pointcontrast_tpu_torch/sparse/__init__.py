"""Sparse voxel engine (port).

Host side (numpy): ``hashing``, ``quantize``, ``kernel_map``, ``topology``,
``chunk`` and the ``native`` hash-join library.  Device side (torch):
``ops`` (autograd convolutions) over ``kernels`` (CUDA + plain twins).
"""

from pointcontrast_tpu_torch.sparse.hashing import HashSpec, hash_coords
from pointcontrast_tpu_torch.sparse.kernel_map import kernel_offsets
from pointcontrast_tpu_torch.sparse.quantize import sparse_quantize
from pointcontrast_tpu_torch.sparse.topology import (
    Pyramid,
    PyramidMeta,
    bucket_size,
    build_pyramid,
)
