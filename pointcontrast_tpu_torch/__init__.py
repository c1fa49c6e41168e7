"""PyTorch + CUDA port of ``pointcontrast_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference.  This package imports torch and
never jax, flax, optax or ``pointcontrast_tpu``; its host pipeline
(``sparse`` topology, ``data`` collation) is a jax-free copy of the JAX
package's and gives byte-identical batches.  The chunked sparse convolutions
run through hand-written sm_90a CUDA kernels (``csrc/sparse_conv.cu``,
wrapped in ``sparse.kernels``).
"""
