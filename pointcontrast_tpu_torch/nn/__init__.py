"""Sparse layers, residual blocks and the Res16UNet family (port)."""

from pointcontrast_tpu_torch.nn.registry import MODELS, load_model
