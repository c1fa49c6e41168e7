"""Contrastive losses (port)."""

from pointcontrast_tpu_torch.losses.contrastive import point_info_nce_loss
