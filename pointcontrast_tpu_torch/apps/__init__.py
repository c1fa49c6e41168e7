"""Command-line entry points (port): ``python -m
pointcontrast_tpu_torch.apps.votenet``."""
