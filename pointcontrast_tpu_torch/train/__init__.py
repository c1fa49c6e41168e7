"""Pretraining step, trainer and optimizer (port)."""

from pointcontrast_tpu_torch.train.pretrain import (
    PretrainConfig,
    PretrainTrainer,
    latest_checkpoint,
    make_train_step,
)
