"""SGD and the stepped ExpLR schedule (port of the pretrain path of
``pointcontrast_tpu/train/optim.py``).

``torch.optim.SGD`` already has the update rule the JAX package emulates
(g += wd * p; buf = momentum * buf + g, buf = g on the first step;
p -= lr * buf), so only the schedule needs writing."""
from __future__ import annotations

import torch


def exp_lr(gamma: float, update_freq: int = 1, stepped: bool = False):
    """Multiplicative LR factor of 0-indexed update ``step``.

    - ``stepped=False``: ``gamma ** (step / update_freq)`` (semseg cadence).
    - ``stepped=True``: the pretrain cadence, torch ExponentialLR advanced by
      ``if curr_iter % freq == 0 or curr_iter == 1: scheduler.step()`` after
      each iteration: exponent 0 at step 0, ``step // freq + 1`` after."""

    def factor(step: int) -> float:
        if stepped:
            return 1.0 if step == 0 else gamma ** (step // update_freq + 1)
        return gamma ** (step / update_freq)

    return factor


def make_optimizer(model: torch.nn.Module, config) -> torch.optim.SGD:
    return torch.optim.SGD(
        model.parameters(), lr=config.lr, momentum=config.momentum,
        dampening=0.0, weight_decay=config.weight_decay,
    )


def make_scheduler(opt: torch.optim.Optimizer, config):
    """Stepped ExpLR as a ``LambdaLR``: after n ``sched.step()`` calls the LR
    is ``lr * exp_lr(...)(n)``, so the n-th update (0-indexed) runs at
    factor(n), as the JAX schedule's update count does."""
    return torch.optim.lr_scheduler.LambdaLR(
        opt, exp_lr(config.exp_gamma, config.lr_update_freq, stepped=True)
    )
