"""Optimizers and LR schedules (port of ``pointcontrast_tpu/train/optim.py``).

``torch.optim.SGD`` already has the update rule the JAX package emulates
(g += wd * p; buf = momentum * buf + g, buf = g on the first step;
p -= lr * buf), so only the schedules need writing: each is a step ->
factor function that a ``LambdaLR`` applies, so the n-th update (0-indexed)
runs at ``lr * factor(n)``, as the JAX schedule's update count does."""
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


def poly_lr(max_iter: int, power: float = 0.9):
    """PolyLR: (1 - step / (max_iter + 1)) ** power."""

    def factor(step: int) -> float:
        return (1.0 - step / (max_iter + 1)) ** power

    return factor


def step_lr(step_size: int, gamma: float = 0.1):
    def factor(step: int) -> float:
        return gamma ** (step // step_size)

    return factor


def squared_lr(max_iter: int):
    """SquaredLR: (1 - step / (max_iter + 1)) ** 2."""
    return poly_lr(max_iter, power=2.0)


def schedule(name: str, config):
    """The step -> factor function of a scheduler name (``explr``,
    ``polylr``, ``steplr``, ``squaredlr``), from the config's fields as the
    JAX ``make_scheduler`` reads them."""
    name = name.lower()
    if name == "explr":
        return exp_lr(config.exp_gamma, getattr(config, "exp_step_size", 1),
                      stepped=getattr(config, "pretrain_step_cadence", False))
    if name == "polylr":
        return poly_lr(config.max_iter, getattr(config, "poly_power", 0.9))
    if name == "steplr":
        return step_lr(config.step_size, getattr(config, "step_gamma", 0.1))
    if name == "squaredlr":
        return squared_lr(config.max_iter)
    raise ValueError(f"unknown scheduler {name!r}")


def make_optimizer(model: torch.nn.Module, config,
                   param_lr_scales: dict | None = None) -> torch.optim.Optimizer:
    """``config.optimizer`` (SGD when the config has none, or Adam) over the
    model's parameters.  ``param_lr_scales`` {top-level submodule name: LR
    multiplier}, e.g. the CRF wrapper's ``{"filter": wrapper_lr / lr}``,
    puts those parameters in a group of their own at ``lr * multiplier``
    (JAX: ``optax.masked(optax.scale(multiplier))`` on the update)."""
    groups: dict = {}
    for name, p in model.named_parameters():
        scale = (param_lr_scales or {}).get(name.split(".", 1)[0], 1.0)
        groups.setdefault(scale, []).append(p)
    params = [{"params": ps, "lr": config.lr * scale} for scale, ps in groups.items()]
    name = getattr(config, "optimizer", "sgd").lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=config.lr, momentum=config.momentum,
                               dampening=0.0, weight_decay=config.weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=config.lr,
                                weight_decay=config.weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def make_scheduler(opt: torch.optim.Optimizer, config, name: str | None = None):
    """A ``LambdaLR`` of the scheduler ``name``; without a name the
    pretraining schedule, the stepped ExpLR."""
    if name is None:
        factor = exp_lr(config.exp_gamma, config.lr_update_freq, stepped=True)
    else:
        factor = schedule(name, config)
    return torch.optim.lr_scheduler.LambdaLR(opt, factor)
