"""Model registry: name -> module class (every ``*Net*`` class with a
block type, as in ``pointcontrast_tpu/nn/registry.py``): the Res16UNet, the
ResUNet (with the MinkUNetHyper variant) and the ResNet families."""
from __future__ import annotations

import inspect

from pointcontrast_tpu_torch.nn import res16unet, resnet, resunet

MODELS: dict = {
    name: obj
    for module in (res16unet, resunet, resnet)
    for name, obj in inspect.getmembers(module, inspect.isclass)
    if "Net" in name and getattr(obj, "BLOCK", None) is not None
}


def load_model(name: str):
    if name not in MODELS:
        raise KeyError(f"model {name!r} not found; available: {sorted(MODELS)}")
    return MODELS[name]
