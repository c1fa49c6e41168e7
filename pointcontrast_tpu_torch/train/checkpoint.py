"""Lenient transfer loading over state dicts (port of
``pointcontrast_tpu/train/checkpoint.py::lenient_filter``): keep only the
entries whose name AND shape match, as the reference does for pretrain ->
finetune transfer (``downstream/semseg/lib/utils.py:19-76``)."""
from __future__ import annotations


def lenient_filter(target: dict, source: dict) -> tuple[dict, list, list]:
    """Copy ``source`` tensors into ``target`` where name and shape match.
    Returns (merged state dict, loaded names, skipped names), the two lists
    in ``target``'s order."""
    merged, loaded, skipped = dict(target), [], []
    for name, value in target.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            merged[name] = src
            loaded.append(name)
        else:
            skipped.append(name)
    return merged, loaded, skipped
