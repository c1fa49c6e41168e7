"""Dataset registry (port of ``pointcontrast_tpu/semseg/datasets``).

Only ``SyntheticSemsegDataset`` is ported: the ScanNet and Stanford loaders
read scenes that are not in the repository, and ``load_dataset`` names them
with a ``NotImplementedError``."""
from __future__ import annotations

from pointcontrast_tpu_torch.semseg.datasets.synthetic import SyntheticSemsegDataset

DATASETS: list = [SyntheticSemsegDataset]

# the JAX package's other semseg datasets
NOT_PORTED = (
    "ScannetVoxelizationDataset", "ScannetVoxelization2cmDataset",
    "StanfordDataset", "StanfordArea5Dataset", "StanfordArea53cmDataset",
    "StanfordArea57d5cmDataset", "StanfordArea510cmDataset",
)


def load_dataset(name: str):
    mdict = {d.__name__: d for d in DATASETS}
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"data.dataset={name}: the ScanNet and Stanford semseg loaders are "
            "not ported, their scenes are not in the repository (ROADMAP Queue 1 "
            "item 9); use SyntheticSemsegDataset")
    if name not in mdict:
        raise ValueError(f"Dataset {name} not defined; options: {sorted(mdict)}")
    return mdict[name]
