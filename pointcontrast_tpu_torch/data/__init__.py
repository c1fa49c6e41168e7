"""Data pipeline (port): synthetic frame pairs, correspondence matching and
fixed-shape fused-frame collation into ``PairBatch``."""

from pointcontrast_tpu_torch.data.collate import (
    PadScheme,
    PairBatch,
    check_bounds,
    check_pyramid_bounds,
    collate_pair,
    pyramid_to,
    sample_nce_pairs,
)
from pointcontrast_tpu_torch.data.matching import radius_matches
from pointcontrast_tpu_torch.data.pair_dataset import (
    SyntheticPairDataset,
    rotation_matrix,
    sample_random_trans,
)
