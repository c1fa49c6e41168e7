"""Data pipeline (port): synthetic and ScanNet frame pairs, correspondence
matching, fixed-shape fused-frame collation into ``PairBatch`` (NCE or
hardest-contrastive sampling) and the prefetching ``PairLoader``."""

from pointcontrast_tpu_torch.data.collate import (
    PadScheme,
    PairBatch,
    check_bounds,
    check_pyramid_bounds,
    collate_pair,
    pyramid_to,
    sample_hardest_contrastive,
    sample_nce_pairs,
)
from pointcontrast_tpu_torch.data.loader import PairLoader
from pointcontrast_tpu_torch.data.matching import radius_matches
from pointcontrast_tpu_torch.data.pair_dataset import (
    ScanNetMatchPairDataset,
    SyntheticPairDataset,
    rotation_matrix,
    sample_random_trans,
)
