"""Semantic-segmentation finetuning (port of ``pointcontrast_tpu/semseg``):
voxelization datasets and transforms (host numpy copies), chunked
collation into ``SemsegBatch``, the mean-field CRF wrappers over the
flat-map conv, and ``SemsegTrainer`` with whole-split validation."""
