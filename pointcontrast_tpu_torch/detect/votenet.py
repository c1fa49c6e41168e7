"""VoteNet, deep Hough voting detector, over the sparse-conv backbone (port
of ``pointcontrast_tpu/detect/votenet.py``).

``SparseConvBackbone`` runs a Res16UNet over the voxel pyramid, samples
``num_seed`` seeds per cloud with FPS (K6) and gathers the seeds' voxel
features (K8).  The JAX module gathers all N point features
(``vout[point_voxel_idx]``, [B, N, C]) and then the seed rows; here the two
index maps are composed first, ``point_voxel_idx[b, seed_inds[b]]``, so
only the B * num_seed seed rows are gathered.  Values and gradients are the
same (``tests/test_torch_votenet.py`` checks it); the [8, 40000, 256]
intermediate (328 MB at the shipped shapes) never exists.

Not ported yet (ROADMAP Queue 1 item 10): the PointNet++ backbone, which
needs three_nn / three_interpolate (K9), and BoxNet (``use_voting=False``).
"""
from __future__ import annotations

import torch
from torch import nn

from pointcontrast_tpu_torch.detect import ops
from pointcontrast_tpu_torch.detect.modules import ProposalModule, VotingModule
from pointcontrast_tpu_torch.nn.registry import load_model


class SparseConvBackbone(nn.Module):
    """Res16UNet over voxels -> seed features of FPS-sampled points."""

    def __init__(self, input_feature_dim: int = 3, output_feature_dim: int = 256,
                 num_seed: int = 1024, model_name: str = "Res16UNet34C",
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_seed = num_seed
        self.net = load_model(model_name)(
            in_channels=input_feature_dim, out_channels=output_feature_dim,
            bn_momentum=bn_momentum, generator=generator)

    def forward(self, pointcloud, voxel_feats, pyramid, point_voxel_idx,
                end_points):
        """point_voxel_idx: [B, N] int32 rows of the [B * S_0] voxel table
        (each sample's inside its own slice; checked by DetectionBatch.to)."""
        vout = self.net(voxel_feats, pyramid)  # [B * S_0, C]
        b = point_voxel_idx.shape[0]
        xyz = pointcloud[..., 0:3].contiguous()
        seed_inds = ops.furthest_point_sample(xyz, self.num_seed)
        seed_xyz = ops.gather(xyz, seed_inds)
        rows = torch.gather(point_voxel_idx, 1, seed_inds.long())
        seed_feats = ops.gather(vout.unsqueeze(0), rows.reshape(1, -1))
        end_points["fp2_features"] = seed_feats.reshape(b, self.num_seed, -1)
        end_points["fp2_xyz"] = seed_xyz
        end_points["fp2_inds"] = seed_inds
        return end_points


class VoteNet(nn.Module):
    """Backbone -> voting (``vgen``) -> vote clustering + proposals
    (``pnet``).  ``forward(inputs)`` takes the dict the JAX module takes:
    ``point_clouds`` and, for the sparse-conv backbone, ``voxel_feats``,
    ``voxel_pyramid`` and ``point_voxel_idx``; train/eval is the module's
    mode."""

    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr, input_feature_dim: int = 0,
                 num_proposal: int = 128, vote_factor: int = 1,
                 sampling: str = "vote_fps", backbone: str = "pointnet2",
                 backbone_model: str = "Res16UNet34C", use_voting: bool = True,
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if backbone != "sparseconv":
            raise NotImplementedError(
                f"VoteNet backbone={backbone!r}: only 'sparseconv' is ported; "
                "the PointNet++ backbone needs three_nn/three_interpolate (K9), "
                "ROADMAP Queue 1 item 10")
        if not use_voting:
            raise NotImplementedError(
                "BoxNet (use_voting=False) and get_loss_boxnet are not ported "
                "yet (ROADMAP Queue 1 item 10)")
        g = generator
        self.backbone_net = SparseConvBackbone(
            input_feature_dim=input_feature_dim + 3, output_feature_dim=256,
            num_seed=1024, model_name=backbone_model, bn_momentum=bn_momentum,
            generator=g)
        self.vgen = VotingModule(vote_factor, 256, bn_momentum=bn_momentum,
                                 generator=g)
        self.pnet = ProposalModule(
            num_class, num_heading_bin, num_size_cluster, mean_size_arr,
            num_proposal, sampling, bn_momentum=bn_momentum, generator=g)

    def forward(self, inputs: dict, generator: torch.Generator | None = None):
        """``generator`` feeds ``sampling="random"`` only."""
        end_points = self.backbone_net(
            inputs["point_clouds"], inputs["voxel_feats"],
            inputs["voxel_pyramid"], inputs["point_voxel_idx"], {})
        xyz = end_points["fp2_xyz"]
        features = end_points["fp2_features"]
        end_points["seed_inds"] = end_points["fp2_inds"]
        end_points["seed_xyz"] = xyz
        end_points["seed_features"] = features

        xyz, features = self.vgen(xyz, features)
        # L2-normalize the vote features
        features = features / torch.clamp_min(
            torch.linalg.vector_norm(features, dim=-1, keepdim=True), 1e-8)
        end_points["vote_xyz"] = xyz
        end_points["vote_features"] = features
        return self.pnet(xyz, features, end_points, generator=generator)
