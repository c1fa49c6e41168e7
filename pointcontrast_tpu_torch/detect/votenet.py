"""VoteNet, deep Hough voting detector (port of
``pointcontrast_tpu/detect/votenet.py``), over either backbone:

  - ``Pointnet2Backbone`` ('pointnet2', the default, as in the reference):
    four set-abstraction layers (2048/1024/512/256 points; FPS K6, ball
    query K7, grouping K8) and two feature-propagation layers (three_nn and
    three_interpolate, K9) -> 1024 seeds x 256 features;
  - ``SparseConvBackbone`` ('sparseconv'): a Res16UNet over the voxel
    pyramid, ``num_seed`` FPS seeds (K6) and their voxel features (K8).  The
    JAX module gathers all N point features (``vout[point_voxel_idx]``,
    [B, N, C]) and then the seed rows; here the two index maps are composed
    first, ``point_voxel_idx[b, seed_inds[b]]``, so only the B * num_seed
    seed rows are gathered.  Values and gradients are the same
    (``tests/test_torch_detect_ops.py`` checks it); the [8, 40000, 256]
    intermediate (328 MB at the shipped shapes) never exists.

BoxNet, the ablation without voting (reference ``models/boxnet.py``), is
``VoteNet(use_voting=False)``: no ``vgen``, proposals from seed FPS, and
``detect.loss.get_loss_boxnet``.
"""
from __future__ import annotations

import torch
from torch import nn

from pointcontrast_tpu_torch.detect import ops
from pointcontrast_tpu_torch.detect.modules import (
    PointnetFPModule,
    PointnetSAModuleVotes,
    ProposalModule,
    VotingModule,
)
from pointcontrast_tpu_torch.nn.registry import load_model


class Pointnet2Backbone(nn.Module):
    """SSG PointNet++ (reference backbone_module.py:19-131)."""

    def __init__(self, input_feature_dim: int = 0, bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, generator=generator)
        self.sa1 = PointnetSAModuleVotes(2048, 0.2, 64, [64, 64, 128],
                                         in_channels=input_feature_dim, **kw)
        self.sa2 = PointnetSAModuleVotes(1024, 0.4, 32, [128, 128, 256],
                                         in_channels=128, **kw)
        self.sa3 = PointnetSAModuleVotes(512, 0.8, 16, [128, 128, 256],
                                         in_channels=256, **kw)
        self.sa4 = PointnetSAModuleVotes(256, 1.2, 16, [128, 128, 256],
                                         in_channels=256, **kw)
        self.fp1 = PointnetFPModule([256, 256], in_channels=256 + 256, **kw)
        self.fp2 = PointnetFPModule([256, 256], in_channels=256 + 256, **kw)

    def forward(self, pointcloud, end_points):
        xyz = pointcloud[..., 0:3].contiguous()
        features = (pointcloud[..., 3:].contiguous()
                    if pointcloud.shape[-1] > 3 else None)
        xyz1, feat1, inds1 = self.sa1(xyz, features)
        end_points["sa1_inds"], end_points["sa1_xyz"] = inds1, xyz1
        xyz2, feat2, _ = self.sa2(xyz1, feat1)
        end_points["sa2_xyz"] = xyz2
        xyz3, feat3, _ = self.sa3(xyz2, feat2)
        xyz4, feat4, _ = self.sa4(xyz3, feat3)
        f3 = self.fp1(xyz3, xyz4, feat3, feat4)
        f2 = self.fp2(xyz2, xyz3, feat2, f3)
        end_points["fp2_features"] = f2
        end_points["fp2_xyz"] = xyz2
        # the seeds' indices into the input cloud are the first 1024 of SA1's
        # FPS picks, not SA2's: the reference's own choice, kept (the vote
        # loss reads its labels through them)
        end_points["fp2_inds"] = inds1[:, : xyz2.shape[1]]
        return end_points


class SparseConvBackbone(nn.Module):
    """Res16UNet over voxels -> seed features of FPS-sampled points.
    ``dtype``: the net's activations (bf16: mixed precision, as JAX); the
    seeds and the heads always take the f32 cast of its output."""

    def __init__(self, input_feature_dim: int = 3, output_feature_dim: int = 256,
                 num_seed: int = 1024, model_name: str = "Res16UNet34C",
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_seed = num_seed
        self.net = load_model(model_name)(
            in_channels=input_feature_dim, out_channels=output_feature_dim,
            bn_momentum=bn_momentum, generator=generator, dtype=dtype)

    def forward(self, pointcloud, voxel_feats, pyramid, point_voxel_idx,
                end_points):
        """point_voxel_idx: [B, N] int32 rows of the [B * S_0] voxel table
        (each sample's inside its own slice; checked by DetectionBatch.to)."""
        vout = self.net(voxel_feats, pyramid).float()  # [B * S_0, C]; heads run f32
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
    """Backbone -> voting (``vgen``, unless ``use_voting=False``) -> vote
    clustering + proposals (``pnet``).  ``forward(inputs)`` takes the dict
    the JAX module takes: ``point_clouds`` and, for the sparse-conv
    backbone, ``voxel_feats``, ``voxel_pyramid`` and ``point_voxel_idx``;
    train/eval is the module's mode.  ``dtype`` is the sparse-conv
    backbone's activation dtype (PointNet++ ignores it, as in JAX)."""

    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr, input_feature_dim: int = 0,
                 num_proposal: int = 128, vote_factor: int = 1,
                 sampling: str = "vote_fps", backbone: str = "pointnet2",
                 backbone_model: str = "Res16UNet34C", use_voting: bool = True,
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        g = generator
        self.backbone = backbone
        self.use_voting = use_voting
        if backbone == "pointnet2":
            self.backbone_net = Pointnet2Backbone(
                input_feature_dim=input_feature_dim, bn_momentum=bn_momentum,
                generator=g)
        elif backbone == "sparseconv":
            self.backbone_net = SparseConvBackbone(
                input_feature_dim=input_feature_dim + 3, output_feature_dim=256,
                num_seed=1024, model_name=backbone_model,
                bn_momentum=bn_momentum, generator=g, dtype=dtype)
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        if use_voting:
            self.vgen = VotingModule(vote_factor, 256, bn_momentum=bn_momentum,
                                     generator=g)
        self.pnet = ProposalModule(
            num_class, num_heading_bin, num_size_cluster, mean_size_arr,
            num_proposal, sampling if use_voting else "seed_fps",
            bn_momentum=bn_momentum, generator=g)

    def forward(self, inputs: dict, generator: torch.Generator | None = None):
        """``generator`` feeds ``sampling="random"`` only."""
        if self.backbone == "pointnet2":
            end_points = self.backbone_net(inputs["point_clouds"], {})
        else:
            end_points = self.backbone_net(
                inputs["point_clouds"], inputs["voxel_feats"],
                inputs["voxel_pyramid"], inputs["point_voxel_idx"], {})
        xyz = end_points["fp2_xyz"]
        features = end_points["fp2_features"]
        end_points["seed_inds"] = end_points["fp2_inds"]
        end_points["seed_xyz"] = xyz
        end_points["seed_features"] = features

        if self.use_voting:
            xyz, features = self.vgen(xyz, features)
            # L2-normalize the vote features
            features = features / torch.clamp_min(
                torch.linalg.vector_norm(features, dim=-1, keepdim=True), 1e-8)
            end_points["vote_xyz"] = xyz
            end_points["vote_features"] = features
        return self.pnet(xyz, features, end_points, generator=generator)


class BoxNet(VoteNet):
    """The ablation without Hough voting (reference models/boxnet.py):
    proposals aggregate the seed features directly, by seed FPS; trains with
    ``detect.loss.get_loss_boxnet``."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("use_voting", False)
        super().__init__(*args, **kwargs)
