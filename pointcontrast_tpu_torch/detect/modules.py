"""PointNet++ building blocks and the VoteNet heads as torch modules (port of
``pointcontrast_tpu/detect/modules.py``, channels-last as there).

  - ``Dense`` / ``DenseBatchNorm``: flax's ``nn.Dense`` and ``nn.BatchNorm``
    (see ``DenseBatchNorm`` for how they differ from torch's);
  - ``SharedMLP``: Dense + BN + ReLU per layer on the trailing channel axis;
  - ``query_and_group``: ball query + one gather of [xyz, features] rows
    with centred, optionally radius-normalised xyz;
  - ``PointnetSAModuleVotes``: FPS (or given inds) -> group -> MLP -> max;
  - ``PointnetFPModule``: three_nn inverse-distance interpolation of the
    known features onto the unknown points + skip concat + MLP;
  - ``VotingModule`` and ``ProposalModule`` with ``decode_scores``.
Layouts: xyz [B, N, 3], features [B, N, C].  Submodules carry the flax names
(``conv1``, ``bn1``, ``mlp.layer0``, ``mlp.bn0``, ...), parameters the flax
layouts (Dense kernels [Cin, Cout]), so ``tools.from_jax`` is a rename.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from pointcontrast_tpu_torch.detect import ops


class Dense(nn.Module):
    """x @ weight (+ bias), weight [Cin, Cout]; LeCun-normal init as flax's
    ``nn.Dense`` (std sqrt(1/Cin), truncated at 2 std), zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        w = torch.empty(in_features, out_features)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        out = x @ self.weight
        return out if self.bias is None else out + self.bias


class DenseBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the last, which the JAX heads
    use, and which differs from ``torch.nn.BatchNorm*`` in two ways:
      - statistics are E[x] and max(E[x^2] - E[x]^2, 0), and the running
        variance takes that BIASED batch variance (torch's takes the
        unbiased one);
      - flax's ``momentum`` is the running average's decay, so the JAX
        ``momentum=1 - bn_momentum`` is ``momentum=bn_momentum`` here, in
        torch's convention: running = (1 - m) * running + m * batch.
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias, in flax's order."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = torch.clamp_min(flat.square().mean(dim=0) - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class SharedMLP(nn.Module):
    """Dense + BN + ReLU per layer, applied to the trailing channel axis."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 bn: bool = True, activation: bool = True,
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth = len(channels)
        self.activation = activation
        self.use_bn = bn
        c = in_channels
        for i, out in enumerate(channels):
            self.add_module(f"layer{i}", Dense(c, out, bias=not bn,
                                               generator=generator))
            if bn:
                self.add_module(f"bn{i}", DenseBatchNorm(out, bn_momentum))
            c = out

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn{i}")(x)
            if self.activation:
                x = torch.relu(x)
        return x


def query_and_group(xyz, new_xyz, features, radius: float, nsample: int,
                    use_xyz: bool = True, normalize_xyz: bool = False):
    """-> grouped [B, M, nsample, 3+C or C], idx [B, M, nsample].

    With xyz and features, ONE gather of the [B, N, 3+C] rows feeds both,
    then the xyz part is centred on its centre (and divided by ``radius``)."""
    idx = ops.ball_query(new_xyz, xyz, radius, nsample)
    if features is not None and not use_xyz:
        return ops.gather(features, idx), idx
    table = xyz if features is None else torch.cat([xyz, features], dim=-1)
    g = ops.gather(table, idx)
    gx = g[..., :3] - new_xyz[:, :, None, :]
    if normalize_xyz:
        gx = gx / radius
    return (gx if features is None else torch.cat([gx, g[..., 3:]], dim=-1)), idx


class PointnetSAModuleVotes(nn.Module):
    """Single-scale set abstraction with optional externally supplied
    sample inds (vote aggregation uses seed-FPS inds)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], in_channels: int, use_xyz: bool = True,
                 normalize_xyz: bool = True, bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz, self.normalize_xyz = use_xyz, normalize_xyz
        self.mlp = SharedMLP(in_channels + (3 if use_xyz else 0), mlp,
                             bn_momentum=bn_momentum, generator=generator)

    def forward(self, xyz, features, inds=None):
        if inds is None:
            inds = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather(xyz, inds)
        grouped, _ = query_and_group(
            xyz, new_xyz, features, self.radius, self.nsample,
            use_xyz=self.use_xyz, normalize_xyz=self.normalize_xyz)
        # amax splits the gradient evenly among tied maxima, as jnp.max does
        out = torch.amax(self.mlp(grouped), dim=2)
        return new_xyz, out, inds


class PointnetFPModule(nn.Module):
    """Feature propagation: interpolate known -> unknown, concatenate the
    unknown points' own features, SharedMLP.  ``in_channels`` is the known
    features' width plus the unknown ones'."""

    def __init__(self, mlp: Sequence[int], in_channels: int,
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, bn_momentum=bn_momentum,
                             generator=generator)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        dist, idx = ops.three_nn(unknown_xyz, known_xyz)
        interp = ops.three_interpolate(known_feats, idx,
                                       ops.interpolation_weights(dist))
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class VotingModule(nn.Module):
    """Per-seed vote generation: 2x Dense-BN-ReLU, then a head emitting an
    xyz offset and a feature residual per vote."""

    def __init__(self, vote_factor: int, seed_feature_dim: int,
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = seed_feature_dim
        self.vote_factor, self.c = vote_factor, c
        self.conv1 = Dense(c, c, bias=False, generator=generator)
        self.bn1 = DenseBatchNorm(c, bn_momentum)
        self.conv2 = Dense(c, c, bias=False, generator=generator)
        self.bn2 = DenseBatchNorm(c, bn_momentum)
        self.conv3 = Dense(c, (3 + c) * vote_factor, generator=generator)

    def forward(self, seed_xyz, seed_features):
        b, num_seed, _ = seed_xyz.shape
        vf, c = self.vote_factor, self.c
        net = torch.relu(self.bn1(self.conv1(seed_features)))
        net = torch.relu(self.bn2(self.conv2(net)))
        net = self.conv3(net).reshape(b, num_seed, vf, 3 + c)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., 0:3]).reshape(
            b, num_seed * vf, 3)
        vote_features = (seed_features[:, :, None, :] + net[..., 3:]).reshape(
            b, num_seed * vf, c)
        return vote_xyz, vote_features


class ProposalModule(nn.Module):
    """Vote clustering + box/class decoding."""

    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr, num_proposal: int,
                 sampling: str = "vote_fps", seed_feat_dim: int = 256,
                 bn_momentum: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if sampling not in ("vote_fps", "seed_fps", "random"):
            raise ValueError(f"unknown sampling {sampling!r}")
        self.num_class = num_class
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.register_buffer("mean_size_arr", torch.from_numpy(
            np.asarray(mean_size_arr, dtype=np.float32)), persistent=False)
        self.num_proposal = num_proposal
        self.sampling = sampling
        g = generator
        self.vote_aggregation = PointnetSAModuleVotes(
            npoint=num_proposal, radius=0.3, nsample=16, mlp=[128, 128, 128],
            in_channels=seed_feat_dim, use_xyz=True, normalize_xyz=True,
            bn_momentum=bn_momentum, generator=g)
        self.conv1 = Dense(128, 128, bias=False, generator=g)
        self.bn1 = DenseBatchNorm(128, bn_momentum)
        self.conv2 = Dense(128, 128, bias=False, generator=g)
        self.bn2 = DenseBatchNorm(128, bn_momentum)
        out_dim = (2 + 3 + num_heading_bin * 2 + num_size_cluster * 4
                   + num_class)
        self.conv3 = Dense(128, out_dim, generator=g)

    def forward(self, xyz, features, end_points, generator=None):
        """``generator`` draws the ``random`` sampling's indices (a fresh
        seed-0 generator on the input's device when None)."""
        agg = self.vote_aggregation
        if self.sampling == "vote_fps":
            new_xyz, feats, sample_inds = agg(xyz, features)
        else:
            if self.sampling == "seed_fps":
                sample_inds = ops.furthest_point_sample(
                    end_points["seed_xyz"], self.num_proposal)
            else:
                b, num_seed = xyz.shape[0], end_points["seed_xyz"].shape[1]
                if generator is None:
                    generator = torch.Generator(device=xyz.device).manual_seed(0)
                sample_inds = torch.randint(
                    0, num_seed, (b, self.num_proposal), generator=generator,
                    device=xyz.device, dtype=torch.int32)
            new_xyz, feats, _ = agg(xyz, features, inds=sample_inds)
        end_points["aggregated_vote_xyz"] = new_xyz
        end_points["aggregated_vote_inds"] = sample_inds
        net = torch.relu(self.bn1(self.conv1(feats)))
        net = torch.relu(self.bn2(self.conv2(net)))
        return decode_scores(self.conv3(net), end_points, self.num_class,
                             self.num_heading_bin, self.num_size_cluster,
                             self.mean_size_arr)


def decode_scores(net, end_points, num_class, num_heading_bin,
                  num_size_cluster, mean_size_arr):
    """Split the proposal head output [B, num_proposal, D] into its fields."""
    b, num_proposal, _ = net.shape
    nh, ns = num_heading_bin, num_size_cluster
    end_points["objectness_scores"] = net[:, :, 0:2]
    end_points["center"] = end_points["aggregated_vote_xyz"] + net[:, :, 2:5]
    end_points["heading_scores"] = net[:, :, 5:5 + nh]
    hrn = net[:, :, 5 + nh:5 + nh * 2]
    end_points["heading_residuals_normalized"] = hrn
    end_points["heading_residuals"] = hrn * (np.pi / max(nh, 1))
    end_points["size_scores"] = net[:, :, 5 + nh * 2:5 + nh * 2 + ns]
    srn = net[:, :, 5 + nh * 2 + ns:5 + nh * 2 + ns * 4].reshape(
        b, num_proposal, ns, 3)
    end_points["size_residuals_normalized"] = srn
    mean_size = torch.as_tensor(mean_size_arr, dtype=torch.float32,
                                device=net.device)
    end_points["size_residuals"] = srn * mean_size[None, None, :, :]
    end_points["sem_cls_scores"] = net[:, :, 5 + nh * 2 + ns * 4:]
    return end_points
