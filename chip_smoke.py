#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pointcontrast_tpu_torch``) on one
NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --scatter-blocks 1,2,4,8,16
    python3 chip_smoke.py --wgrad-blocks 1,2,4,8
    python3 chip_smoke.py --resnet-bf16-spread 0,1,2,3
    python3 chip_smoke.py --brick-bf16-spread 0,1,2,3
    python3 chip_smoke.py --ddp
    python3 chip_smoke.py --st

The other forms only time scatter_gemm at several SCATTER_BLOCKS, or the
tensor-core gather_wgrad_bf16 at several WGRAD_BLOCKS (``blocks_sweep``);
``--votenet-bf16-spread``, ``--resnet-bf16-spread`` and
``--brick-bf16-spread`` take the summation-order readings that
BF16_VOTENET_LOSS_RTOL, BF16_STEP_LIMITS and BF16_GRAD_LIMITS are set
from; ``--ddp`` runs the build and phase 5g alone, ``--st`` the build and
phase 18a alone.  Phases of the first,
each printed on its own line:
  1. device: requires CUDA; prints ``nvidia-smi`` name and power limit;
  2. build: compiles the sm_90a kernels (csrc/sparse_conv.cu and
     csrc/detect_ops.cu, one nvcc each, in parallel) and the host kernel-map
     library from this checkout's sources; a stack frame or spill in
     parent_gemm, scatter_gemm, FPS, ball query, the brick kernels,
     segment_sum or three_nn fails it;
  2a. fps: one FPS pick's floor by cluster size, on clouds of one point a
     thread (the serial bound of every FPS check);
  the pretraining path:
  3. data: collates the pretraining batches (SyntheticPairDataset, 4 pairs
     per step, PadScheme.scannet(npad0=131072), 4096 NCE pairs, fused
     frames, chunked layout) and moves them to the card, bounds-checked;
  4. kernels: every sparse-conv kernel against its plain-torch twin on the
     card at the shapes of every conv of one real forward (f32, TF32 off),
     with times;
  5. slice: Res16UNet34C (3 -> 32, L2-normalised) -- one step through the
     kernels against the same step through the plain twins from the same
     weights and batch, then 5 SGD steps under PretrainTrainer with finite
     losses and the expected launch count of every kernel;
  5a. ``pretrain voxel`` and ``pretrain brick:2``: the same batches
     collated in the voxel (flat) and brick:2 layouts, bounds-checked,
     every kernel at the shapes of one real forward against its twin (the
     flat K1-K3 at B = 1; brick_gemm, brick_wgrad with the levels' valid
     and slot orders, and the K = 1 gather_sum / scatter_sum of the brick
     levels), the kernels-vs-plain step and 5 counted steps (the voxel
     path's counts must equal the chunked path's: 0 scatter_gemm); on
     brick:2 also ``brick k5 shapes``, the brick kernels with a k = 5
     plan at level 0 (launches 0: no counted path runs it);
  5b. ``pretrain bf16``: the chunked batches through Res16UNet34C in bf16
     (the shipped YAMLs' ``net.dtype``): every bf16 form (gather_gemm_bf16,
     gather_wgrad_bf16, parent_gemm_bf16; K3's dF and dW gather the bf16
     cotangent through the down map) at the shapes of one real bf16
     forward, the Cin = 3 stem's among them, against its bf16 twin to
     BF16_RTOL; the three tensor-core forms (``BOUNDED``;
     parent_gemm_bf16's K2 dF reads the untransposed W) within their
     derived bound of the exact sum of their products (``bound_ratio`` <=
     1, gather_gemm_bf16's twin with its taps reversed a reading:
     ``reversed_spread``), the (bf16, f32) wgrad of K3's parent design bit
     for bit against its f32 kernel on the widened operands
     (``BF16_FORMS``; the tap and offset splits a reading); the
     kernels-vs-plain step (loss to BF16_LOSS_RTOL, the valid output to
     cosine BF16_COS_MIN, its rows' cosines a reading);
     5 counted steps; the L2-normalised bf16 rows to BF16_NORM_TOL;
  5c. ``pretrain voxel bf16``: 5b on the voxel batches, whose K1 and K2
     forwards round each tap (gather_gemm_bf16's ``round_each_tap``, JAX's
     flat ``_conv_core``);
  5d. ``pretrain brick:2 bf16``: 5b on the brick:2 batches: brick_gemm_bf16
     and brick_wgrad_bf16 (the tensor cores) within their bounds of the
     exact sum (``bound_ratio``), bit-equal run to run, each check's device
     ms beside the f32 kernel's at the same shapes (``f32_device_ms``),
     the placement and up gathers' gather_sum_bf16 / scatter_sum_bf16 and
     the flat levels' bf16 forms; the step's loss and output cosine to
     BF16_STEP_LIMITS and its gradients from one forward of the kernels to
     BF16_GRAD_LIMITS (``_bf16_parity``), beside the reversed twins'
     spread; then ``brick k5 shapes bf16`` (launches 0);
  5e. ``pretrain hardest`` and ``pretrain hardest bf16``: the shipped
     trainer (configs/pretrain_default.yaml's HardestContrastiveLossTrainer)
     on the chunked scenes of 3, collated with mode="hardest" (4096
     positives and 1024 hard-negative candidates a frame), bounds-checked;
     the kernels-vs-plain step, whose plain step replays the kernel step's
     hardest negatives (the loss to LOSS_RTOL, in bf16 to BF16_LOSS_RTOL
     with the output's cosine to BF16_COS_MIN), and a ``[picks]`` line of
     readings: how many of the 2 x 4096 picks the plain step's own argmins
     change, its loss from them, and the anchors the collision bitmaps
     drop; STEPS counted PretrainTrainer steps (pos_loss and neg_loss
     printed) whose launches must equal the NCE paths'
     ``expected_launches``.  No kernel checks of their own: the networks
     and shapes are those of 5 and 5b, whose checks these paths' entries
     in the kernels line name (``checks_from``);
  5f. ``cli pretrain``: apps.pretrain.main on configs/pretrain_default.yaml
     as shipped (hardest, bf16, chunked) on synthetic pairs: 3 steps and a
     checkpoint, then a second call to max_iter 5 that resumes from it,
     each call's launches the bf16 model's expected ones a step; the
     logged step_time and data_time of each step, and the host's seconds
     a batch for the samples and for the collation alone;
  5g. ``ddp``: data parallelism (``pointcontrast_tpu_torch/parallel``).
     ``ddp pretrain``: two ranks (``parallel.launch.run``) share cuda:0
     over gloo, named explicitly (NCCL refuses two ranks on one GPU), and
     run the shipped trainer's step under DDP (hardest, chunked,
     Res16UNet34C 3 -> 32, 4 pairs a rank, batch r on rank r) DDP_STEPS
     times in bf16 and in f32: the ranks' parameters bit-equal after every
     step, rank 0's bit-equal after every step to one process that runs
     both batches and steps SGD on g0/2 + g1/2 (bound 0, derived: the
     kernels repeat bit for bit and that sum is DDP's one rounding; a miss
     prints the ops PyTorch names nondeterministic), each rank's launches
     a step the ``pretrain hardest`` paths' (paths ``ddp pretrain bf16``
     and ``ddp pretrain f32`` in the kernels line: both ranks' launches);
     each rank's step ms, which is no scaling figure (two ranks, one
     card).  On two or more cards the same over NCCL, a card a rank;
     else a line says it did not run.  ``ddp cli``: apps.pretrain.main on
     the shipped YAML under ``RANK=0 WORLD_SIZE=1`` (as ``torchrun``
     sets them) over NCCL: 3 steps, rank 0's checkpoint (no ``module.``),
     a resume to 5, launches as in 5f; then the DDP step's ms against the
     unwrapped step's in turns under that world-1 NCCL group;
  the VoteNet detection path (configs/votenet_default.yaml, f32):
  6. data: two batches of 8 synthetic scenes x 40000 points, 2.5 cm voxels,
     npad0 262144 with the YAML's pad ratios, chunked, bounds-checked;
  7. kernels: the sparse-conv kernels at the shapes of every conv of the
     backbone's forward, and FPS, ball query, gather and scatter-add,
     against their twins at the path's shapes from one real batch, with
     times, and the group's scatter-add over a ball query where most balls
     hold 1-2 hits (the heavy tail);
  7a. fps shapes: FPS at the cluster sizes the paths do not take (B = 3,
     a cloud of 4-fold duplicates, 8000 points, 256, 5 -> 16 and the
     shared-memory form past 98304 points);
  8. parity: one VoteNet step through the kernels against the same step
     through the plain twins, from the same weights and batch;
  9. slice: 5 DetectTrainer.train_epoch steps (Res16UNet34C 3 -> 256, Adam)
     with finite losses and the expected launch count of every kernel,
     then one evaluate pass (mAP in [0, 1]) and the shapes and finiteness
     of the eval outputs;
  the VoteNet path over PointNet++ (the same YAML with
  net.backbone=pointnet2: no voxels, no colour, no height):
  10. data: two batches of the same 8 x 40000-point scenes, labels
     bounds-checked;
  11. kernels: every set-abstraction module's FPS, ball query, gathers and
     scatter-adds (SA1-SA4 and the proposal module's vote FPS), three_nn
     (index and distance equal), three_interpolate and its backward at
     FP1's and FP2's shapes, all from one real forward, with times, and the
     votes' group scatter-add over a ball query where most balls hold 1-2
     hits (the heavy tail);
  12. parity: one step through the kernels against the plain twins;
  13. slice: 5 DetectTrainer steps with the expected launch count of every
     kernel (0 for the sparse-conv ones), one evaluate, the eval outputs;
  13a. ``votenet voxel``: the sparse-conv VoteNet on batches collated with
     ``layout="voxel"``: the backbone's kernels at one real forward's
     shapes, K6-K8, the kernels-vs-plain step, 3 counted steps, evaluate;
  13b. ``votenet bf16``: the chunked path with the backbone in bf16 (the
     YAML's): the bf16 forms at its forward's shapes, K6-K8, the
     kernels-vs-plain step (the plain step replays the kernel step's FPS
     and ball-query picks; backbone output and seed features to cosine
     BF16_COS_MIN, the loss to BF16_VOTENET_LOSS_RTOL beside the plain
     twins' own spread under another summation order), 5 counted steps,
     evaluate;
  14. boxnet: one BoxNet step (seed FPS, get_loss_boxnet), vote_loss 0;
  15. cli: apps.votenet.main on 8 synthetic scenes: one epoch (one step),
     one evaluation, a checkpoint, then a second call that resumes from it
     with nothing left to train; with net.backbone=pointnet2, then on the
     shipped sparse-conv backbone with its ``net.dtype: bfloat16``, then
     with ``net.backbone_model=MinkUNetHyper14INBN`` in bf16 (its unpools'
     gather_sum_bf16 / scatter_sum_bf16);
  the semseg finetuning paths (tools/workload.py: the JAX benchmark's 6
  synthetic 2 cm scenes, ~250k voxels, random colours and 20 labels,
  PadScheme.scannet(npad0=262144), 6 chunks, f32; SGD lr 0.1, momentum 0.9,
  wd 1e-4, PolyLR to 60000, BN momentum 0.02):
  16. data: the batch with its CRF map (hypercross, k 3), bounds-checked;
  17. for each path -- ``semseg`` (Res16UNet34C 3 -> 20), ``semseg inbn``
     (ResUNet18INBN: segment_sum and the broadcast gather at every
     InstanceBatchNorm's shapes; then ``segment_sum general``, one check
     of segment_sum's general path, random ids at more than SEG_SMEM
     segments, launches 0) and ``semseg crf`` (BilateralCRF of 10
     mean-field iterations over Res16UNet34C, filter LR 0.1: the flat conv's
     gather_gemm at B = 1, scatter_gemm and gather_wgrad on the real CRF
     map) -- every kernel it launches against its twin at the shapes of one
     real forward, one step through the kernels against the plain twins, 5
     SemsegTrainer steps with the expected launch count of every kernel
     (the CRF's by the trainer's coin), one evaluate_dataset pass (mIoU in
     [0, 100]) and the eval outputs; ``semseg bf16`` is ``semseg`` with the
     net in bf16 (the bf16 forms, the bf16 parity of 5b);
     The fourth path, ``semseg hyper`` (MinkUNetHyper14INBN 3 -> 20 at full
     width), also checks gather_sum and scatter_sum at its three average
     unpools (block5's output from level 2 to 1 and 1 to 0, block6's from
     level 1 to 0); ``semseg crf bf16`` and ``semseg hyper bf16`` are
     ``semseg crf`` and ``semseg hyper`` in bf16: the filter's flat conv
     in the bf16 forms (gather_gemm_bf16 rounding each tap,
     scatter_gemm_bf16 over every tap, gather_wgrad_bf16), the unpools'
     gather_sum_bf16 and scatter_sum_bf16 (through the levels' down maps),
     held to their twins bit for bit, scatter_gemm_bf16 within
     ``scatter_gemm_bf16_bound`` (``bound_ratio``, ``reversed_spread``: the
     f32 twin's taps reversed, ``repeat_spread``: two launches' gap), with
     the bf16 parity of 5b;
  17a. ``semseg voxel`` (Res16UNet34C in the BilateralCRF, flat backbone
     and filter, 5 counted steps), ``semseg brick`` (Res16UNet34C on
     brick:2, 3 counted steps) and ``semseg brick bf16`` (the same in bf16,
     the parity of 5d): the batch in the layout, every kernel at one real
     forward's shapes, kernels-vs-plain step, evaluate_dataset in the
     layout;
  18. cli semseg: apps.semseg.main on SyntheticSemsegDataset
     (net.dtype=float32): 3 steps, whole-split validation, a checkpoint,
     then a second call that resumes with nothing left to train; then the
     same with the shipped ``net.dtype: bfloat16`` (Res16UNet34C, then
     ResUNet18INBN: the ResUNet family in bf16), with
     net.model=MinkUNetHyper14INBN (f32, then the shipped bf16), the
     shipped bf16 with net.wrapper_type=BilateralCRF, with data.layout=voxel,
     with data.layout=brick, and with data.layout=brick on the shipped
     bf16;
  18a. st: the 4-D spatio-temporal nets (``st_paths``) on
     ``tools/workload.st_semseg_batch`` (2 sequences x 3 frames of a
     semseg room drifting ST_SHIFT voxels a frame, ~242k voxels, one flat
     4-D pyramid; the voxels truncation drops printed, under 1% or it
     fails): ``semseg st`` and ``semseg st bf16``, STRes16UNet34 3 -> 20
     (29-tap hybrid K1 in one launch, the (3, 3, 3, 1) stem, 8-child
     strided convs), every kernel at one real forward's shapes, the
     kernels-vs-plain step (the loss to LOSS_RTOL; bf16 as 5b), ST_STEPS
     counted SemsegTrainer steps with their launches, step ms, peak
     memory; ``semseg st tesseract`` (f32 and bf16) and ``semseg st
     resnet``: STResTesseract16UNet18A at one block a stage (81-tap stem
     and blocks: K1 in three groups, the bf16 dF's f32 partials) and
     STResNet14 (the 81-tap k3s2 K4 in three groups), every kernel against
     its twin, in f32 one forward + backward against the plain twins
     (RTOL), one counted forward + backward; ``semseg k5`` and ``semseg
     k5 bf16``: the chunked Res16UNet34C with a k = 5 stem (125 taps: K1
     in four groups; in bf16 the forward's f32 partials rounded once),
     the stem's checks, the kernels-vs-plain step and LAYOUT_STEPS counted
     steps;
  the ResNet paths (tools/workload.py: the semseg scenes through a 6-level
  chunked pyramid with the k3s2 maps, PadScheme.scannet(262144, 6), one
  random label per level-5 voxel):
  19. data: the ResNet batch, bounds-checked (down_nbr3 included);
  20. for ``resnet18`` and ``resnet50`` (ResNet18 / ResNet50 3 -> 20 at the
     published widths): K1 at the stem and the stride-1 blocks, the K4 trio
     (gather_gemm, scatter_gemm, gather_wgrad) at every strided block's k3s2
     and 1-tap downsample shapes and gather_sum / scatter_sum at the sum
     pool, against their twins; one forward + backward with a seeded
     cotangent through the kernels against the plain twins (output and every
     parameter gradient within RTOL of its largest magnitude); the spread
     of the plain twins alone between the same input twice and an input one
     ulp away, with the ReLU gates that flipped (a reading, not a check);
     3 SGD steps with the expected launch count of every kernel; the eval
     logits; ``resnet18 bf16`` and ``resnet50 bf16``: the same nets in bf16
     (K4's gather_gemm_bf16, scatter_gemm_bf16 and gather_wgrad_bf16, the
     sum pool's gather_sum_bf16 and scatter_sum_bf16 against their twins,
     one SGD step through the kernels against the plain twins as the bf16
     parity of 5b, 3 counted steps);
  21. se: SEBasicBlock and SEBottleneck at level 1, 128 channels, kernels
     against plain twins (forward + backward);
  22. probes: gather_sum at the Pallas gather probes' shapes
     (experiments/pallas_gather_probe*.py: K 1 and 27 over a [65536, 32]
     table, K 27 over [65536, 16]), exact against its twin.
Every path prints its peak device memory on its ``slice`` line, and every
path with a transposed conv one ``[k3]`` line (``conv_phase``): the device
ms of K3's backward through the down map (its dF and dW checks) against
its parent design's on the same cotangents in the same call (the scatter
into the stacked [8 S_c, Cout] table, dF and dW on it; checks labelled "K3
parent", still held to their twins, under "<path> K3 parent design" in the
JSON line, with no launches), their ratio and the down maps' live pairs.
Every kernel check also times the one PyTorch call computing the same
function where there is one, and the card's bound for the work (bytes over
3.35 TB/s or operations over the peak of their type, whichever is larger:
67 TFLOP/s f32, 989 TFLOP/s for a bf16 form's bf16 x bf16 products).  The
times are CUDA events over 10 calls (``ms``, ``plain_ms``, ``library_ms``),
and the kernel's and the library call's device-only times (``device_ms``,
``library_device_ms``: the same 10 calls replayed as one CUDA graph, the
median of 5 replays, so the host's cost of a call is left out;
``ms - device_ms`` is that cost).  The gather GEMMs' and scatter_gemm's
checks pass the pad row as ``skip`` and the live orders the step passes
(the pyramid's; none for the CRF's flat map), as the sparse ops do, and
their lines give the live and the computed share of the (row, tap) pairs,
with the order and without it (``unordered_share``); gather_wgrad's lines
whether two launches on one input are bit-equal; parent_gemm's checks
pass the up order and the ``skip`` of their path (K2's dF the forward's
W with ``trans_w``: the f32 form's time holds its transposed copy, as the
step's does) and give the share of rows computed; the brick kernels' lines the live and computed shares of
the (tap, output slot) pairs and the live pairs against the count before
the kernels skipped empty slots; ball_query's lines the points scanned
against a full scan of every cloud (``scanned_share``); segment_sum's
lines its launch shape (``grid`` blocks x channel tiles, ``span`` rows a
block, lane ``group``) and the share of its device time that the last
block's combine takes (``combine_share``: 1 - the device time without the
combine over the device time); the kernels of REPEAT_EXACT must give the
same bits from two launches (segment_sum at up to SEG_SMEM segments);
``[ptxas]`` lines give the gather GEMMs', scatter_gemm's, parent_gemm's
(both forms), the brick kernels', FPS's, ball query's, segment_sum's and
three_nn's registers, stack and spills (any stack or spill fails the build
phase, but for the f32 and SIMT bf16 gather GEMMs'); ``[sass]`` lines the
gather, parent, scatter and brick GEMM instances' HMMA counts (only the
tensor-core forms may, and must, have them).  Then
one JSON line with the per-kernel results: under ``paths``, each main path's
own launches and its checks' times, bounds and errors; at the top level,
the launches of all paths and the numbers of all their checks together.  As
the last line
``{"ok": true, "device": {...}}``.  Any failure raises: non-zero exit, no
result line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
DDP_STEPS = 3  # counted steps of the ddp pretrain path
RESNET_STEPS = 3
LAYOUT_STEPS = 3  # counted steps of the semseg and VoteNet layout paths
ST_STEPS = 3  # counted steps of the 4-D spatio-temporal semseg paths
# kernel vs plain twin, f32 on both sides: |err| <= ATOL + RTOL * max|ref|
# (the sums run in different orders; scatter_gemm adds with unordered f32
# atomics)
RTOL, ATOL = 1e-4, 1e-5
# one step's loss, kernels vs plain twins (55 convs + train-mode BN deep);
# the VoteNet step's backbone output and seed features are held to RTOL
LOSS_RTOL = 1e-4
# one VoteNet step through the kernels vs the plain twins: backbone output,
# seed features and (while every integer output agrees) the loss; with
# flipped argmin/argmax outputs, the loss to LOSS_RTOL_FLIPPED and at most
# MAX_FLIPPED of any integer set differing
LOSS_RTOL_FLIPPED, MAX_FLIPPED = 1e-3, 0.01
# the bf16 forms: a bf16 output against its bf16 twin (both round the same
# f32 sums, added in other orders: at most one bf16 ulp of an element apart,
# <= 2^-7 max|ref|); one bf16 step kernels vs plain twins: the loss to
# BF16_LOSS_RTOL, the valid output's cosine to BF16_COS_MIN (its least row
# cosine a reading: ulp flips of a row that cancels to a small norm); the
# L2-normalised bf16 rows' norms to BF16_NORM_TOL of 1 (the scale and the
# product each rounded to bf16, 2^-9 relative each)
BF16_RTOL = 2.0 ** -7
BF16_LOSS_RTOL = 1e-2
# the bf16 VoteNet step's loss, kernels vs plain twins (FPS picks and ball
# query groups replayed): the heads' objectness thresholds and box
# assignments make it move with f32 summation order alone.  Over seeds 0-3,
# two batches each (``--votenet-bf16-spread 0,1,2,3``; NVIDIA H100 80GB
# HBM3, 700 W), the plain twins with gather_gemm_bf16's tap sums reversed
# moved it by 6.4e-03 to 4.33e-02, the kernels by 6.3e-03 to 3.91e-02: the
# limit is 1.8 times the largest.  Its backbone output and seed features are
# held to BF16_COS_MIN
BF16_VOTENET_LOSS_RTOL = 0.08
# a bf16 library call (embedding_bag's f32 sum rounded once, index_add_'s
# bf16 adds in any order) against the pools' twins, which round each add in
# JAX's order: at most 8 adds (the pools' taps, the unpool's children),
# each rounding off by at most one bf16 ulp of the largest magnitude
BF16_LIBRARY_RTOL = 8 * 2.0 ** -7
BF16_COS_MIN = 0.999
BF16_NORM_TOL = 2.0 ** -7
# a bf16 step, kernels vs plain twins (loss rtol, the output's cosine min)
# on the paths named: 1.8 times the largest gaps (1 - cosine) of the plain
# twins with the bf16 GEMMs' f32 sums in reverse order over seeds 0-3 (NVIDIA
# H100 80GB HBM3, 700 W), as BF16_VOTENET_LOSS_RTOL.  ``--resnet-bf16-spread
# 0,1,2,3``: ResNet18 5.45e-04 and 0.9999090, ResNet50 (305 level-5 rows,
# 50 train-mode BN layers deep: past BF16_COS_MIN) 6.544e-03 and 0.9915437;
# the same run's lower-precision control ("pertap": every gather GEMM's
# taps rounded and added in bf16) falls below both cosines at every seed.
# ``--brick-bf16-spread 0,1,2,3``: pretrain brick:2 6.476e-05 and
# 0.9996272, semseg brick 4.478e-05 and 0.9994607 (the kernels 5.98e-05,
# 0.9995989 and 4.80e-05, 0.9994204)
BF16_STEP_LIMITS = {"resnet18 bf16": (0.000981, 0.999836),
                    "resnet50 bf16": (0.01178, 0.98478),
                    "pretrain brick:2 bf16": (0.0001166, 0.999329),
                    "semseg brick bf16": (0.0000806, 0.999029)}
# the bf16 ResNets' input and parameter gradients from one forward of the
# kernels, kernels vs plain twins (the worst tensor's max error over its
# largest magnitude, the relative L2 distance of all of them): 1.8 times
# the largest of the reversed twins (every bf16 GEMM's f32 sums in another
# order) over seeds 0-3 in the same run: ResNet18 1.866e-02 and 5.482e-03,
# ResNet50 3.221e-02 and 1.708e-02 (the worst tensors: BN biases and
# weights, sums that cancel).  Controls read there: K4's dF without its
# last tap ("drop_tap") 1.06-1.32 and 0.68-0.81, outside both; every dF
# rounded per tap ("pertap_all") 0.024-0.054 and 0.012-0.023, outside
# ResNet18's L2 limit only; K4's dF alone so ("pertap_dF") inside both: a
# rounding rule is held by the kernel checks, not by the step.  The brick
# paths the same way (``--brick-bf16-spread 0,1,2,3``): pretrain brick:2
# 2.714e-02 and 1.433e-02, semseg brick 2.999e-02 and 1.424e-02 (the
# kernels 3.029e-02, 1.460e-02 and 3.539e-02, 1.440e-02; BN weights and
# biases worst)
BF16_GRAD_LIMITS = {"resnet18 bf16": (0.03358, 0.009868),
                    "resnet50 bf16": (0.05797, 0.03075),
                    "pretrain brick:2 bf16": (0.04884, 0.02579),
                    "semseg brick bf16": (0.05398, 0.02564)}
SPARSE_SRC = "pointcontrast_tpu_torch/csrc/sparse_conv.cu"
DETECT_SRC = "pointcontrast_tpu_torch/csrc/detect_ops.cu"
KERNEL_INFO = {  # source, and the JAX op each kernel replaces (XLA programs)
    "gather_gemm": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:376"),
    "gather_wgrad": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:440"),
    "parent_gemm": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:768"),
    "scatter_parent": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:803"),
    "furthest_point_sample": (DETECT_SRC, "pointcontrast_tpu/detect/ops.py:38"),
    "ball_query": (DETECT_SRC, "pointcontrast_tpu/detect/ops.py:64"),
    "gather_rows": (DETECT_SRC, "pointcontrast_tpu/detect/ops.py:59"),
    "scatter_add_rows": (DETECT_SRC, "pointcontrast_tpu/detect/ops.py:112"),
    "three_nn": (DETECT_SRC, "pointcontrast_tpu/detect/ops.py:121"),
    "three_interpolate": (DETECT_SRC, "pointcontrast_tpu/detect/modules.py:116"),
    "three_interpolate_grad": (DETECT_SRC, "pointcontrast_tpu/detect/modules.py:116"),
    "scatter_gemm": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:74"),
    "segment_sum": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:967"),
    # K5's k2s2 pooling ops (and the function of the nine Pallas gather
    # probes, experiments/pallas_gather_probe*.py)
    "gather_sum": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:906"),
    "scatter_sum": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:906"),
    # the brick layout's same-level conv: _brick_core (forward, and dF with
    # W[rev]^T) and _brick_sym_bwd's dW
    "brick_gemm": (SPARSE_SRC, "pointcontrast_tpu/sparse/brick.py:400"),
    "brick_wgrad": (SPARSE_SRC, "pointcontrast_tpu/sparse/brick.py:360"),
    # the bf16 forms (JAX's bf16 mode of the same ops)
    "gather_gemm_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:376"),
    "gather_wgrad_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:440"),
    "parent_gemm_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:768"),
    "scatter_parent_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:803"),
    # K4's dF in bf16 (_conv_chunk_down_fused_bwd; the flat conv's too), the
    # pools in bf16 and their autodiff
    "scatter_gemm_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:578"),
    "gather_sum_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:906"),
    "scatter_sum_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/ops.py:951"),
    # the brick layout's same-level conv in bf16
    "brick_gemm_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/brick.py:400"),
    "brick_wgrad_bf16": (SPARSE_SRC, "pointcontrast_tpu/sparse/brick.py:360"),
}
# the kernels whose ptxas report gets a ``[ptxas]`` line, by source; those of
# PTXAS_NO_SPILL and the tensor-core gather_wgrad instances (bf16, bf16)
# fail the build phase with any stack frame or spill
PTXAS_SPARSE = ("gather_gemm_kernel", "gather_gemm_mma_kernel", "gather_wgrad_kernel",
                "parent_gemm_kernel", "parent_gemm_mma_kernel", "brick_gemm_kernel",
                "brick_gemm_mma_kernel", "brick_wgrad_kernel", "brick_wgrad_mma",
                "scatter_gemm_kernel", "scatter_gemm_mma_kernel", "segment_sum_kernel")
PTXAS_DETECT = ("fps_kernel", "ball_query_kernel", "three_nn_kernel")
PTXAS_NO_SPILL = ("gather_gemm_mma_kernel", "parent_gemm_kernel", "parent_gemm_mma_kernel",
                  "fps_kernel", "brick_gemm_kernel", "brick_gemm_mma_kernel",
                  "brick_wgrad_kernel", "brick_wgrad_mma", "scatter_gemm_kernel",
                  "scatter_gemm_mma_kernel",
                  "ball_query_kernel", "segment_sum_kernel", "three_nn_kernel")
# FPS: one pick's floor in ms by cluster size (``fps_pick_floor``), over
# the picks of its clouds of one point a thread
PICK_FLOOR_MS = {}
FPS_FLOOR_PICKS = 512
# kernels whose two launches on one input must give the same bits (no
# atomics: every output written once, in a fixed order of operations, or
# partial sums added in a fixed order); segment_sum at up to SEG_SMEM
# segments (its general path adds with f32 atomics)
REPEAT_EXACT = ("parent_gemm", "furthest_point_sample", "brick_gemm", "brick_wgrad",
                "ball_query", "segment_sum", "three_nn", "parent_gemm_bf16",
                "brick_gemm_bf16", "brick_wgrad_bf16")
# segment_sum's general-path check: random ids at this many segments (past
# SEG_SMEM), over rows of the widest InstanceBatchNorm level's shape
SEG_GENERAL = (40, 262144, 64)
# the Pallas gather probes' shapes (experiments/pallas_gather_probe*.py):
# (taps K, table rows N, channels C, gathered rows M)
PROBES = {"probe 1 (4 kernels) K1 C32": (1, 65536, 32, 65536),
          "probes 2, 3 (4 kernels) K27 C32": (27, 65536, 32, 65536),
          "probe 4 K27 C16": (27, 65536, 16, 65536)}
# MinkUNetHyper's average unpools: block5's output from level 2 (two), block6's
# from level 1 (one)
HYPER_UNPOOLS = 3
# the H100 SXM's published peaks: HBM bytes/s, f32 FLOP/s outside the
# tensor cores (the f32 kernels' products), and the bf16 tensor cores'
# dense FLOP/s (the bound of a bf16 x bf16 product with f32 sums:
# gather_gemm_bf16, parent_gemm_bf16 and the (bf16, bf16) gather_wgrad_bf16
# run mma.sync)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# times a check has only where one PyTorch call computes the same function:
# that call's events time and device-only time (``_device_ms``)
OPTIONAL_MS = ("library_ms", "library_device_ms")
# kernels held to their twins bit for bit in every phase: scatter_parent
# stores each kept row once (the pad slot left out, as its twin does); the
# pools' bf16 forms round every add in JAX's order, with no atomics
ALWAYS_EXACT = ("scatter_parent", "scatter_parent_bf16", "gather_sum_bf16",
                "scatter_sum_bf16")
# the bf16 forms that run their f32 instances' tiles and FMA order on
# operands widened exactly: each equals its f32 kernel on the widened
# operands, bit for bit; gather_wgrad_bf16 with an f32 G (the dW of K3's
# parent design, on its f32 dy) and scatter_parent_bf16 (a row store)
BF16_FORMS = ("gather_wgrad_bf16", "scatter_parent_bf16")
# the tensor-core forms (gather_wgrad_bf16 with a bf16 G): their sums run
# in the mma's order, so each output is held to the exact (f64) sum of its
# products within the bound derived in sparse/kernels.py
# (``gather_gemm_bf16_bound``: one bf16 rounding, or one a tap under
# ``round_each_tap``, plus gamma(n) of the sum of |products| for the f32
# adds; ``parent_gemm_bf16_bound`` the same at one offset a row),
# ``bound_ratio`` <= 1
BOUNDED = {"gather_gemm_bf16": "gather_gemm_bf16_bound",
           "parent_gemm_bf16": "parent_gemm_bf16_bound",
           "gather_wgrad_bf16": "gather_wgrad_bf16_bound",
           "scatter_gemm_bf16": "scatter_gemm_bf16_bound",
           "brick_gemm_bf16": "brick_gemm_bf16_bound",
           "brick_wgrad_bf16": "brick_wgrad_bf16_bound"}
# radii tried, largest first, for the heavy-tail scatter-add check: the
# first at which HEAVY_TAIL_SHARE of the balls hold 1 or 2 hits, so ball
# query's repeats of the first hit fill most of the group's rows
HEAVY_TAIL_RADII = (0.3, 0.2, 0.15, 0.1, 0.05, 0.02)
HEAVY_TAIL_SHARE = 0.75


def say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


def phase_build():
    from pointcontrast_tpu_torch import cuda_build
    from pointcontrast_tpu_torch.sparse import native

    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    info = cuda_build.build()
    wall = time.perf_counter() - t0
    for name, r in info.items():
        for line in r["ptxas"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)
    spilled = []
    for src, entries in (("sparse_conv", PTXAS_SPARSE), ("detect_ops", PTXAS_DETECT)):
        for entry, regs, stack, spills in ptxas_entries(info[src]["ptxas"]):
            if entry.startswith(entries):
                say("ptxas", kernel=entry, registers=regs, stack_bytes=stack,
                    spill_bytes=spills)
                if (entry.startswith(PTXAS_NO_SPILL) or entry.endswith("bf16,bf16>")) and (
                        stack or spills):
                    spilled.append(entry)
    if spilled:
        raise AssertionError(f"stack or spills in {spilled}")
    sass_mma_check(cuda_build.library_path("sparse_conv"),
                   os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump"))
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("native kernel-map library failed to build")
    say("build", nvcc_wall_s=f"{wall:.1f}",
        nvcc_s={n: round(r["seconds"], 1) for n, r in info.items()},
        gxx_s=f"{time.perf_counter() - t0:.1f}")


def sass_mma_check(library, cuobjdump):
    """The tensor-core forms' machine code: one ``[sass]`` line a gather,
    scatter, parent or brick GEMM instance with its count of HMMA
    instructions (``cuobjdump -sass``: mma.sync's instruction); fails
    unless every gather_gemm_mma_kernel, parent_gemm_mma_kernel,
    scatter_gemm_mma_kernel, brick_gemm_mma_kernel, (bf16, bf16)
    gather_wgrad_kernel and brick_wgrad_mma_kernel /
    brick_wgrad_mma_dense_kernel (the bf16 dW's pair and brick forms)
    instance issues them and no other instance (the f32 brick_wgrad_kernel
    among them) does."""
    import re

    text = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = entry_name(m.group(1))
            counts[entry] = 0
        elif entry is not None and "HMMA" in line:
            counts[entry] += 1
    wrong = []
    for entry, n in sorted(counts.items()):
        if not entry.startswith(("gather_gemm", "gather_wgrad", "parent_gemm", "scatter_gemm",
                                 "brick_gemm", "brick_wgrad")):
            continue
        tensor_cores = (entry.startswith(("gather_gemm_mma", "parent_gemm_mma",
                                          "scatter_gemm_mma", "brick_gemm_mma",
                                          "brick_wgrad_mma"))
                        or entry.endswith("bf16,bf16>"))
        say("sass", kernel=entry, hmma=n)
        if (n > 0) != tensor_cores:
            wrong.append(entry)
    if wrong:
        raise AssertionError(f"HMMA where it should not be, or missing: {wrong}")


def entry_name(mangled: str) -> str:
    """``gather_gemm_kernel<2>`` from a kernel's mangled name (Itanium-
    mangled int and bool template arguments, ``segment_sum_kernel<32,1>``);
    the name as it is where it is not a kernel's."""
    import re

    name = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E|f|\d+__nv_bfloat16|S\d*_)+E)?",
                     mangled)
    return mangled if name is None else name.group(1) + template_args(name.group(2) or "")


def ptxas_entries(text):
    """[(entry, registers, stack bytes, spill store + load bytes)] from
    ``nvcc -Xptxas -v`` output, entries named by ``entry_name``."""
    import re

    out, entry, stack, spills = [], None, 0, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = entry_name(m.group(1))
            stack = spills = 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack, spills = int(m.group(1)), int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1)), stack, spills))
            entry = None
    return out


def template_args(mangled: str) -> str:
    """``<2>``, ``<32,1>`` or ``<1,1,bf16,f32>`` from a mangled template
    argument list (``ILi2EE``, ``ILi32ELb1EfE``; a repeated bf16 is the
    substitution ``S0_``, ``ILi1ELi1E13__nv_bfloat16S0_E``): int and bool
    values, and the element types (f, __nv_bfloat16) only where one of them
    is bf16, so that an f32 instance keeps the name it had before the bf16
    forms."""
    import re

    args = re.findall(r"L[ib](\d+)E|(f)|\d+(__nv_bfloat16)|(S\d*_)", mangled)
    typed = any(bf or sub for _, _, bf, sub in args)
    names = [v if v else ("bf16" if bf or sub else "f32") for v, f, bf, sub in args
             if v or typed]
    return "<" + ",".join(names) + ">" if names else ""


def make_batches(device, **kw):
    from pointcontrast_tpu_torch.tools.workload import pretrain_batches

    t0 = time.perf_counter()
    dev = pretrain_batches(device, **kw)
    lv = dev[0].pyramid0.levels
    nb = dev[0].pyramid0.num_batch
    say("data", layout=kw.get("layout", "chunked"),
        seconds=f"{time.perf_counter() - t0:.1f}", samples=nb,
        rows=[int(l.valid.shape[0]) for l in lv],
        valid_rows=[int(l.valid.sum()) for l in lv],
        truncated=[float(b.truncated_voxels) for b in dev],
        **({"pairs": [int(b.pair_valid.sum()) for b in dev]} if kw.get("mode") != "hardest"
           else {"positives": [int(b.pos_valid.sum()) for b in dev],
                 "candidates": [[int(b.cand0_valid.sum()), int(b.cand1_valid.sum())]
                                for b in dev]}))
    return dev


def _masked_randn(shape, valid, gen):
    import torch

    x = torch.randn(shape, device=valid.device, generator=gen)
    return x * valid.reshape(shape[0], shape[1], 1)


def _time_ms(fn, args, iters=10):
    import torch

    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, args, iters=10, replays=5):
    """The device's own time for one call of ``fn``: ``iters`` calls
    captured in one CUDA graph, each replay timed with CUDA events, the
    median of ``replays`` over ``iters``.  Unlike ``_time_ms`` it leaves out
    the host's cost of each call, which the events measure whenever the
    device finishes a call before the host has issued the next; the device
    is kept busy while the host enqueues a replay, so the events open on
    work, not on a wait.  (``torch.profiler``, the first choice, dropped
    most kernels of some 10-call traces on the card, and all of one.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the allocator warms up off the capture
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    busy = torch.empty(64 * 2 ** 20, device="cuda")  # 256 MB: ~80 us to fill
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        busy.fill_(1.0)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph, busy
    return statistics.median(times)


def _nbytes(*ts) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _live_rows(x3):
    """[B, S] bool: rows of a [B, S, C] table with a non-zero entry."""
    return (x3 != 0).any(-1)


def _map_bytes(map_, n, b_, s_out) -> int:
    return 0 if map_ is None else 4 * n * b_ * s_out


def work(name, args, out) -> tuple:
    """(bytes, f32 operations) the function needs on these inputs: each
    input read once and each output written once; data-dependent work
    counted on this data (the conv products whose source rows are non-zero,
    ball query's scan up to its last needed hit)."""
    import torch

    from pointcontrast_tpu_torch.sparse.kernels import row_index

    outs = out if isinstance(out, tuple) else (out,)
    name = name.removesuffix("_bf16")  # a bf16 form: the same work, its own bytes
    if name == "gather_gemm":
        x3, map_, taps, stride, w, wc, s_out = args[:7]
        b_, _, cin = x3.shape
        live = _live_rows(x3)
        pairs = sum(int(torch.gather(live, 1, row_index(map_, taps, stride, j, b_, s_out,
                                                        x3.device)).sum())
                    for j in range(w.shape[0]))
        pairs += int(live[:, :s_out].sum()) if wc is not None else 0
        return (_nbytes(x3, w, wc, *outs) + _map_bytes(map_, w.shape[0], b_, s_out),
                2 * cin * w.shape[2] * pairs)
    if name == "gather_wgrad":
        a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride, k, s_rows = args[:10]
        b_ = a3.shape[0]
        la, lg = _live_rows(a3), _live_rows(g3)
        pairs = 0
        for j in range(k):
            ia = row_index(a_map, a_taps, a_stride, j, b_, s_rows, a3.device)
            ig = row_index(g_map, g_taps, g_stride, j, b_, s_rows, a3.device)
            pairs += int((torch.gather(la, 1, ia) & torch.gather(lg, 1, ig)).sum())
        return (_nbytes(a3, g3, *outs) + _map_bytes(a_map, k, b_, s_rows)
                + _map_bytes(g_map, k, b_, s_rows), 2 * a3.shape[2] * g3.shape[2] * pairs)
    if name == "parent_gemm":
        x3, parent, off, w = args[:4]
        pairs = int(torch.gather(_live_rows(x3), 1, parent.long()).sum())
        return _nbytes(x3, parent, off, w, *outs), 2 * w.shape[1] * w.shape[2] * pairs
    if name == "scatter_parent":
        # only the cotangent rows whose parent is not the coarse pad row
        ct3, parent, off, _, s_c = args
        kept = int((parent < s_c - 1).sum())
        return (ct3.element_size() * ct3.shape[2] * kept + _nbytes(parent, off, *outs),
                kept * ct3.shape[2])
    if name == "furthest_point_sample":
        xyz, npoint = args
        # per step and point: 3 subtractions, a multiply and two FMAs, a min
        # and a compare
        return _nbytes(xyz, *outs), 9 * (npoint - 1) * xyz.shape[0] * xyz.shape[1]
    if name == "ball_query":
        # per (centre, point) pair scanned: a.b (a multiply and two FMAs),
        # an add, a multiply, a subtract, a max and a compare; |a|^2 and
        # |b|^2 (a multiply and two FMAs) once per centre and per point
        centres, xyz = args[0], args[1]
        once = 5 * xyz.shape[0] * (centres.shape[1] + xyz.shape[1])
        return _nbytes(centres, xyz, *outs), 10 * ball_scanned(args, outs[0]) + once
    if name == "gather_rows":
        table, idx = args
        b_, n, c = table.shape
        rows = (idx.reshape(b_, -1).long()
                + n * torch.arange(b_, device=idx.device)[:, None]).unique().numel()
        return 4 * rows * c + _nbytes(idx, *outs), 0
    if name == "scatter_add_rows":
        grad, idx, _ = args
        return _nbytes(grad, idx, *outs), grad.numel()
    if name == "three_nn":
        unknown, known = args
        b_, n, _ = unknown.shape
        # per pair: a.k (a multiply and two FMAs), an add, a multiply, a
        # subtract, a max and up to three compares
        return _nbytes(unknown, known, *outs), 13 * b_ * n * known.shape[1]
    if name == "three_interpolate":
        feats, idx, weight = args
        return _nbytes(feats, idx, weight, *outs), 5 * outs[0].numel()
    if name == "three_interpolate_grad":
        grad, idx, weight, _ = args
        return _nbytes(grad, idx, weight, *outs), 6 * grad.numel()
    if name == "scatter_gemm":
        g3, map_, taps, w, _, skip = args[:6]
        live = _live_rows(g3)
        pairs = sum(int((live & (map_[int(t)] != skip)).sum()) for t in taps)
        return (_nbytes(g3, w, *outs) + _map_bytes(map_, len(taps), *g3.shape[:2]),
                2 * w.shape[1] * w.shape[2] * pairs)
    if name == "segment_sum":
        x, seg, n_seg = args
        return _nbytes(x, seg, *outs), int(((seg >= 0) & (seg < n_seg)).sum()) * x.shape[1]
    if name == "gather_sum":
        x3, map_, taps, stride, s_out = args[:5]
        b_, s_in, c = x3.shape
        rows = _flat_rows(map_, taps, stride, b_, s_out, s_in, x3.device)
        return (x3.element_size() * c * rows.unique().numel() + 4 * rows.numel()
                + _nbytes(*outs), rows.numel() * c)
    if name == "scatter_sum":
        # the function's bytes: the bf16 form's inverse (the unpool's down
        # map), which only tells its kernel where the sources are, is left out
        g3, map_, taps, stride, s_in, skip_from = args[:6]
        b_, s_g, c = g3.shape
        rows = _flat_rows(map_, taps, stride, b_, s_g, s_in, g3.device)
        kept = _scatter_kept(rows, s_in, skip_from)
        # the cotangent rows with a destination kept, every index, the output
        needed = int(kept.any(0).sum())
        return (g3.element_size() * c * needed + 4 * rows.numel() + _nbytes(*outs),
                int(kept.sum()) * c)
    if name in ("brick_gemm", "brick_wgrad"):
        # the (tap, output slot) pairs whose output slot is occupied and
        # whose source row is non-zero and occupied (brick_wgrad: whose
        # cotangent row is non-zero too)
        live = _brick_pairs(name, args)[0]
        w_ct = args[3]
        cout = w_ct.shape[2] if name == "brick_gemm" else w_ct.shape[1]
        extra = args[4:6] if name == "brick_gemm" else args[5:7]
        return (_nbytes(args[0], args[1], w_ct, *extra, *outs),
                2 * args[0].shape[1] * cout * int(live.sum()))
    raise KeyError(name)


def _bf16_operands(args) -> bool:
    """Whether every floating operand of a check is bf16: its tables,
    weights and cotangents (the brick kernels' ``valid``, an f32 [NB*8]
    mask, is not multiplied)."""
    import torch

    return all(a.dtype == torch.bfloat16 for a in args
               if torch.is_tensor(a) and a.is_floating_point() and a.dim() > 1)


def flop_peak(name, args) -> float:
    """The peak the operations of a check are held to: a bf16 form whose
    floating operands are all bf16, the bf16 tensor cores'; any f32
    operand (the f32 kernels, and the dW of K3's parent design against its
    f32 dy, which bf16 tensor cores cannot take exactly), the f32 SIMT
    peak."""
    if name.endswith("_bf16") and _bf16_operands(args):
        return BF16_FLOP_PER_S
    return F32_FLOP_PER_S


def ball_scanned(args, out) -> int:
    """The points a ball query must scan on these inputs: each centre's
    cloud up to its nsample-th hit, the whole cloud where it has fewer."""
    import torch

    xyz, nsample = args[1], args[3]
    full = (out[..., -1] != out[..., 0] if nsample > 1
            else torch.ones_like(out[..., 0], dtype=torch.bool))
    return int(torch.where(full, out[..., -1].long() + 1,
                           torch.full_like(out[..., 0], xyz.shape[1]).long()).sum())


def _flat_rows(map_, taps, stride, b_, s_rows, s_table, dev):
    """[K, B * s_rows] int64 rows of a [B * s_table] table that the listed
    taps read (frame-local rows offset by their chunk)."""
    import torch

    from pointcontrast_tpu_torch.sparse.kernels import row_index

    base = s_table * torch.arange(b_, device=dev)[:, None]
    return torch.stack([(row_index(map_, taps, stride, j, b_, s_rows, dev) + base)
                        .reshape(-1) for j in range(len(taps))])


def _scatter_kept(rows, s_in, skip_from):
    """Which entries of ``_flat_rows`` scatter_sum adds: those whose
    frame-local row lies below ``skip_from`` (all of them when it is < 0)."""
    import torch

    if skip_from < 0:
        return torch.ones_like(rows, dtype=torch.bool)
    return rows % s_in < skip_from


def _brick_pairs(name, args):
    """([taps, NB * 8] bool masks over the (tap, output slot) pairs of a
    brick kernel's check, and the check's order): ``live``, what ``work``
    counts (output slot occupied, source row non-zero and occupied; for
    brick_wgrad the cotangent row non-zero too); ``kept``, the pairs whose
    output and source slots are occupied (what the kernels compute on);
    ``before``, the pairs whose source row is non-zero, whatever the output
    slot (the count before the kernels skipped empty slots)."""
    import torch

    from pointcontrast_tpu_torch.sparse.kernels import BRICK_SLOTS, _slot_table_on

    x, nbr, steps, w_ct = args[:4]
    taps, valid, order = (w_ct.shape[0], *args[4:6]) if name == "brick_gemm" else args[4:7]
    table, centre = _slot_table_on(steps, taps, x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    b, ds = rows // BRICK_SLOTS, table.long()[:, rows % BRICK_SLOTS]  # [taps, R]
    d = ds // BRICK_SLOTS
    src = torch.where(d == centre, b, nbr.long()[d, b]) * BRICK_SLOTS + ds % BRICK_SLOTS
    occ = valid != 0
    before = (x != 0).any(1)[src]
    kept = occ[src] & occ[None]
    live = kept & before
    if name == "brick_wgrad":
        live &= (w_ct != 0).any(1)[None]
    return live, kept, before, order


def gather_shares(name, args) -> dict:
    """For gather_gemm and gather_wgrad: ``live``, the share of all (row,
    tap) pairs whose source rows are non-zero (what ``work`` counts), and
    ``computed``, the share of the pairs the kernel computes: gather_gemm
    every row of a 16-row fragment (in its 128-row tile of the row order it
    is given, the pyramid's live order) with a row that is not ``skip`` at
    that tap, and ``unordered`` the same in the rows' own order;
    scatter_gemm the same shares of its (cotangent row, tap) pairs whose
    destination is kept, computed as each 128-row tile's kept rows a tap
    rounded up to 16;
    gather_wgrad the pairs whose rows are not their ``skip``; parent_gemm
    (its rows are (fine row, offset) pairs) the rows whose parent row is
    non-zero (``live``) and, ``computed``, 16 rows for every offset that a
    16-row fragment of its 128-row tiles of the up order holds among the
    rows whose parent is not ``skip`` (``unordered``: in the rows' own
    order).  brick_gemm and brick_wgrad (their pairs are (tap, output
    slot)): ``live`` as ``work`` counts them (``_brick_pairs``), ``before``
    the pairs ``work`` counted before the kernels skipped empty slots
    (every output slot of a non-zero source) and ``computed``: brick_gemm
    16 rows for every (tap, 16-row fragment of its 128-row tiles of the
    slot order) with an occupied pair (``unordered``: in the rows' own
    order), brick_wgrad its compacted pairs.  None for other kernels."""
    import torch

    from pointcontrast_tpu_torch.sparse.kernels import GEMM_ROWS, row_index

    name = name.removesuffix("_bf16")
    if name == "gather_gemm":
        x3, map_, taps, stride, w, wc, s_out, skip = args[:8]
        order = args[8] if len(args) > 8 else None
        b_ = x3.shape[0]
        dev = x3.device
        idx = [row_index(map_, taps, stride, j, b_, s_out, dev) for j in range(w.shape[0])]
        if wc is not None:
            idx.append(torch.arange(s_out, device=dev).expand(b_, s_out))
        idx = torch.stack(idx)  # [T, B, s_out]
        nz = _live_rows(x3)
        live = torch.stack([torch.gather(nz, 1, i) for i in idx])
        kept = idx != skip

        def computed(k):
            frag = torch.nn.functional.pad(k, (0, -s_out % GEMM_ROWS))
            return 16 * int(frag.reshape(*k.shape[:2], -1, 16).any(-1).sum()) / k.numel()

        ordered = kept
        if order is not None:
            ordered = torch.gather(kept, 2, order.long().expand_as(kept))
        return {"live": float(live.float().mean()), "computed": computed(ordered),
                "unordered": computed(kept)}
    if name == "scatter_gemm":
        # the kernel compacts each (128-row tile, tap)'s kept rows and
        # computes them rounded up to 16
        g3, map_, taps, w, s_in, skip = args[:6]
        order = args[6] if len(args) > 6 else None
        s_out = g3.shape[1]
        idx = torch.stack([map_[int(t)] for t in taps])  # [T, B, s_out]
        kept = (idx != skip) & (idx >= 0) & (idx < s_in)
        live = kept & _live_rows(g3)[None]

        def computed(k):
            tile = torch.nn.functional.pad(k, (0, -s_out % GEMM_ROWS))
            n = tile.reshape(*k.shape[:2], -1, GEMM_ROWS).sum(-1)
            return 16 * int(((n + 15) // 16).sum()) / k.numel()

        ordered = kept
        if order is not None:
            ordered = torch.gather(kept, 2, order.long().expand_as(kept))
        return {"live": float(live.float().mean()), "computed": computed(ordered),
                "unordered": computed(kept)}
    if name == "gather_wgrad":
        a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride, k, s_rows, sk_a, sk_g = args
        b_, dev = a3.shape[0], a3.device
        la, lg = _live_rows(a3), _live_rows(g3)
        live = kept = 0
        for j in range(k):
            ia = row_index(a_map, a_taps, a_stride, j, b_, s_rows, dev)
            ig = row_index(g_map, g_taps, g_stride, j, b_, s_rows, dev)
            live += int((torch.gather(la, 1, ia) & torch.gather(lg, 1, ig)).sum())
            kept += int(((ia != sk_a) & (ig != sk_g)).sum())
        return {"live": live / (k * b_ * s_rows), "computed": kept / (k * b_ * s_rows)}
    if name == "parent_gemm":
        x3, parent, off, _, skip, order = args[:6]
        b_, s_f = parent.shape
        live = torch.gather(_live_rows(x3), 1, parent.long())
        offs = torch.where(parent != skip, off.long(), 8)  # 8: no offset

        def computed(o):
            o = torch.nn.functional.pad(o, (0, -s_f % GEMM_ROWS), value=8)
            hot = torch.nn.functional.one_hot(o.reshape(b_, -1, 16), 9)[..., :8]
            return 16 * int(hot.any(2).sum()) / (b_ * s_f)

        ordered = offs if order is None else torch.gather(offs, 1, order.long())
        return {"live": float(live.float().mean()), "computed": computed(ordered),
                "unordered": computed(offs)}
    if name in ("brick_gemm", "brick_wgrad"):
        live, kept, before, order = _brick_pairs(name, args)
        out = {"live": float(live.float().mean()), "before": float(before.float().mean()),
               "live_pairs": int(live.sum()), "before_pairs": int(before.sum())}
        if name == "brick_wgrad":
            return {**out, "computed": float(kept.float().mean())}

        def computed(k):
            frag = torch.nn.functional.pad(k, (0, -k.shape[1] % GEMM_ROWS))
            return 16 * int(frag.reshape(k.shape[0], -1, 16).any(-1).sum()) / k.numel()

        ordered = kept if order is None else kept[:, order.long()]
        return {**out, "computed": computed(ordered), "unordered": computed(kept)}
    return None


def library_call(name, args):
    """One PyTorch call that computes the same function on the same inputs,
    as a closure (its operands built beforehand), or None where there is
    none: a row gather (``torch.gather``), a scatter-add (``scatter_add_``),
    a segment sum (``index_add_``), the gather-sum (``embedding_bag`` in sum
    mode, ``index_select`` at one tap) and its adjoint (``index_add_``; the
    bf16 forms', the same calls in bf16), the
    interpolation and its backward as
    one sparse product (``torch.sparse.mm`` with the [B*N, B*M] weight matrix
    in CSR).  The convs (scatter_gemm too) are a gather or scatter and a
    matmul, FPS, ball query and three_nn a loop or a sort after a distance
    matrix: two calls or more."""
    import torch

    if name == "gather_rows":
        table, idx = args
        flat = idx.reshape(idx.shape[0], -1, 1).long().expand(-1, -1, table.shape[2])
        return lambda: torch.gather(table, 1, flat)
    if name == "scatter_add_rows":
        grad, idx, n = args
        rows = idx.reshape(idx.shape[0], -1).long()
        g = grad.reshape(rows.shape[0], rows.shape[1], -1)
        flat = rows.unsqueeze(-1).expand(-1, -1, g.shape[2])
        buf = g.new_zeros(g.shape[0], n, g.shape[2])
        return lambda: buf.zero_().scatter_add_(1, flat, g)
    if name == "scatter_parent":
        # only the rows the function adds (the pad slot left out), as for
        # scatter_sum: the others would make the call pay for contention
        grad, parent, off, k, s_c = args
        kept = parent < s_c - 1
        rows = (off.long() * s_c + parent.long() + k * s_c
                * torch.arange(parent.shape[0], device=parent.device)[:, None])[kept]
        src = grad[kept]
        flat = rows.unsqueeze(-1).expand(-1, src.shape[1])
        buf = grad.new_zeros(parent.shape[0] * k * s_c, grad.shape[2])
        return lambda: buf.zero_().scatter_add_(0, flat, src)
    if name == "segment_sum":
        x, seg, n_seg = args
        rows = seg.long()
        buf = x.new_zeros(n_seg, x.shape[1])
        return lambda: buf.zero_().index_add_(0, rows, x)
    if name in ("gather_sum", "gather_sum_bf16") and args[1] is not None:
        x3, map_, taps, stride, s_out = args[:5]
        b_, s_in, c = x3.shape
        table = x3.reshape(b_ * s_in, c)
        rows = _flat_rows(map_, taps, stride, b_, s_out, s_in, x3.device)
        if len(taps) == 1:
            return lambda: torch.index_select(table, 0, rows[0])
        bags = rows.t().contiguous()  # [B * s_out, K]: one bag per output row
        return lambda: torch.nn.functional.embedding_bag(bags, table, mode="sum")
    if name in ("scatter_sum", "scatter_sum_bf16") and args[1] is not None:
        g3, map_, taps, stride, s_in, skip_from = args[:6]
        b_, s_g, c = g3.shape
        rows = _flat_rows(map_, taps, stride, b_, s_g, s_in, g3.device)
        # only the entries the function adds: a skipped entry sent to a spare
        # row would make index_add_ pay for contention the function has not
        kept = _scatter_kept(rows, s_in, skip_from)
        src = g3.reshape(1, b_ * s_g, c).expand(len(taps), -1, -1)[kept]
        rows = rows[kept]
        buf = g3.new_zeros(b_ * s_in, c)
        return lambda: buf.zero_().index_add_(0, rows, src)
    if name in ("three_interpolate", "three_interpolate_grad"):
        src, idx, weight = args[:3]
        b_, n = idx.shape[:2]
        m = src.shape[1] if name == "three_interpolate" else args[3]
        cols = (idx.long() + m * torch.arange(b_, device=idx.device)[:, None, None]).reshape(-1)
        rows = torch.arange(b_ * n, device=idx.device).repeat_interleave(3)
        if name == "three_interpolate":
            mat = torch.sparse_coo_tensor(torch.stack([rows, cols]), weight.reshape(-1),
                                          (b_ * n, b_ * m)).coalesce().to_sparse_csr()
            dense = src.reshape(b_ * m, -1)
        else:
            mat = torch.sparse_coo_tensor(torch.stack([cols, rows]), weight.reshape(-1),
                                          (b_ * m, b_ * n)).coalesce().to_sparse_csr()
            dense = src.reshape(b_ * n, -1)
        return lambda: torch.sparse.mm(mat, dense)
    return None


def _max_err(got, want) -> tuple:
    """(max abs error, max abs reference) over a result or a tuple of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    ref = max(float(w.double().abs().max()) for w in want)
    return err, ref


def _widened(a):
    """A bf16 tensor widened (exactly) to f32; anything else as it is."""
    import torch

    return a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a


def _unchecked_scatter_sum(g3, map_, taps, stride, s_in, skip_from, inverse=None):
    """scatter_sum_bf16's kernel without the check of its map: the launch
    alone, for the check's cost."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K

    return K._scatter_sum_launch("scatter_sum_bf16", g3, map_, taps, stride, s_in, skip_from,
                                 torch.bfloat16, inverse)[0]


def bf16_splits(module, name, args):
    """The blocks over which a gather_gemm_bf16 or parent_gemm_bf16 call
    spreads a tile's taps or offsets (f32 partials, one rounding of their
    sum); None for the other kernels."""
    if name == "gather_gemm_bf16":
        x3, _, _, _, w, wc, s_out = args[:7]
        tile = module._gemm_tile_n_bf16(w.shape[2], bool(args[9]) if len(args) > 9 else False)
        return module._gemm_splits(x3.shape[0], s_out, w.shape[2],
                                   w.shape[0] + (wc is not None), tile)
    if name == "parent_gemm_bf16":
        x3, parent, _, w = args[:4]
        cout = w.shape[1] if len(args) > 6 and args[6] else w.shape[2]  # trans_w
        return module._parent_splits(x3.shape[0], parent.shape[1], cout,
                                     module._gemm_tile_n_bf16(cout, False))
    return None


def _equal(got, want) -> bool:
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


def add_numbers(into: dict, name: str, r: dict) -> None:
    """Add one check's (or one path's) numbers for kernel ``name`` into
    ``into``: times and bounds summed, the larger error kept, each of
    ``OPTIONAL_MS`` None unless every part has one."""
    q = into.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0,
                               "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                               "bound_ms": 0.0, **dict.fromkeys(OPTIONAL_MS, 0.0)})
    q["max_abs_err"] = max(q["max_abs_err"], r["max_abs_err"])
    for k in ("ms", "device_ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms"):
        q[k] += r[k]
    for k in OPTIONAL_MS:
        q[k] = None if q[k] is None or r[k] is None else q[k] + r[k]


def phase_kernels(checks, module, exact=(), by_label=None):
    """Each check's kernel vs its plain twin; kernels named in ``exact`` must
    equal it bit for bit, the others agree to ATOL + RTOL * max|ref|.  Also
    times the one PyTorch call computing the same function, where there is
    one, and the card's bound for the work, and the device-only time of
    the kernel and of the call (``_device_ms``: ``ms`` minus ``device_ms``
    is what the host adds).  For gather_gemm and gather_wgrad it prints the
    live and computed shares of the (row, tap) pairs (``gather_shares``;
    parent_gemm's rows) and, for gather_wgrad, whether two launches on one
    input are bit-equal (a reading, not a check; for the kernels of
    REPEAT_EXACT a check).  FPS's lines add the cluster size and the
    serial bound: npoint - 1 picks at the measured floor of one pick
    (``fps_pick_floor``).
    Returns {kernel:
    {max_abs_err, ms, device_ms, plain_ms, bound_ms, bytes_ms, ops_ms,
    library_ms, library_device_ms}} summed over the kernel's checked
    shapes (``add_numbers``); ``by_label``, a dict, also gets each check's
    own numbers under its label."""
    import torch

    results = {}
    failures = []
    for name, label, fn, args in checks:
        plain = getattr(module, name + "_plain")
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        plain_ms = _time_ms(plain, args)
        ms = _time_ms(fn, args)
        err, ref = _max_err(got, want)
        bitwise = name in exact or name in ALWAYS_EXACT
        outs = got if isinstance(got, tuple) else (got,)
        # an f32 sum of bf16-rounded taps (the per-tap form's f32 partials):
        # a tap whose f32 sum sits at a rounding boundary moves by one bf16
        # ulp of itself, as in a bf16 output
        per_tap_f32 = name == "gather_gemm_bf16" and len(args) > 10 and args[9] and args[10]
        rtol = (BF16_RTOL if per_tap_f32 or any(g.dtype == torch.bfloat16 for g in outs)
                else RTOL)
        if bitwise:
            ok = _equal(got, want)
        else:
            ok = all(bool(torch.isfinite(g).all()) for g in outs) and err <= ATOL + rtol * ref
        nbytes, ops = work(name, args, got)
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / flop_peak(name, args)
        call = library_call(name, args)
        lib_ms = lib_dev_ms = None
        if call is not None:
            lib_err, _ = _max_err(call().reshape(want.shape), want)
            if lib_err > ATOL + (BF16_LIBRARY_RTOL if rtol == BF16_RTOL else RTOL) * ref:
                raise AssertionError(f"{label}: the library call disagrees ({lib_err:.3e})")
            lib_ms = _time_ms(call, ())
            lib_dev_ms = _device_ms(call, ())
        dev_ms = _device_ms(fn, args)
        extra = {}
        if name == "scatter_sum_bf16":  # device_ms holds the kernel's check of its map
            extra["unchecked_device_ms"] = f"{_device_ms(_unchecked_scatter_sum, args):.4f}"
        shares = gather_shares(name, args)
        if shares is not None:
            extra = {"live_share": f"{shares['live']:.3f}",
                     "computed_share": f"{shares['computed']:.3f}"}
            if "unordered" in shares:
                extra["unordered_share"] = f"{shares['unordered']:.3f}"
            if "before" in shares:
                extra.update(before_share=f"{shares['before']:.3f}",
                             live_pairs=shares["live_pairs"],
                             before_pairs=shares["before_pairs"])
        if name == "ball_query":  # against a full scan of every cloud
            full_scan = args[0].shape[0] * args[0].shape[1] * args[1].shape[1]
            extra["scanned_share"] = f"{ball_scanned(args, got) / full_scan:.3f}"
        if name == "segment_sum":
            plan = module.segment_sum_plan(args[0])
            extra.update(grid=f"{plan['blocks']}x{plan['tiles']}", span=plan["span"],
                         group=plan["group"])
            if args[2] <= module.SEG_SMEM:
                parts_ms = _device_ms(module._segment_sum_launch, (*args, False))
                extra["combine_share"] = f"{1 - parts_ms / dev_ms:.3f}"
        if name in ("gather_wgrad", "gather_wgrad_bf16", "gather_gemm_bf16", "scatter_gemm_bf16",
                    *REPEAT_EXACT):
            first, again = fn(*args), fn(*args)
            extra["repeat_bit_equal"] = _equal(first, again)
            if name == "scatter_gemm_bf16":  # f32 atomics: a reading, no claim
                extra["repeat_spread"] = f"{_max_err(first, again)[0]:.3e}"
            required = name in REPEAT_EXACT and not (  # the general path's atomics
                name == "segment_sum" and args[2] > module.SEG_SMEM)
            ok = ok and (extra["repeat_bit_equal"] or not required)
        if name in BOUNDED and _bf16_operands(args):  # the tensor-core forms
            ratio = module.bound_ratio(got, *getattr(module, BOUNDED[name])(*args))
            extra["bound_ratio"] = f"{ratio:.3e}"
            ok = ok and ratio <= 1.0
            if name in REVERSED:  # the twin's own spread under another order
                extra["reversed_spread"] = f"{_max_err(REVERSED[name](*args), want)[0]:.3e}"
            if name.startswith("brick"):  # the f32 kernel at the same shapes, in this call
                f32 = getattr(module, name.removesuffix("_bf16"))
                extra["f32_device_ms"] = f"{_device_ms(f32, tuple(map(_widened, args))):.4f}"
        elif name in BF16_FORMS:
            f32 = getattr(module, name.removesuffix("_bf16"))(*map(_widened, args))
            extra["f32_instance_bit_equal"] = _equal(got, f32.to(got.dtype))
            ok = ok and extra["f32_instance_bit_equal"]
        splits = bf16_splits(module, name, args)
        if splits is not None:
            extra["splits"] = splits
        if name == "furthest_point_sample":
            xyz, npoint = args
            extra["cluster"] = fps_cluster_of(xyz)
            if PICK_FLOOR_MS:
                extra["serial_bound_ms"] = f"{(npoint - 1) * min(PICK_FLOOR_MS.values()):.4f}"
        numbers = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms), "library_ms": lib_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
        add_numbers(results, name, numbers)
        if by_label is not None:
            by_label[label] = numbers
        shape = tuple(tuple(g.shape) for g in got) if isinstance(got, tuple) else tuple(got.shape)
        say("kernel", name=name, check=repr(label), shape=shape,
            max_abs_err=f"{err:.3e}", max_abs_ref=f"{ref:.3e}",
            rel=f"{err / max(ref, 1e-30):.2e}", exact=bitwise,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
            device_ms=f"{dev_ms:.4f}",
            library_device_ms="null" if lib_dev_ms is None else f"{lib_dev_ms:.4f}",
            bound_ms=f"{max(bytes_ms, ops_ms):.4f}",
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            share_of_bound=f"{max(bytes_ms, ops_ms) / ms:.3f}", **extra, ok=ok)
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"kernels disagree with their plain twins: {failures}")
    return results


def expected_launches(model) -> dict:
    """Sparse-kernel launches of one training step, from the model's conv
    layout: K1 fwd + dF (not for the stem, whose input needs no gradient) +
    dW; K2 fwd + dF + dW; K3 fwd + dF + dW (both gathered through the down
    map); K4 (a ResNet strided block's k3s2 conv, its 1-tap downsample
    and, BasicBlock-shaped, its second conv, to which JAX passes no
    ``rev``) fwd + scatter_gemm dF + dW;
    the ResNets' k2s2 sum pool and each of MinkUNetHyper's average unpools
    a gather_sum and its scatter_sum; no flat conv and no global pooling.
    A bf16 model (``model.dtype``) runs every one of them through its bf16
    form; no path launches scatter_parent (K3's parent design)."""
    import torch

    from pointcontrast_tpu_torch.nn.layers import SparseConv, SparseConvTranspose
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.nn.resnet import ResNetBase, _StridedBlock
    from pointcontrast_tpu_torch.nn.resunet import MinkUNetHyper

    k4 = set()
    for b in model.modules():
        if isinstance(b, _StridedBlock):
            k4 |= {b.conv2, b.downsample_conv} | (set() if b.bottleneck else {b.conv1})
    convs = [m for m in model.modules() if isinstance(m, SparseConv) and m not in k4]
    n_same = sum(1 for m in convs if m.weight.shape[0] == 27)
    n_down = sum(1 for m in convs if m.weight.shape[0] == 8)
    n_tr = sum(1 for m in model.modules() if isinstance(m, SparseConvTranspose))
    pools = (isinstance(model, ResNetBase)
             + HYPER_UNPOOLS * isinstance(model, MinkUNetHyper))
    n = dict.fromkeys((fn.__name__ for fn in K.KERNELS), 0)
    net = getattr(model, "net", model)  # a CRF wrapper's backbone
    sfx = "_bf16" if getattr(net, "dtype", None) == torch.bfloat16 else ""
    n.update({
        f"gather_gemm{sfx}": n_same + (n_same - 1) + n_down + n_tr + len(k4),
        f"gather_wgrad{sfx}": n_same + n_down + n_tr + len(k4),
        f"parent_gemm{sfx}": n_tr + n_down,
        f"scatter_gemm{sfx}": len(k4),
        f"gather_sum{sfx}": pools,
        f"scatter_sum{sfx}": pools,
    })
    return n


def _agreement(a, b) -> dict:
    """How two [N, C] outputs agree, in f64: ``cosine``, the cosine of the
    two whole outputs (the bf16 parity's check), and, as readings, the
    least row cosine and the share of rows below BF16_COS_MIN."""
    a, b = a.double(), b.double()  # the whole output's sums: past f32's reach
    na, nb = a.norm(dim=1), b.norm(dim=1)
    live = (na > 0) | (nb > 0)
    a, b, na, nb = a[live], b[live], na[live], nb[live]
    rows = (a * b).sum(1) / (na * nb).clamp(min=1e-30)
    return {"cosine": float((a * b).sum() / (a.norm() * b.norm()).clamp(min=1e-30)),
            "row_min": float(rows.min()),
            "rows_below": float((rows < BF16_COS_MIN).float().mean())}


def _reversed_gemm(x3, map_, taps, tap_stride, w, wc, s_out, skip=-1, order=None,
                   round_each_tap=False, f32_out=False):
    """gather_gemm_bf16's function with f32 sums, its taps added in reverse
    order (the centre first): the roundings of another f32 sum than the
    kernel's and the exact twin's (``_forward_agreement``'s spread, and
    each bf16 gemm check's ``reversed_spread``)."""
    import torch

    from pointcontrast_tpu_torch.sparse.kernels import row_index, take_rows

    b_ = x3.shape[0]

    def product(rows, wj):
        p = rows.float() @ wj.float()
        return p.to(x3.dtype).float() if round_each_tap else p

    out = x3.new_zeros(b_, s_out, w.shape[-1], dtype=torch.float32)
    if wc is not None:
        xc = x3[:, :s_out]
        if 0 <= skip < s_out:
            xc = torch.where((torch.arange(s_out, device=x3.device) != skip)[:, None], xc, 0.0)
        out = out + product(xc, wc)
    for j in reversed(range(w.shape[0])):
        idx = row_index(map_, taps, tap_stride, j, b_, s_out, x3.device)
        rows = torch.where((idx != skip)[..., None], take_rows(x3, idx), 0.0)
        out = out + product(rows, w[j])
    return out if f32_out else out.to(x3.dtype)


def _reversed_scatter(g3, map_, taps, w, s_in, skip, order=None):
    """scatter_gemm_bf16's function with f32 sums, its taps added in
    reverse order, rounded once: the spread of another f32 order than the
    kernel's and the exact twin's (each bf16 scatter check's
    ``reversed_spread``)."""
    from pointcontrast_tpu_torch.sparse.kernels import scatter_gemm_plain

    taps = list(taps)[::-1]
    return scatter_gemm_plain(g3.float(), map_, taps, w.float().flip(0), s_in,
                              skip).to(g3.dtype)


def _reversed_brick_gemm(x, nbr, steps, w, valid=None, order=None):
    """brick_gemm_bf16's function with f32 sums, the plan's steps added in
    reverse order, rounded once (each bf16 brick check's
    ``reversed_spread``, and the "reversed" mode)."""
    from pointcontrast_tpu_torch.sparse.kernels import brick_gemm_plain

    return brick_gemm_plain(x.float(), nbr, steps[::-1], w.float(), valid).to(x.dtype)


def _reversed_brick_wgrad(x, nbr, steps, ct, num_taps, valid=None, order=None):
    """brick_wgrad_bf16's function the same way: f32 sums over the steps
    in reverse order, rounded once."""
    from pointcontrast_tpu_torch.sparse.kernels import brick_wgrad_plain

    return brick_wgrad_plain(x.float(), nbr, steps[::-1], ct.float(), num_taps,
                             valid).to(x.dtype)


# the bf16 checks' summation-order readings (``reversed_spread``)
REVERSED = {"gather_gemm_bf16": _reversed_gemm, "scatter_gemm_bf16": _reversed_scatter,
            "brick_gemm_bf16": _reversed_brick_gemm, "brick_wgrad_bf16": _reversed_brick_wgrad}


def _pertap_gemm(x3, map_, taps, tap_stride, w, wc, s_out, skip=-1, order=None,
                 round_each_tap=False, f32_out=False):
    """A control for the bf16 forward's checks, lower in precision than
    gather_gemm_bf16: each tap's product rounded to bf16 and the taps added
    in bf16 (the centre first), every add rounded."""
    import torch

    from pointcontrast_tpu_torch.sparse.kernels import row_index, take_rows

    b_ = x3.shape[0]
    out = x3.new_zeros(b_, s_out, w.shape[-1])
    if wc is not None:
        xc = x3[:, :s_out]
        if 0 <= skip < s_out:
            xc = torch.where((torch.arange(s_out, device=x3.device) != skip)[:, None], xc, 0.0)
        out = out + (xc.float() @ wc.float()).to(x3.dtype)
    for j in range(w.shape[0]):
        idx = row_index(map_, taps, tap_stride, j, b_, s_out, x3.device)
        rows = torch.where((idx != skip)[..., None], take_rows(x3, idx), 0.0)
        out = out + (rows.float() @ w[j].float()).to(x3.dtype)
    return out.float() if f32_out else out


def _pertap_scatter(g3, map_, taps, w, s_in, skip, order=None):
    """A control for the bf16 gradients' check: scatter_gemm_bf16's dF with
    each tap's scatter rounded to bf16 and the taps' tables added in bf16
    (the flat K4's autodiff rule, applied where JAX rounds once)."""
    from pointcontrast_tpu_torch.sparse.kernels import scatter_gemm_plain

    out = None
    for j, t in enumerate(taps):
        part = scatter_gemm_plain(g3.float(), map_, [t], w[j:j + 1].float(), s_in,
                                  skip).to(g3.dtype)
        out = part if out is None else out + part
    return out


def _drop_tap_scatter(g3, map_, taps, w, s_in, skip, order=None):
    """A wrong scatter_gemm_bf16 (a control): K4's dF with its last tap
    left out."""
    from pointcontrast_tpu_torch.sparse.kernels import scatter_gemm_bf16_plain

    return scatter_gemm_bf16_plain(g3, map_, list(taps)[:-1], w[:-1], s_in, skip)


def _exact_wgrad(a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride, k, s_rows,
                 skip_a=-1, skip_g=-1):
    """gather_wgrad_bf16's function with f64 sums rounded to f32: another
    order than the kernel's and the twin's f32 sums."""
    from pointcontrast_tpu_torch.sparse.kernels import gather_wgrad_plain

    return gather_wgrad_plain(a3.double(), a_map, a_taps, a_stride, g3.double(), g_map,
                              g_taps, g_stride, k, s_rows, skip_a, skip_g).float()


# what each mode of a bf16 comparison swaps into sparse.ops under the plain
# twins ("kernels" runs the kernels): "reversed", the plain twins in other
# f32 summation orders (the spread of summation order alone); the controls,
# which the limits set from that spread are read against: "pertap", a
# lower-precision forward (every gather GEMM's taps rounded and added in
# bf16), "pertap_dF" K4's dF rounded per tap, "pertap_all" every conv's dF
# so, "drop_tap" K4's dF without its last tap (wrong)
MODE_SWAPS = {
    "kernels": {}, "plain": {},
    "reversed": {**REVERSED, "gather_wgrad_bf16": _exact_wgrad},
    "pertap": {"gather_gemm_bf16": _pertap_gemm},
    "pertap_dF": {"scatter_gemm_bf16": _pertap_scatter},
    "pertap_all": {"gather_gemm_bf16": _pertap_gemm, "scatter_gemm_bf16": _pertap_scatter},
    "drop_tap": {"scatter_gemm_bf16": _drop_tap_scatter},
}


@contextlib.contextmanager
def _mode(mode):
    """Run the block in one of MODE_SWAPS' modes."""
    from pointcontrast_tpu_torch.sparse import kernels, ops
    from pointcontrast_tpu_torch.tools.workload import plain_ops

    # sparse.ops imported its wrappers by name; sparse.brick calls the brick
    # wrappers through the kernels module
    home = {name: ops if hasattr(ops, name) else kernels for name in MODE_SWAPS[mode]}
    with plain_ops() if mode != "kernels" else contextlib.nullcontext():
        saved = {name: getattr(home[name], name) for name in MODE_SWAPS[mode]}
        try:
            for name, fn in MODE_SWAPS[mode].items():
                setattr(home[name], name, fn)
            yield
        finally:
            for name, fn in saved.items():
                setattr(home[name], name, fn)


def _mode_outputs(model, run, device, modes=("plain", "kernels", "reversed")) -> dict:
    """{mode: a train-mode forward ``run(m)`` of a copy of ``model``, f32}
    in each of ``modes`` (MODE_SWAPS): through the kernels ("kernels"), the
    plain twins ("plain") and the plain twins with gather_gemm_bf16's taps
    summed in reverse order ("reversed": another f32 summation order than
    both).  No grad."""
    import torch

    outs = {}
    for mode in modes:
        m = copy.deepcopy(model).to(device).train()
        with torch.no_grad(), _mode(mode):
            outs[mode] = run(m).float()
        del m
    return outs


def _forward_agreement(model, run, valid, device) -> tuple:
    """(``_agreement`` over the ``valid`` rows of ``_mode_outputs``' kernels
    forward against the plain twins', and the same for the reversed one:
    the spread that f32 summation order alone gives the bf16 net, a
    reading).  The bf16 paths' parity."""
    outs = _mode_outputs(model, run, device)
    return (_agreement(outs["kernels"][valid], outs["plain"][valid]),
            _agreement(outs["reversed"][valid], outs["plain"][valid]))


def _check_step_parity(app, losses, agree=None, rtol=None, cos_min=BF16_COS_MIN):
    """One step's loss through the kernels against the plain twins': f32
    paths to LOSS_RTOL; bf16 paths (``agree``: their forward's
    ``_forward_agreement``) to BF16_LOSS_RTOL (or ``rtol``), the output's
    cosine to ``cos_min``, the rows and the summation-order spread as
    readings."""
    rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    rtol = rtol or (LOSS_RTOL if agree is None else BF16_LOSS_RTOL)
    extra = {}
    if agree is not None:
        for tag, a in zip(("", "spread_"), agree):
            extra.update({
                f"{tag}cosine": f"{a['cosine']:.7f}",
                f"{tag}row_cosine_min": f"{a['row_min']:.6f}",
                f"{tag}rows_below_cos_min": f"{a['rows_below']:.2e}"})
        extra["cos_min"] = cos_min
    say("parity", app=app, loss_kernels=f"{losses['kernels']:.8f}",
        loss_plain=f"{losses['plain']:.8f}", rel=f"{rel:.2e}", rtol=rtol, **extra)
    if not (rel <= rtol) or (agree is not None and not agree[0]["cosine"] >= cos_min):
        raise AssertionError(f"{app}: the kernel step differs from the plain step")


def _bf16_parity(app, losses, model, run, x, ct, valid, device):
    """A bf16 path's parity: one step's loss through the kernels against
    the plain twins' and the forward's cosine (``_check_step_parity`` at
    BF16_STEP_LIMITS[app], else BF16_LOSS_RTOL and BF16_COS_MIN, beside the
    reversed twins' spread); for the paths of BF16_GRAD_LIMITS also the
    input and parameter gradients from one forward ``run(m, x)`` of the
    kernels, backpropagated from ``ct`` through the kernels and through the
    plain twins: the worst tensor's error over its largest magnitude and
    the relative L2 distance of all of them within their limits, beside
    the reversed twins' spread."""
    rtol, cos_min = BF16_STEP_LIMITS.get(app, (BF16_LOSS_RTOL, BF16_COS_MIN))
    _check_step_parity(app, losses, _forward_agreement(model, lambda m: run(m, x), valid,
                                                       device), rtol=rtol, cos_min=cos_min)
    if app not in BF16_GRAD_LIMITS:
        return
    got = _kernels_vs_plain(model, x, ct, run, device, modes=("kernels", "plain", "reversed"))
    worst_rtol, l2_rtol = BF16_GRAD_LIMITS[app]
    spread, _ = _worst_gap(got, "reversed", skip=("output",))
    l2, l2_spread = (_l2_gap(got, mode, skip=("output",)) for mode in ("kernels", "reversed"))
    worst = _compare_runs(app, got, rtol=worst_rtol, skip=("output",))
    say("parity", app=app, gradients=len(got["plain"]) - 1, worst_rel=f"{worst:.3e}",
        spread_worst_rel=f"{spread:.3e}", rtol=worst_rtol, l2_rel=f"{l2:.3e}",
        spread_l2_rel=f"{l2_spread:.3e}", l2_rtol=l2_rtol)
    if not l2 <= l2_rtol:
        raise AssertionError(f"{app}: the kernels' gradients differ from the plain twins' "
                             f"by {l2:.3e} (L2) > {l2_rtol}")


def _hardest_picks(app, losses, hardest, batch):
    """The ``[picks]`` line of a hardest path's parity (readings, not
    limits): of the 2 x P hardest negatives (anchor -> frame-1 candidate,
    positive -> frame-0 candidate), how many the plain step's own argmins
    pick differently from the kernel step's, with the plain step's loss
    from its own picks beside the replayed one; and how many valid anchors
    the collision bitmaps drop from each negative term."""
    from pointcontrast_tpu_torch.losses.contrastive import _packed_bit

    def dropped(picks):
        return [int(((batch.pos_valid > 0) & _packed_bit(bits, i)).sum())
                for bits, i in zip((batch.collide0, batch.collide1), picks)]

    own, kern = hardest["plain unreplayed"], hardest["kernels"]
    flips = sum(int((a != b).sum()) for a, b in zip(own, kern))
    say("picks", app=app, picks=sum(a.numel() for a in kern), unreplayed_flips=flips,
        dropped_kernels=dropped(kern), dropped_plain_unreplayed=dropped(own),
        loss_plain_unreplayed=f"{losses['plain unreplayed']:.8f}",
        rel_unreplayed=f"{abs(losses['plain unreplayed'] / losses['kernels'] - 1):.2e}")


def phase_slice(batches, device, card, app, expect, dtype=None, mode="nce"):
    """A pretraining main path: one step through the kernels against the
    plain twins, then STEPS PretrainTrainer steps with ``expect`` launches
    of every kernel a step, and the output; ``dtype``: the model's
    activations (bf16: the step's parity also holds the forward's output to
    cosine BF16_COS_MIN); ``mode``: the loss ('hardest': the plain step
    replays the kernel step's hardest negatives, ``_hardest_picks``)."""
    import torch

    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools.workload import (
        PAIRS,
        plain_ops,
        pretrain_model,
    )
    from pointcontrast_tpu_torch.train import (
        PretrainConfig,
        PretrainTrainer,
        make_train_step,
    )
    from pointcontrast_tpu_torch.train import optim

    model = pretrain_model(seed=0, dtype=dtype)
    bf16 = dtype == torch.bfloat16
    n_params = sum(p.numel() for p in model.parameters())
    say("model", app=app, name="Res16UNet34C" + (" bf16" if bf16 else ""),
        params=n_params, per_step=expect)
    cfg = PretrainConfig(mode=mode, lr=0.1, stat_freq=1, save_freq=10 ** 9,
                         checkpoint_dir=os.path.join(BUILD_DIR, "smoke_ckpt"))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)

    # one step through the kernels vs the plain twins, same weights + batch
    # (hardest: the plain step takes the kernel step's hardest negatives)
    losses, hardest = {}, {}
    for run in ("kernels", "plain") + (("plain unreplayed",) if mode == "hardest" else ()):
        m = copy.deepcopy(model).to(device)
        opt = optim.make_optimizer(m, cfg)
        sched = optim.make_scheduler(opt, cfg)
        step = make_train_step(cfg)
        replay = hardest.get("kernels") if run == "plain" else None
        with plain_ops() if run.startswith("plain") else contextlib.nullcontext():
            metrics = step(m, opt, sched, batches[0], hardest=replay,
                           return_hardest=mode == "hardest")
        losses[run] = float(metrics["loss"])
        if mode == "hardest":
            hardest[run] = metrics["hardest"]
        del m, opt, sched
    if mode == "hardest":
        _hardest_picks(app, losses, hardest, batches[0])
    b0 = batches[0]
    if bf16:
        valid0 = b0.pyramid0.levels[0].valid
        gen = torch.Generator(device=device).manual_seed(6)
        ct = torch.randn(valid0.shape[0], 32, device=device, generator=gen) * valid0[:, None]
        _bf16_parity(app, losses, model, lambda m, x: m(x, b0.pyramid0), b0.feats0, ct,
                     valid0 > 0, device)
    else:
        _check_step_parity(app, losses)

    # the main path: PretrainTrainer, STEPS steps, counted launches
    trainer = PretrainTrainer(model, itertools.cycle(batches), cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    history = trainer.train(STEPS)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_list = [m["loss"] for _, m in history]
    step_ms = [1e3 * m["step_time"] for _, m in history]
    for i, (_, m) in enumerate(history):
        terms = {k: f"{m[k]:.6f}" for k in ("pos_loss", "neg_loss") if k in m}
        say("step", app=app, iter=i + 1, loss=f"{m['loss']:.6f}", **terms, lr=m["lr"],
            step_ms=f"{1e3 * m['step_time']:.1f}")
    if mode == "hardest" and not all(math.isfinite(m[k]) for _, m in history
                                     for k in ("pos_loss", "neg_loss")):
        raise AssertionError(f"{app}: non-finite loss terms")
    if len(loss_list) != STEPS or not all(map(math.isfinite, loss_list)):
        raise AssertionError(f"{app}: non-finite or missing losses: {loss_list}")
    want = {k: v * STEPS for k, v in expect.items()}
    if counts != want:
        raise AssertionError(f"{app}: launch counts {counts} != expected {want}")
    steady = statistics.median(step_ms[1:])
    say("slice", app=app, steps=STEPS, launches=counts, ms_per_step=f"{steady:.1f}",
        pairs_per_s=f"{PAIRS / (steady / 1e3):.2f}",
        first_step_ms=f"{step_ms[0]:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
        card=repr(card))

    # what comes out: finite L2-normalised rows, zero pad rows
    trainer.model.eval()
    with torch.no_grad():
        out = trainer.model(batches[0].feats0, batches[0].pyramid0)
    valid = batches[0].pyramid0.levels[0].valid > 0
    norms = out.norm(dim=1)
    if out.shape != (batches[0].feats0.shape[0], 32) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)}")
    if (float((norms[valid] - 1).abs().max()) > (BF16_NORM_TOL if bf16 else 1e-4)
            or bool(out[~valid].any())):
        raise AssertionError(f"{app}: output rows are not unit-norm / pad rows not zero")
    say("output", app=app, shape=tuple(out.shape), dtype=out.dtype,
        valid_rows=int(valid.sum()))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    return counts


def make_votenet_batches(device, layout):
    from pointcontrast_tpu_torch.tools.workload import votenet_batches

    t0 = time.perf_counter()
    dev = votenet_batches(device, layout=layout)
    pyr = dev[0].voxel_pyramid
    say("data", app="votenet", layout=layout, seconds=f"{time.perf_counter() - t0:.1f}",
        scenes=int(dev[0].point_clouds.shape[0]), points=int(dev[0].point_clouds.shape[1]),
        rows=[int(l.valid.shape[0]) for l in pyr.levels],
        valid_rows=[[int(l.valid.sum()) for l in b.voxel_pyramid.levels]
                    for b in dev])
    return dev


def heavy_tail_check(label, centres, xyz, nsample, c, gen):
    """A scatter-add check (kernel, label, fn, args) over a ball query of
    ``centres`` in ``xyz`` at the first of ``HEAVY_TAIL_RADII`` where
    ``HEAVY_TAIL_SHARE`` of the balls hold 1 or 2 hits: each ball's slots
    past its hits repeat its first hit, so most of the [B, M, nsample]
    rows name the same table row as their neighbours.  A random [.., c]
    cotangent.  Raises if no radius gets there."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D

    for r in HEAVY_TAIL_RADII:
        group = D.ball_query_plain(centres, xyz, r, nsample)
        hits = 1 + (group[..., 1:] != group[..., :1]).sum(-1)
        share = float((hits <= 2).float().mean())
        if share >= HEAVY_TAIL_SHARE:
            grad = torch.randn(*group.shape, c, device=xyz.device, generator=gen)
            return ("scatter_add_rows",
                    f"{label} heavy tail r{r} ({share:.2f} of balls 1-2 hits)",
                    D.scatter_add_rows, (grad, group, xyz.shape[1]))
    raise AssertionError(f"{label}: no radius of {HEAVY_TAIL_RADII} leaves "
                         f"{HEAVY_TAIL_SHARE} of the balls with 1-2 hits")


def detect_kernel_checks(batch):
    """[(kernel, label, fn, args)] for K6-K8 at the VoteNet step's shapes,
    from one real batch: the backbone's FPS over the 40000-point clouds and
    its seed gathers, then the proposal module's FPS, ball query (r 0.3,
    16 samples) and [xyz, feature] group over a 1024-vote cloud (the seeds
    moved by offsets of the voting module's scale), with the backward
    scatter-adds of the gathers that carry a gradient, and the group's
    scatter-add once more over a ball query at a radius where most balls
    hold 1-2 hits (``heavy_tail_check``)."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D

    dev = batch.point_clouds.device
    gen = torch.Generator(device=dev).manual_seed(1)
    xyz = batch.point_clouds[..., 0:3].contiguous()
    b_ = xyz.shape[0]
    n_rows = batch.voxel_feats.shape[0]
    seeds = D.furthest_point_sample_plain(xyz, 1024)
    seed_xyz = D.gather_rows_plain(xyz, seeds)
    votes = seed_xyz + 0.05 * torch.randn(seed_xyz.shape, device=dev, generator=gen)
    props = D.furthest_point_sample_plain(votes, 256)
    centres = D.gather_rows_plain(votes, props)
    group = D.ball_query_plain(centres, votes, 0.3, 16)
    rows = torch.gather(batch.point_voxel_idx, 1, seeds.long()).reshape(1, -1)
    vout = torch.randn(1, n_rows, 256, device=dev, generator=gen)
    table = torch.randn(b_, 1024, 259, device=dev, generator=gen)
    return [
        ("furthest_point_sample", f"K6 FPS points {xyz.shape[1]}->1024",
         D.furthest_point_sample, (xyz, 1024)),
        ("furthest_point_sample", "K6 FPS votes 1024->256",
         D.furthest_point_sample, (votes, 256)),
        ("ball_query", "K7 256 centres over 1024 votes r0.3 ns16",
         D.ball_query, (centres, votes, 0.3, 16)),
        ("gather_rows", "K8 seed xyz", D.gather_rows, (xyz, seeds)),
        ("gather_rows", "K8 seed features 256", D.gather_rows, (vout, rows)),
        ("gather_rows", "K8 proposal centres", D.gather_rows, (votes, props)),
        ("gather_rows", "K8 group [xyz, features] 259", D.gather_rows,
         (table, group)),
        ("scatter_add_rows", "K8 bwd seed features 256", D.scatter_add_rows,
         (torch.randn(1, b_ * 1024, 256, device=dev, generator=gen), rows,
          n_rows)),
        ("scatter_add_rows", "K8 bwd proposal centres", D.scatter_add_rows,
         (torch.randn(b_, 256, 3, device=dev, generator=gen), props, 1024)),
        ("scatter_add_rows", "K8 bwd group 259", D.scatter_add_rows,
         (torch.randn(b_, 256, 16, 259, device=dev, generator=gen), group,
          1024)),
        heavy_tail_check("K8 bwd group 259", centres, votes, 16, 259, gen),
    ]


def fps_cluster_of(xyz) -> int:
    """The cluster size furthest_point_sample takes for ``xyz``."""
    from pointcontrast_tpu_torch.detect import kernels as D

    b_, n, _ = xyz.shape
    return D.fps_cluster(b_, n, xyz.get_device())


def fps_pick_floor(device) -> None:
    """One FPS pick's floor on the card, by cluster size cs: the device
    time of FPS_FLOOR_PICKS picks over 8 clouds of cs x 1024 points (one
    point a thread: cs CTAs of 1024 threads), over the picks less one, into
    PICK_FLOOR_MS.  The least of them times npoint - 1 is each FPS check's
    serial bound: the picks are serial, and none can take less."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D

    gen = torch.Generator(device=device).manual_seed(5)
    for cs in (1, 2, 4, 8, 16):
        xyz = torch.rand(8, cs * 1024, 3, device=device, generator=gen)
        if fps_cluster_of(xyz) != cs:
            continue  # not a size the wrapper takes for this cloud on this card
        got = D.furthest_point_sample(xyz, FPS_FLOOR_PICKS)
        if not torch.equal(got, D.furthest_point_sample_plain(xyz, FPS_FLOOR_PICKS)):
            raise AssertionError(f"FPS pick floor: cluster {cs} disagrees with its twin")
        ms = _device_ms(D.furthest_point_sample, (xyz, FPS_FLOOR_PICKS))
        PICK_FLOOR_MS[cs] = ms / (FPS_FLOOR_PICKS - 1)
    say("fps", pick_floor_us={cs: f"{1e3 * v:.3f}" for cs, v in PICK_FLOOR_MS.items()},
        picks=FPS_FLOOR_PICKS, clouds=8, points="cs x 1024")


def fps_checks(clouds):
    """[(kernel, label, fn, args)] of FPS at shapes beside the main paths',
    so that every cluster size the wrapper takes is checked: 3 of the
    VoteNet clouds (B = 3, 40000 -> 1024), 8 clouds of 10000 points each
    present 4 times (ties everywhere), 8 x 8000 -> 512, 8 x 256 -> 256,
    2 x 5 -> 16 (npoint > N: the rest index 0), and 2 x 100000 -> 64, past
    what the registers hold (the shared-memory form)."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D

    dev = clouds.device
    gen = torch.Generator(device=dev).manual_seed(6)
    distinct = torch.rand(8, 10000, 3, device=dev, generator=gen) * 6.0
    dup = distinct.repeat(1, 4, 1)[:, torch.randperm(40000, device=dev, generator=gen)]

    def cloud(b_, n, scale=6.0):
        return torch.rand(b_, n, 3, device=dev, generator=gen) * scale

    shapes = [("B3 40000->1024", clouds[:3].contiguous(), 1024),
              ("duplicates x4 40000->1024", dup.contiguous(), 1024),
              ("8000->512", cloud(8, 8000), 512),
              ("256->256", cloud(8, 256), 256),
              ("tiny 5->16", cloud(2, 5), 16),
              ("shared memory 100000->64", cloud(2, 100000, 20.0), 64)]
    return [("furthest_point_sample", f"K6 FPS {label} (cluster {fps_cluster_of(x)})",
             D.furthest_point_sample, (x, k)) for label, x, k in shapes]


def expected_detect_launches(model) -> dict:
    """Detect-kernel launches of one VoteNet (or BoxNet) training step, from
    the model.  Each set-abstraction module: FPS unless given its centres,
    a ball query, a gather of its centres and one of its group, and a
    scatter-add for each of the two whose table carries a gradient (the
    group, once the module has input features; the centres, when they are
    votes).  The sparse-conv backbone: FPS and the gathers of the seed xyz
    and seed features (the latter with a scatter-add).  The proposal
    module: FPS of the votes (inside its SA module) or of the seeds.  Each
    FP module: three_nn, three_interpolate and, since the known features
    carry a gradient, three_interpolate_grad."""
    from pointcontrast_tpu_torch.detect.modules import PointnetFPModule
    from pointcontrast_tpu_torch.detect.votenet import Pointnet2Backbone

    n = dict.fromkeys(("furthest_point_sample", "ball_query", "gather_rows",
                       "scatter_add_rows", "three_nn", "three_interpolate",
                       "three_interpolate_grad"), 0)
    if isinstance(model.backbone_net, Pointnet2Backbone):
        n["furthest_point_sample"] += 4
        n["ball_query"] += 4
        n["gather_rows"] += 8
        n["scatter_add_rows"] += 3  # SA1 groups the input cloud: no gradient
    else:
        n["furthest_point_sample"] += 1
        n["gather_rows"] += 2
        n["scatter_add_rows"] += 1
    n["furthest_point_sample"] += model.pnet.sampling != "random"
    n["ball_query"] += 1
    n["gather_rows"] += 2
    n["scatter_add_rows"] += 1 + model.use_voting
    n_fp = sum(isinstance(m, PointnetFPModule) for m in model.modules())
    for k in ("three_nn", "three_interpolate", "three_interpolate_grad"):
        n[k] = n_fp
    return n


def _votenet_step_outputs(model, dc, cfg, batch, device, plain, picks=None,
                          reverse=False):
    """One DetectTrainer.train_epoch step of a copy of ``model``, through the
    plain twins or the kernels; returns its loss, backbone output, seed
    features and integer outputs (the ball query recomputed from the step's
    votes and centres, in the same mode).  The backbone output is the
    sparse-conv net's voxel features, or PointNet++'s SA4 features.
    ``picks`` (a list): the step's FPS picks and ball-query groups, in call
    order, are appended to it when it is empty and replayed from it when it
    is not (the recomputed ball query is the mode's own).  ``reverse``: the
    plain twins with gather_gemm_bf16's taps summed in reverse order
    (``_reversed_gemm``)."""
    import torch

    from pointcontrast_tpu_torch.detect import ops as dops
    from pointcontrast_tpu_torch.detect.train import DetectTrainer
    from pointcontrast_tpu_torch.sparse import ops
    from pointcontrast_tpu_torch.tools.workload import plain_ops

    integer_ops = {name: getattr(dops, name) for name in ("furthest_point_sample",
                                                          "ball_query")}
    if picks is not None:
        replay = list(picks)

        def recorded(fn):
            def call(*args):
                if replay:
                    return replay.pop(0)
                picks.append(fn(*args))
                return picks[-1]
            return call
        for name, fn in integer_ops.items():
            setattr(dops, name, recorded(fn))
    m = copy.deepcopy(model)
    seen = {}
    pointnet2 = model.backbone == "pointnet2"
    hooks = [
        (m.backbone_net.sa4 if pointnet2 else m.backbone_net.net).register_forward_hook(
            lambda mod, inp, out: seen.__setitem__(
                "vout", (out[1] if pointnet2 else out).detach())),
        m.register_forward_hook(lambda mod, inp, out: seen.__setitem__("ep", out)),
    ]
    gemm = ops.gather_gemm_bf16
    try:
        with plain_ops() if plain else contextlib.nullcontext():
            if reverse:
                ops.gather_gemm_bf16 = _reversed_gemm
            trainer = DetectTrainer(m, dc, cfg, device)
            loss = trainer.train_epoch(iter([batch]), 1)
            for name, fn in integer_ops.items():
                setattr(dops, name, fn)
            ep = seen["ep"]
            bq = dops.ball_query(ep["aggregated_vote_xyz"].detach(),
                                 ep["vote_xyz"].detach(), 0.3, 16)
    finally:
        ops.gather_gemm_bf16 = gemm
        for name, fn in integer_ops.items():
            setattr(dops, name, fn)
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    ints = {"fps_seeds": ep["seed_inds"], "fps_proposals": ep["aggregated_vote_inds"],
            "ball_query": bq, "object_assignment": ep["object_assignment"]}
    if pointnet2:
        ints["fps_sa1"] = ep["sa1_inds"]
    return {"loss": loss, "vout": seen["vout"],
            "seed_features": ep["seed_features"].detach(), "ints": ints}


def check_parity(model, dc, cfg, batch, device, app):
    """One step through the kernels against the same step through the plain
    twins, from the same weights and batch: backbone output and seed
    features to RTOL; the loss to LOSS_RTOL while every integer output
    agrees, else to LOSS_RTOL_FLIPPED with at most MAX_FLIPPED of any
    integer set differing.  A bf16 backbone: its output and the seed
    features to cosine BF16_COS_MIN (``_agreement``), the loss to
    BF16_VOTENET_LOSS_RTOL (the plain twins' own spread under another f32
    summation order a reading beside it), at most MAX_FLIPPED of the
    object assignments
    differing; the plain step replays the kernel step's FPS picks and
    ball-query groups (both exact against their twins, but the bf16 votes'
    rounding moves the proposals' farthest points and the points at a
    ball's radius, and one flipped FPS pick changes the rest of its
    sequence), and the flips of the ball query recomputed from each step's
    own votes are a reading, as is the loss of a plain step on its own
    picks (``no_replay_loss_rel``: the replay is shown, not hidden)."""
    import torch

    bf16 = (model.backbone == "sparseconv"
            and model.backbone_net.net.dtype == torch.bfloat16)
    picks = [] if bf16 else None
    res = {mode: _votenet_step_outputs(model, dc, cfg, batch, device,
                                       plain=mode == "plain", picks=picks)
           for mode in (("kernels", "plain") if bf16 else ("plain", "kernels"))}
    p, k = res["plain"], res["kernels"]
    rel = {name: float((k[name].float() - p[name].float()).abs().max()
                       / p[name].float().abs().max())
           for name in ("vout", "seed_features")}
    flipped = {name: int((k["ints"][name] != v).sum())
               for name, v in p["ints"].items()}
    held = [n for n in flipped if not (bf16 and n == "ball_query")]
    frac = max(flipped[n] / p["ints"][n].numel() for n in held)
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    loss_rtol = LOSS_RTOL if not any(flipped.values()) else LOSS_RTOL_FLIPPED
    extra = {}
    if bf16:
        r = _votenet_step_outputs(model, dc, cfg, batch, device, plain=True,
                                  picks=picks, reverse=True)
        extra["spread_loss_rel"] = f"{abs(r['loss'] - p['loss']) / abs(p['loss']):.2e}"
        # a reading: the plain step on its own FPS picks and groups
        own = _votenet_step_outputs(model, dc, cfg, batch, device, plain=True)
        extra["no_replay_loss_rel"] = f"{abs(k['loss'] - own['loss']) / abs(own['loss']):.2e}"
        extra["no_replay_flipped"] = {name: int((k["ints"][name] != v).sum())
                                      for name, v in own["ints"].items()}
        extra["spread_cosine"] = {
            name: f"{_agreement(*(t[name].reshape(-1, t[name].shape[-1])
                                  for t in (r, p)))['cosine']:.7f}"
            for name in ("vout", "seed_features")}
        loss_rtol = BF16_VOTENET_LOSS_RTOL
        agree = {name: _agreement(*(t[name].reshape(-1, t[name].shape[-1])
                                    for t in (k, p)))
                 for name in ("vout", "seed_features")}
        extra.update({"cosine": {n: f"{a['cosine']:.7f}" for n, a in agree.items()},
                 "cos_min": BF16_COS_MIN,
                 "row_cosine_min": {n: f"{a['row_min']:.6f}" for n, a in agree.items()},
                 "rows_below_cos_min": {n: f"{a['rows_below']:.2e}"
                                        for n, a in agree.items()}})
        close = min(a["cosine"] for a in agree.values()) >= BF16_COS_MIN
    else:
        close = max(rel.values()) <= RTOL
    say("parity", app=app, loss_kernels=f"{k['loss']:.8f}",
        loss_plain=f"{p['loss']:.8f}", loss_rel=f"{loss_rel:.2e}",
        loss_rtol=loss_rtol, backbone_rel=f"{rel['vout']:.2e}",
        seed_features_rel=f"{rel['seed_features']:.2e}", flipped=flipped, **extra)
    if not (close and loss_rel <= loss_rtol and frac <= MAX_FLIPPED):
        raise AssertionError(f"{app} kernel step differs from the plain step")


def phase_votenet(batches, device, card, model, app, steps=STEPS):
    """A detection main path: the kernels-vs-plain step, then ``steps``
    counted DetectTrainer steps, one evaluate and the eval-mode outputs."""
    import torch

    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.train import (
        DetectConfig,
        DetectTrainer,
        batch_to_inputs,
    )
    from pointcontrast_tpu_torch.sparse import kernels as K

    dc = ScannetDatasetConfig()
    if model.backbone == "sparseconv":
        net = model.backbone_net.net
        expect = expected_launches(net)
        name = (f"VoteNet(sparseconv {type(net).__name__} 3->256"
                f"{' bf16' if net.dtype == torch.bfloat16 else ''})")
    else:
        expect = {fn.__name__: 0 for fn in K.KERNELS}
        name = "VoteNet(pointnet2 SA1-SA4 + FP1-FP2)"
    expect.update(expected_detect_launches(model))
    say("model", app=app, name=name,
        params=sum(p.numel() for p in model.parameters()), per_step=expect)
    cfg = DetectConfig(checkpoint_dir=os.path.join(BUILD_DIR, "smoke_votenet"))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)

    check_parity(model, dc, cfg, batches[0], device, app)

    # the main path: DetectTrainer.train_epoch, counted launches
    trainer = DetectTrainer(model, dc, cfg, device)
    loader = itertools.cycle(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    D.reset_launches()
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch(loader, 1))  # syncs on its loss
        step_ms.append(1e3 * (time.perf_counter() - t0))
        say("step", app=app, iter=i + 1, loss=f"{losses[-1]:.6f}",
            step_ms=f"{step_ms[-1]:.1f}")
    torch.cuda.synchronize()
    counts = {**K.launch_counts(), **D.launch_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {name: v * steps for name, v in expect.items()}
    if counts != want:
        raise AssertionError(f"{app}: launch counts {counts} != expected {want}")
    steady = statistics.median(step_ms[1:])
    scenes = int(batches[0].point_clouds.shape[0])
    say("slice", app=app, steps=steps, launches=counts,
        ms_per_step=f"{steady:.1f}", scenes_per_s=f"{scenes / (steady / 1e3):.2f}",
        first_step_ms=f"{step_ms[0]:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
        card=repr(card))

    # one evaluation pass, then what comes out of the eval-mode model
    t0 = time.perf_counter()
    metrics = trainer.evaluate(iter(batches), None)
    maps = {t: float(m["mAP"]) for t, m in metrics.items()}
    say("eval", app=app, batches=len(batches), mAP=maps,
        seconds=f"{time.perf_counter() - t0:.1f}")
    if not all(0.0 <= v <= 1.0 for v in maps.values()):
        raise AssertionError(f"mAP outside [0, 1]: {maps}")
    trainer.model.eval()
    with torch.no_grad():
        ep = trainer.model(batch_to_inputs(batches[0]))
    nc, ns, npr = dc.num_class, dc.num_size_cluster, model.pnet.num_proposal
    shapes = {"seed_xyz": (scenes, 1024, 3), "vote_xyz": (scenes, 1024, 3),
              "center": (scenes, npr, 3), "objectness_scores": (scenes, npr, 2),
              "size_residuals": (scenes, npr, ns, 3),
              "sem_cls_scores": (scenes, npr, nc)}
    for name, shape in shapes.items():
        t = ep[name]
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"bad {name}: {tuple(t.shape)} (want {shape})")
    say("output", app=app, fields=len(shapes), proposals=npr)
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    return counts


def make_pointnet2_batches(device):
    """Two batches of the PointNet++ path: the same scenes, no voxels; the
    integer labels checked against the dataset config's ranges."""
    import torch

    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.tools.workload import votenet_batches

    dc = ScannetDatasetConfig()
    t0 = time.perf_counter()
    dev = votenet_batches(device, voxel=None)
    limits = {"heading_class_label": dc.num_heading_bin,
              "size_class_label": dc.num_size_cluster, "sem_cls_label": dc.num_class}
    for b in dev:
        if b.voxel_feats is not None or b.point_clouds.shape[1:] != (40000, 3):
            raise AssertionError(f"bad batch: {tuple(b.point_clouds.shape)}")
        if not (torch.isfinite(b.point_clouds).all() and torch.isfinite(b.vote_label).all()):
            raise AssertionError("non-finite points or vote labels")
        for k, n in limits.items():
            v = getattr(b, k)
            if int(v.min()) < 0 or int(v.max()) >= n:
                raise AssertionError(f"{k} outside [0, {n})")
    say("data", app="votenet pointnet2", seconds=f"{time.perf_counter() - t0:.1f}",
        scenes=int(dev[0].point_clouds.shape[0]),
        points=int(dev[0].point_clouds.shape[1]),
        objects=[int(b.box_label_mask.sum()) for b in dev])
    return dev


def pointnet2_kernel_checks(model, batch):
    """[(kernel, label, fn, args)] at the PointNet++ step's shapes, from one
    forward of a copy of ``model`` through the kernels.  For each
    set-abstraction module (SA1-SA4 and the proposal module's, whose FPS
    runs over the 1024 votes): its FPS, ball query, the gathers of its
    centres and of its group, and the scatter-adds of those whose table
    carries a gradient (the group once the module has input features, the
    centres when they are votes), with random cotangents, and the votes'
    group scatter-add once more at a heavy tail (``heavy_tail_check``).
    Then K9 at FP1 (512 unknown over 256 known points) and FP2 (1024 over
    512)."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.detect import ops as dops
    from pointcontrast_tpu_torch.detect.train import batch_to_inputs

    dev = batch.point_clouds.device
    m = copy.deepcopy(model).to(dev)
    net = m.backbone_net
    sa = {"SA1": net.sa1, "SA2": net.sa2, "SA3": net.sa3, "SA4": net.sa4,
          "votes": m.pnet.vote_aggregation}
    seen = {}
    hooks = [mod.register_forward_hook(
        lambda mod, i, o, name=name: seen.__setitem__(name, (i, o)))
        for name, mod in sa.items()]
    for name in ("fp1", "fp2"):
        hooks.append(getattr(net, name).register_forward_pre_hook(
            lambda mod, args, name=name: seen.__setitem__(name, args)))
    with torch.no_grad():
        m.train()(batch_to_inputs(batch))
    for h in hooks:
        h.remove()
    gen = torch.Generator(device=dev).manual_seed(2)
    checks = []
    for name, mod in sa.items():
        (xyz, feats), (new_xyz, _, inds) = seen[name]
        xyz = xyz.contiguous()
        b_, n, _ = xyz.shape
        r, ns, k = mod.radius, mod.nsample, new_xyz.shape[1]
        group = D.ball_query_plain(new_xyz, xyz, r, ns)
        table = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        c = table.shape[2]
        checks += [
            ("furthest_point_sample", f"K6 FPS {name} {n}->{k}",
             D.furthest_point_sample, (xyz, k)),
            ("ball_query", f"K7 {name} {k} centres over {n} points r{r} ns{ns}",
             D.ball_query, (new_xyz, xyz, r, ns)),
            ("gather_rows", f"K8 {name} centres", D.gather_rows, (xyz, inds)),
            ("gather_rows", f"K8 {name} group {c}", D.gather_rows, (table, group)),
        ]
        if feats is not None:
            checks.append(("scatter_add_rows", f"K8 bwd {name} group {c}",
                           D.scatter_add_rows,
                           (torch.randn(b_, k, ns, c, device=dev, generator=gen),
                            group, n)))
        if name == "votes":
            checks.append(("scatter_add_rows", "K8 bwd votes centres",
                           D.scatter_add_rows,
                           (torch.randn(b_, k, 3, device=dev, generator=gen), inds, n)))
            checks.append(heavy_tail_check(f"K8 bwd {name} group {c}", new_xyz, xyz,
                                           ns, c, gen))
    del m
    xyz3, xyz4, _, feat4 = (t.contiguous() for t in seen["fp1"])
    xyz2, _, _, f3 = (t.contiguous() for t in seen["fp2"])
    d1, i1 = D.three_nn_plain(xyz3, xyz4)
    d2, i2 = D.three_nn_plain(xyz2, xyz3)
    w1, w2 = dops.interpolation_weights(d1), dops.interpolation_weights(d2)
    ct1 = torch.randn(*xyz3.shape[:2], feat4.shape[2], device=dev, generator=gen)
    ct2 = torch.randn(*xyz2.shape[:2], f3.shape[2], device=dev, generator=gen)
    return checks + [
        ("three_nn", "K9 FP1 512 over 256", D.three_nn, (xyz3, xyz4)),
        ("three_nn", "K9 FP2 1024 over 512", D.three_nn, (xyz2, xyz3)),
        ("three_interpolate", "K9 FP1 256 ch", D.three_interpolate, (feat4, i1, w1)),
        ("three_interpolate", "K9 FP2 256 ch", D.three_interpolate, (f3, i2, w2)),
        ("three_interpolate_grad", "K9 bwd FP1 256 ch", D.three_interpolate_grad,
         (ct1, i1, w1, xyz4.shape[1])),
        ("three_interpolate_grad", "K9 bwd FP2 256 ch", D.three_interpolate_grad,
         (ct2, i2, w2, xyz3.shape[1])),
    ]


def phase_boxnet(batches, device):
    """One BoxNet step (PointNet++ backbone, seed FPS, get_loss_boxnet)."""
    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.train import (
        DetectConfig,
        DetectTrainer,
        get_bn_momentum,
    )
    from pointcontrast_tpu_torch.tools.workload import votenet_model

    cfg = DetectConfig(checkpoint_dir=os.path.join(BUILD_DIR, "smoke_boxnet"))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    model = votenet_model(seed=1, backbone="pointnet2", use_voting=False)
    trainer = DetectTrainer(model, ScannetDatasetConfig(), cfg, device)
    trainer.set_bn_momentum(get_bn_momentum(0, cfg))
    t0 = time.perf_counter()
    metrics = {k: float(v) for k, v in
               trainer._step(trainer.model, trainer.opt, batches[0]).items()}
    say("boxnet", loss=f"{metrics['loss']:.6f}", vote_loss=metrics["vote_loss"],
        objectness_loss=f"{metrics['objectness_loss']:.6f}",
        step_ms=f"{1e3 * (time.perf_counter() - t0):.1f}")
    if not math.isfinite(metrics["loss"]) or metrics["vote_loss"] != 0.0:
        raise AssertionError(f"bad BoxNet step: {metrics}")


def phase_cli(sparse=False, backbone_model=None):
    """``apps.votenet.main`` on the card with the shipped config and
    ``net.backbone=pointnet2`` (``sparse``: the shipped sparse-conv
    backbone, chunked, ``net.dtype: bfloat16`` as written, its net
    ``net.backbone_model=<backbone_model>`` when given): one epoch of 8
    synthetic scenes (one step), one evaluation, a checkpoint; a second
    call resumes from it and has nothing left to train."""
    import torch

    from pointcontrast_tpu_torch.apps import votenet as app
    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.sparse import kernels as K

    out = os.path.join(BUILD_DIR, "smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    args = ([] if sparse else ["net.backbone=pointnet2"]) + [
        "data.dataset=synthetic", "data.num_scenes=8", "optimizer.max_epoch=1",
        "eval.eval_every=1", f"misc.out_dir={out}", "distributed.num_devices=1"]
    args += [f"net.backbone_model={backbone_model}"] if backbone_model else []
    # K1-K3's bf16 forms; a Hyper backbone's unpools
    needed = ([f"{n}_bf16" for n in ("gather_gemm", "gather_wgrad", "parent_gemm")]
              if sparse else [])
    if backbone_model == "MinkUNetHyper14INBN":
        needed += ["gather_sum_bf16", "scatter_sum_bf16"]
    t0 = time.perf_counter()
    D.reset_launches()
    K.reset_launches()
    trainer = app.main(args)
    torch.cuda.synchronize()
    first = D.launch_counts()
    sparse_counts = K.launch_counts()
    seconds = time.perf_counter() - t0
    ckpt = os.path.join(out, "weights", "checkpoint_1.pth")
    if trainer.epoch != 1 or not os.path.exists(ckpt) or trainer.device.type != "cuda":
        raise AssertionError("the CLI run did not train, save and stay on the card")
    if sparse and trainer.model.backbone_net.net.dtype != torch.bfloat16:
        raise AssertionError("the CLI did not run the shipped bf16 backbone")
    # the sparse-conv backbone runs no three_nn / three_interpolate (PointNet++'s FP)
    detect_needed = [k for k in first if not (sparse and k.startswith("three_"))]
    if (not all(first[k] for k in detect_needed)
            or not all(sparse_counts[k] for k in needed)):
        raise AssertionError(f"the CLI run missed a kernel: {first} {sparse_counts}")
    D.reset_launches()
    K.reset_launches()
    resumed = app.main(args)
    if (resumed.epoch != 1 or any(D.launch_counts().values())
            or any(K.launch_counts().values())):
        raise AssertionError("the resumed CLI run trained again")
    say("cli", app="votenet", backbone=(f"sparseconv {backbone_model or 'Res16UNet34C'} bf16"
                                        if sparse else "pointnet2"),
        seconds=f"{seconds:.1f}", epoch=trainer.epoch,
        launches={**first, **{k: sparse_counts[k] for k in needed}},
        checkpoint=os.path.relpath(ckpt, ROOT), resumed_epoch=resumed.epoch)
    shutil.rmtree(out, ignore_errors=True)


def make_semseg_batch(device, scenes=None, layout="chunked", crf=True):
    """The semseg workload's scenes and its one batch in ``layout`` (with
    the CRF map unless ``crf`` is False) on the card, bounds-checked."""
    from pointcontrast_tpu_torch.tools import workload as W

    t0 = time.perf_counter()
    scenes = scenes or W.SemsegScenes()
    host = W.semseg_batch(scenes, crf=W.SEMSEG_CRF if crf else None, layout=layout)
    batch = host.to(device)
    pyr = batch.pyramid
    rows = int(batch.feats.shape[0])
    found = (None if host.crf_nbr is None else
             int((host.crf_nbr[:, host.pyramid.levels[0].valid > 0] != rows - 1).sum()))
    say("data", app="semseg", layout=layout, seconds=f"{time.perf_counter() - t0:.1f}",
        samples=pyr.num_batch, voxels=[len(c) for c, _, _ in scenes.samples],
        rows=[int(l.valid.shape[0]) for l in pyr.levels],
        valid_rows=[int(l.valid.sum()) for l in pyr.levels],
        truncated=float(host.truncated_voxels),
        crf_taps=None if host.crf_nbr is None else host.crf_nbr.shape[0],
        crf_neighbours_found=found)
    return scenes, batch


def conv_calls(model, feats, run):
    """[(kind, name, weight, args, kwargs, stem)] for every conv call of one
    train-mode forward ``run(m)`` of a copy ``m`` of ``model`` (under
    no_grad) on the input features ``feats``.  Kinds: "conv"
    (a same-level map with ``rev``: K1; with ``up``: K2), "k4" (any other
    map), "tr" (K3), "crf" (the CRF filter's flat map), "brick" (a
    BrickMap), "bdown" (a BrickDownMap) and "bup" (a brick up conv).  Flat
    (voxel) maps come as the kernels take them, one [K, 1, N] chunk, with
    ``flat`` set in kwargs.
    ``stem``: the call reads the batch's input features (or, in a bf16 net,
    their bf16 cast: the first call, of their shape), whose gradient no
    one needs."""
    import torch

    from pointcontrast_tpu_torch.nn.layers import SparseConv, SparseConvTranspose
    from pointcontrast_tpu_torch.semseg.crf import MeanFieldCRF
    from pointcontrast_tpu_torch.sparse.brick import BrickDownMap, BrickMap

    m = copy.deepcopy(model).to(feats.device)
    calls = []

    def record(kind, name, mod, args, kwargs):
        args = list(args)
        kwargs = dict(kwargs)
        if kind == "conv":
            rev = args[3] if len(args) > 3 else kwargs.get("rev")
            if isinstance(args[1], BrickMap):
                kind = "brick"
            elif isinstance(args[1], BrickDownMap):
                kind = "bdown"
            elif kwargs.get("up") is None and rev is None:
                kind = "k4"
            if kind in ("conv", "k4") and args[1].dim() == 2:  # voxel: one chunk
                kwargs["flat"] = True
                args[1] = args[1][:, None]
                if kwargs.get("up") is not None:
                    kwargs["up"] = tuple(None if u is None else u[None] for u in kwargs["up"])
                if kwargs.get("order") is not None:
                    kwargs["order"] = kwargs["order"][None]
        elif kind == "tr":
            if args[2] is None:
                kind = "bup"
            elif args[1].dim() == 1:
                args[1], args[2] = args[1][None], args[2][None]
                if kwargs.get("up_order") is not None:
                    kwargs["up_order"] = kwargs["up_order"][None]
                if kwargs.get("down") is not None:  # the flat down map and its order
                    down, order = kwargs["down"]
                    kwargs["down"] = (down[:, None], None if order is None else order[None])
        stem = args[0] is feats or (not calls and args[0].shape == feats.shape
                                    and args[0].dtype != feats.dtype)
        calls.append((kind, name, mod.weight.detach(), tuple(args), kwargs, stem))

    hooks = []
    for name, mod in m.named_modules():
        kind = {SparseConv: "conv", SparseConvTranspose: "tr",
                MeanFieldCRF: "crf"}.get(type(mod))
        if kind:
            hooks.append(mod.register_forward_hook(
                lambda mod, a, kw, out, kind=kind, name=name: record(kind, name, mod, a, kw),
                with_kwargs=True))
    with torch.no_grad():
        m.train()
        run(m)
    for h in hooks:
        h.remove()
    return calls


def expected_from_calls(calls) -> dict:
    """Sparse-kernel launches of one training step from its conv calls:
    K1 fwd + dF (not for the stem) + dW, each a launch a tap group
    (``ops.k1_groups``: one at up to MAX_TAPS off-centre taps); K2 fwd +
    dF + dW; K3 fwd + dF + dW; K4 per group of MAX_TAPS taps fwd +
    scatter_gemm dF
    (not for the stem) + dW; a brick conv brick_gemm fwd + dF (not for the
    stem) + brick_wgrad; a brick down conv's placement and a brick up
    conv's parent gather a gather_sum and its scatter_sum each, none at the
    hybrid boundary (the matmuls are torch.matmul).  The CRF's filter is
    counted by ``expected_semseg_launches``.  bf16 features run the bf16
    forms."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.sparse import ops

    n = {fn.__name__: 0 for fn in K.KERNELS}
    for kind, _, w, args, kw, stem in calls:
        sfx = "_bf16" if args[0].dtype == torch.bfloat16 else ""
        if kind == "conv" and kw.get("up") is None:  # a launch a tap group
            rev = args[3] if len(args) > 3 else kw.get("rev")
            fwd, df, dw = ops.k1_groups(w.shape[0], rev, bool(sfx and kw.get("flat")))
            n[f"gather_gemm{sfx}"] += len(fwd) + len(df) * (not stem)
            n[f"gather_wgrad{sfx}"] += len(dw)
        elif kind == "conv":
            n[f"gather_gemm{sfx}"] += 1
            n[f"parent_gemm{sfx}"] += 1
            n[f"gather_wgrad{sfx}"] += 1
        elif kind == "tr":
            for name in ("parent_gemm", "gather_gemm", "gather_wgrad"):
                n[name + sfx] += 1
        elif kind == "k4":  # scatter_gemm_bf16 launches once a group too
            groups = len(ops._tap_groups(w.shape[0]))
            n[f"gather_gemm{sfx}"] += groups
            n[f"scatter_gemm{sfx}"] += groups * (not stem)
            n[f"gather_wgrad{sfx}"] += groups
        elif kind == "brick":
            n[f"brick_gemm{sfx}"] += 1 + (not stem)
            n[f"brick_wgrad{sfx}"] += 1
        elif (kind == "bdown" and args[1].place is not None) or (
                kind == "bup" and args[1] is not None):
            n[f"gather_sum{sfx}"] += 1
            n[f"scatter_sum{sfx}"] += 1
    return n


def conv_checks(model, batch, calls=None):
    """[(kernel, label, fn, args)] for every conv of ``model``'s semseg
    forward on ``batch`` (or of ``calls``, from ``conv_calls``) of a
    distinct shape, on the forward's own
    input features and random cotangents masked as the outputs: K1 (fwd,
    dF unless the stem, dW), K2 (fwd, dF, dW), K3 (fwd, and dF and dW
    through the down map; then its parent design on the same cotangent,
    labelled "K3 parent": the scatter into the stacked table, dF and dW on
    it, which ``conv_phase`` times on their own),
    K4 (a chunked map with neither ``rev`` nor ``up``: fwd, scatter_gemm
    dF, dW), the CRF filter's flat conv at B = 1 (fwd, scatter_gemm dF,
    dW, per group of MAX_TAPS taps, on its first mean-field input; in bf16
    the forward's taps rounded and dF one call over every tap), a
    brick conv (brick_gemm fwd, brick_gemm dF with W[rev]^T unless the
    stem, brick_wgrad dW), a brick down conv's placement gather and a brick
    up conv's parent gather (gather_sum at one tap, scatter_sum its
    adjoint)."""
    import torch

    from pointcontrast_tpu_torch.semseg.train import forward
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.sparse import ops
    from pointcontrast_tpu_torch.sparse.brick import _tap_reversal, slot_steps

    if calls is None:
        calls = conv_calls(model, batch.feats, lambda m: forward(m, batch))
    seen = {}
    for kind, name, w, args, kw, stem in calls:
        m1 = args[1]
        shape = (tuple(m1.shape) if torch.is_tensor(m1)
                 else (type(m1).__name__, getattr(m1, "place", m1) is None))
        seen.setdefault((kind, tuple(args[0].shape), tuple(w.shape), shape, stem),
                        (name, w, args, kw))
    dev = next(iter(seen.values()))[2][0].device
    gen = torch.Generator(device=dev).manual_seed(3)
    checks = []
    for (kind, fshape, wshape, _, stem), (name, w, args, kw) in seen.items():
        k, cin, cout = wshape
        wt = w.transpose(1, 2)
        if kind == "crf":
            unary, nbr, valid = args
            x = ops.mask_rows(torch.softmax(unary, dim=1), valid)[None].contiguous()
            n = x.shape[1]
            m3 = nbr[:, None]
            groups = ops._tap_groups(k)
            if x.dtype == torch.bfloat16:  # the filter in the logits' bf16
                w = w.to(x.dtype)
                ct = _masked_randn((1, n, cout), valid, gen).to(x.dtype)
                # dF: one call over every tap (a launch a group, one rounding);
                # the forward's taps rounded, their sums f32 past one group
                checks.append(("scatter_gemm_bf16", f"flat dF {name} {k} taps N{n} "
                               f"{cin}->{cout}", K.scatter_gemm_bf16,
                               (ct, m3, list(range(k)), w, n, n - 1, None)))
                for taps in groups:
                    wg = w[taps.start:taps.stop]
                    tag = f"{name} taps {taps.start}-{taps.stop - 1} of {k} N{n} {cin}->{cout}"
                    checks += [
                        ("gather_gemm_bf16", f"flat fwd per tap {tag}", K.gather_gemm_bf16,
                         (x, m3, taps, 0, wg, None, n, n - 1, None, True, len(groups) > 1)),
                        ("gather_wgrad_bf16", f"flat dW {tag}", K.gather_wgrad_bf16,
                         (x, m3, taps, 0, ct, None, None, 0, len(taps), n, n - 1, -1)),
                    ]
                continue
            ct = _masked_randn((1, n, cout), valid, gen)
            for taps in groups:
                wg = w[taps.start:taps.stop]
                tag = f"{name} taps {taps.start}-{taps.stop - 1} of {k} N{n} {cin}->{cout}"
                checks += [
                    ("gather_gemm", f"flat fwd {tag}", K.gather_gemm,
                     (x, m3, taps, 0, wg, None, n, n - 1)),
                    ("scatter_gemm", f"flat dF {tag}", K.scatter_gemm,
                     (ct, m3, taps, wg, n, n - 1, None)),
                    ("gather_wgrad", f"flat dW {tag}", K.gather_wgrad,
                     (x, m3, taps, 0, ct, None, None, 0, len(taps), n, n - 1, -1)),
                ]
            continue
        if kind == "brick":  # bf16 features: the bf16 forms, on the weights' bf16 cast
            bm, valid = args[1], args[2]
            steps = slot_steps(bm.plan)
            rev = _tap_reversal(bm.plan)
            f = args[0].contiguous()
            sfx = "_bf16" if f.dtype == torch.bfloat16 else ""
            gemm, wgrad = getattr(K, f"brick_gemm{sfx}"), getattr(K, f"brick_wgrad{sfx}")
            w = w.to(f.dtype)
            ct = _masked_randn((1, f.shape[0], cout), valid, gen)[0].to(f.dtype)
            tag = f"{name} NB{bm.nbr.shape[1]} {k} taps {cin}->{cout}"
            checks.append((f"brick_gemm{sfx}", f"brick fwd {tag}", gemm,
                           (f, bm.nbr, steps, w.contiguous(), valid, bm.order)))
            if not stem:
                checks.append((f"brick_gemm{sfx}", f"brick dF {tag}", gemm,
                               (ct, bm.nbr, steps,
                                w[list(rev)].transpose(1, 2).contiguous(), valid, bm.order)))
            checks.append((f"brick_wgrad{sfx}", f"brick dW {tag}", wgrad,
                           (f, bm.nbr, steps, ct, k, valid, bm.order)))
            continue
        if kind in ("bdown", "bup"):
            # the adjoint leaves out the source's pad rows, as the ops do:
            # the flat next level's last row (placement), the coarse pad
            # brick's k slots (up gather)
            if kind == "bdown":
                if args[1].place is None:
                    continue  # the hybrid boundary: no gather
                src_rows, c = args[0].shape[0] // k, cout
                rows = args[1].place.transpose(0, 1).reshape(1, 1, -1).contiguous()
                skip_from = src_rows - 1
            else:
                if args[1] is None:
                    continue
                src_rows, c = args[0].shape[0], cin
                rows = args[1].reshape(1, 1, -1)
                skip_from = src_rows - k
            n_out = rows.shape[2]
            dt = args[0].dtype  # bf16: the bf16 forms (a copy, the store form)
            sfx = "_bf16" if dt == torch.bfloat16 else ""
            f = torch.randn(1, src_rows, c, device=dev, generator=gen).to(dt)
            ct = torch.randn(1, n_out, c, device=dev, generator=gen).to(dt)
            tag = f"{name} {kind} {src_rows}->{n_out} C{c}"
            checks += [
                (f"gather_sum{sfx}", f"{tag} fwd", getattr(K, f"gather_sum{sfx}"),
                 (f, rows, [0], 0, n_out)),
                (f"scatter_sum{sfx}", f"{tag} bwd", getattr(K, f"scatter_sum{sfx}"),
                 (ct, rows, [0], 0, src_rows, skip_from)),
            ]
            continue
        nb = (args[1].shape[1] if kind in ("conv", "k4") else args[1].shape[0])
        f3 = args[0].reshape(nb, -1, cin).contiguous()
        s_in = f3.shape[1]
        # bf16 features: the bf16 forms, on the weights' bf16 cast
        dt = f3.dtype
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        gemm, wgrad, pgemm = (getattr(K, f"{n}{sfx}")
                              for n in ("gather_gemm", "gather_wgrad", "parent_gemm"))
        if sfx:
            w = w.to(dt)
            wt = w.transpose(1, 2)
        if kind == "k4":  # the ResNets' k3s2 (81 taps in 4-D: groups) and 1-tap maps
            nbr, valid = args[1], args[2]
            s_out = nbr.shape[2]
            ct = _masked_randn((nb, s_out, cout), valid, gen).to(dt)
            groups = ops._tap_groups(k)
            # a flat bf16 forward rounds each tap; past one group the f32
            # partials are added and rounded once (sparse/ops.py)
            per_tap = (True, len(groups) > 1) if sfx and kw.get("flat") else ()
            tag = f"{name} S{s_in}->S{s_out} {k} taps {cin}->{cout}"
            order = kw.get("order")
            if sfx:  # dF: one call over every tap (a launch a group, one f32 table)
                checks.append((f"scatter_gemm{sfx}", f"K4 dF {tag}",
                               getattr(K, f"scatter_gemm{sfx}"),
                               (ct, nbr, list(range(k)), w.contiguous(), s_in, s_in - 1,
                                order)))
            for taps in groups:
                wg = w[taps.start:taps.stop].contiguous()
                gtag = tag if len(groups) == 1 else f"{tag} taps {taps.start}-{taps.stop - 1}"
                checks += [
                    (f"gather_gemm{sfx}", f"K4 fwd {'per tap ' * bool(per_tap)}{gtag}", gemm,
                     (f3, nbr, list(taps), 0, wg, None, s_out, s_in - 1, order, *per_tap)),
                    (f"gather_wgrad{sfx}", f"K4 dW {gtag}", wgrad,
                     (f3, nbr, list(taps), 0, ct, None, None, 0, len(taps), s_out, s_in - 1,
                      -1)),
                ]
                if not sfx:
                    checks.append((f"scatter_gemm{sfx}", f"K4 dF {gtag}", K.scatter_gemm,
                                   (ct, nbr, list(taps), wg, s_in, s_in - 1, order)))
        elif kind == "conv" and kw.get("up") is None:  # K1, in its tap groups
            nbr, valid, rev = args[1], args[2], args[3] if len(args) > 3 else kw.get("rev")
            center = next(i for i, r in enumerate(rev) if r == i)
            ct = _masked_randn((nb, s_in, cout), valid, gen).to(dt)
            order = kw.get("order")
            # the voxel bf16 forward: each tap rounded, the centre gathered in
            # its place (sparse/ops.py, JAX's _conv_core)
            per_tap = bool(sfx and kw.get("flat"))
            fwd, dfg, dwg = ops.k1_groups(k, rev, per_tap)
            tag = f"{name} B{nb} S{s_in} {k} taps {cin}->{cout}"

            def gtag(groups, i):
                taps = groups[i]
                return tag if len(groups) == 1 else f"{tag} taps {taps[0]}-{taps[-1]}"

            # past one group: the bf16 partials' f32 sums (rounded once by the op)
            f32_out = (True,) if sfx and len(fwd) > 1 else ()
            for i, taps in enumerate(fwd):
                if per_tap:
                    checks.append((f"gather_gemm{sfx}", f"K1 fwd per tap {gtag(fwd, i)}", gemm,
                                   (f3, nbr, taps, 0, w[taps].contiguous(), None, s_in,
                                    s_in - 1, order, True, *f32_out)))
                else:
                    wc = w[center] if i == 0 else None
                    checks.append((f"gather_gemm{sfx}", f"K1 fwd {gtag(fwd, i)}", gemm,
                                   (f3, nbr, taps, 0, w[taps].contiguous(), wc, s_in,
                                    s_in - 1, order, *((False,) + f32_out if f32_out else ()))))
            f32_out = (False, True) if sfx and len(dfg) > 1 else ()
            for i, taps in enumerate(dfg if not stem else ()):
                wtc = wt[center].contiguous() if i == 0 else None
                checks.append((f"gather_gemm{sfx}", f"K1 dF {gtag(dfg, i)}", gemm,
                               (ct, nbr, [rev[j] for j in taps], 0, wt[taps].contiguous(),
                                wtc, s_in, s_in - 1, order, *f32_out)))
            for i, taps in enumerate(dwg):
                checks.append((f"gather_wgrad{sfx}", f"K1 dW {gtag(dwg, i)}", wgrad,
                               (f3, None, None, 0, ct, nbr, [rev[j] for j in taps], 0,
                                len(taps), s_in, -1, s_in - 1)))
        elif kind == "conv":  # K2
            down, valid = args[1], args[2]
            parent, off, up_order = (*kw["up"], None)[:3]
            s_out = down.shape[2]
            ct = _masked_randn((nb, s_out, cout), valid, gen).to(dt)
            tag = f"{name} B{nb} S{s_in}->S{s_out} {cin}->{cout}"
            per_tap = (True,) if sfx and kw.get("flat") else ()  # the voxel bf16 forward
            checks += [
                (f"gather_gemm{sfx}", f"K2 fwd {'per tap ' * bool(per_tap)}{tag}", gemm,
                 (f3, down, list(range(k)), 0, w, None, s_out, s_in - 1, kw.get("order"),
                  *per_tap)),
                (f"parent_gemm{sfx}", f"K2 dF {tag}", pgemm,  # on W^T (trans_w)
                 (ct, parent, off, w, -1, up_order, True)),
                (f"gather_wgrad{sfx}", f"K2 dW {tag}", wgrad,
                 (f3, down, list(range(k)), 0, ct, None, None, 0, k, s_out, s_in - 1,
                  -1)),
            ]
        else:  # K3: dF and dW through the down map; its parent design beside them
            parent, off, valid = args[1], args[2], args[3]
            up_order = kw.get("up_order")
            s_f = parent.shape[1]
            down, down_order = kw.get("down") or (ops.down_from_up(parent, off, k, s_in), None)
            ct = _masked_randn((nb, s_f, cout), valid, gen).to(dt)
            taps = list(range(k))
            # the parent design: the f32 scatter dy, dF by the f32 gather_gemm
            # on it against the widened weights (rounded once in bf16)
            dy = getattr(K, f"scatter_parent{sfx}_plain")(ct, parent, off, k, s_in)
            tag = f"{name} B{nb} S{s_in}->S{s_f} {cin}->{cout}"
            checks += [
                (f"parent_gemm{sfx}", f"K3 fwd {tag}", pgemm,
                 (f3, parent, off, w, s_in - 1, up_order)),
                (f"gather_gemm{sfx}", f"K3 dF {tag}", gemm,
                 (ct, down, taps, 0, wt.contiguous(), None, s_in, s_f - 1, down_order)),
                (f"gather_wgrad{sfx}", f"K3 dW {tag}", wgrad,
                 (f3, None, None, 0, ct, down, taps, 0, k, s_in, s_in - 1, s_f - 1)),
                (f"scatter_parent{sfx}", f"K3 parent scatter {tag}",
                 getattr(K, f"scatter_parent{sfx}"), (ct, parent, off, k, s_in)),
                ("gather_gemm", f"K3 parent dF {tag}", K.gather_gemm,
                 (dy, None, None, s_in, wt.float().contiguous(), None, s_in, -1)),
                (f"gather_wgrad{sfx}", f"K3 parent dW {tag}", wgrad,
                 (f3, None, None, 0, dy, None, None, s_in, k, s_in, -1, -1)),
            ]
    return checks


def conv_phase(app, checks, paths, exact=()):
    """``phase_kernels`` of a path's conv checks (``conv_checks``), but for
    those of K3's parent design (labels "K3 parent"), which run on their
    own: their numbers go into ``paths`` as "<app> K3 parent design", with
    no launches (no path runs that design), and a ``[k3]`` line compares
    them (``k3_line``).  Returns the other checks' numbers."""
    from pointcontrast_tpu_torch.sparse import kernels as K

    parent = [c for c in checks if c[1].startswith("K3 parent ")]
    new, old = {}, {}
    res = phase_kernels([c for c in checks if not c[1].startswith("K3 parent ")], K, exact,
                        by_label=new)
    if parent:
        paths[f"{app} K3 parent design"] = (phase_kernels(parent, K, by_label=old), {})
        k3_line(app, checks, new, old)
    return res


def k3_line(app, checks, new, old):
    """One ``[k3]`` line a path: the device ms of K3's backward through the
    down map (its dF and dW checks, numbers ``new`` by label) against its
    parent design's on the same cotangents (the scatter, the stacked dF and
    dW: ``old``), their ratio beside the bar (0.5 in bf16, 0.7 in f32: a
    reading, not a check), the bound of the new launches and the live
    pairs: the down maps' (tap, coarse row) entries that name a fine row,
    against every row of the stacked table the parent design reads."""
    import torch

    mine = [r for label, r in new.items() if label.startswith(("K3 dF ", "K3 dW "))]
    device_ms = sum(r["device_ms"] for r in mine)
    parent_ms = sum(r["device_ms"] for r in old.values())
    bound_ms = sum(r["bound_ms"] for r in mine)
    live = pairs = convs = 0
    bf16 = False
    for _, label, _, args in checks:
        if label.startswith("K3 dF "):
            down, skip = args[1], args[7]
            live += int((down != skip).sum())
            pairs += down.numel()
            convs += 1
            bf16 = args[0].dtype == torch.bfloat16
    bar = 0.5 if bf16 else 0.7
    ratio = device_ms / parent_ms
    say("k3", app=app, shapes=convs, device_ms=f"{device_ms:.4f}",
        parent_device_ms=f"{parent_ms:.4f}", ratio=f"{ratio:.3f}", bar=bar,
        met=ratio <= bar, bound_ms=f"{bound_ms:.4f}",
        share_of_bound=f"{bound_ms / device_ms:.3f}", live_pairs=live, pairs=pairs,
        live_share=f"{live / pairs:.3f}")


def inbn_checks(model, batch):
    """(sparse-kernel checks, detect-kernel checks) at every
    InstanceBatchNorm's shapes in one forward of a copy of ``model``: the
    pooling's segment_sums over its real input and over ones (the counts),
    the broadcast's backward segment_sum and both row gathers (the
    broadcast's and the pooling's backward), with random per-sample tables
    and cotangents."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.nn.resnet_block import InstanceBatchNorm
    from pointcontrast_tpu_torch.semseg.train import forward
    from pointcontrast_tpu_torch.sparse import kernels as K

    m = copy.deepcopy(model).to(batch.feats.device)
    seen = {}
    hooks = [mod.register_forward_hook(
        lambda mod, a, out: seen.setdefault(tuple(a[0].shape), a) and None)
        for mod in m.modules() if isinstance(mod, InstanceBatchNorm)]
    with torch.no_grad():
        m.train()
        forward(m, batch)
    for h in hooks:
        h.remove()
    dev = batch.feats.device
    gen = torch.Generator(device=dev).manual_seed(4)
    sparse, detect = [], []
    for (n, c), (x, _, ids, nb) in seen.items():
        idx = ids.clamp(max=nb - 1)
        tag = f"N{n} C{c}"
        sparse += [
            ("segment_sum", f"pool fwd {tag}", K.segment_sum,
             (x.float().contiguous(), ids, nb + 1)),
            ("segment_sum", f"pool counts N{n}", K.segment_sum,
             (torch.ones(n, 1, device=dev), ids, nb + 1)),
            ("segment_sum", f"broadcast bwd {tag}", K.segment_sum,
             (torch.randn(n, c, device=dev, generator=gen), idx, nb)),
        ]
        detect += [
            ("gather_rows", f"broadcast fwd {tag}", D.gather_rows,
             (torch.randn(1, nb, c, device=dev, generator=gen), idx[None])),
            ("gather_rows", f"pool bwd {tag}", D.gather_rows,
             (torch.randn(1, nb + 1, c, device=dev, generator=gen), ids[None])),
        ]
    return sparse, detect


def segment_sum_general_check(device):
    """segment_sum's general path (more than SEG_SMEM segments: run sums
    added with f32 atomics) against its twin: random ids in [0, S), not in
    runs, over SEG_GENERAL's rows and channels."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K

    s, n, c = SEG_GENERAL
    assert s > K.SEG_SMEM
    gen = torch.Generator(device=device).manual_seed(5)
    ids = torch.randint(0, s, (n,), device=device, generator=gen, dtype=torch.int32)
    return [("segment_sum", f"general S{s} N{n} C{c}", K.segment_sum,
             (torch.randn(n, c, device=device, generator=gen), ids, s))]


def expected_semseg_launches(model) -> tuple:
    """(launches of every kernel in one semseg training step without the
    CRF filter, the filter's extra launches when it runs).  The backbone's
    convs as ``expected_launches``; each InstanceBatchNorm two global pools
    (two segment_sums forward, the sums and the counts, and a row gather
    backward) and two broadcasts (a row gather forward, a segment_sum
    backward); each mean-field iteration one flat conv per group of
    MAX_TAPS taps: gather_gemm, scatter_gemm and gather_wgrad."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.nn.resnet_block import InstanceBatchNorm
    from pointcontrast_tpu_torch.semseg.crf import Wrapper
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.sparse import ops

    n = {fn.__name__: 0 for fn in K.KERNELS + D.KERNELS}
    n.update(expected_launches(model))
    inbn = sum(isinstance(m, InstanceBatchNorm) for m in model.modules())
    n["segment_sum"] += 6 * inbn
    n["gather_rows"] += 4 * inbn
    crf = dict.fromkeys(n, 0)
    if isinstance(model, Wrapper):  # the filter in the net's dtype
        groups = len(ops._tap_groups(model.filter.weight.shape[0]))
        sfx = "_bf16" if getattr(model.net, "dtype", None) == torch.bfloat16 else ""
        for name in ("gather_gemm", "scatter_gemm", "gather_wgrad"):
            crf[name + sfx] = model.filter.meanfield_iterations * groups
    return n, crf


def phase_semseg(app, model, batch, scenes, device, card, crf, steps=STEPS,
                 layout="chunked", base=None):
    """A semseg main path: the kernels-vs-plain step, ``steps`` counted
    SemsegTrainer steps (launches per step ``base``, by default
    ``expected_semseg_launches``), one evaluate_dataset pass in ``layout``
    over ``scenes`` (none for ``scenes=None``: the 4-D batch, which no
    3-D collation gives) and the eval outputs."""
    import numpy as np
    import torch

    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.semseg.train import (
        SemsegConfig,
        SemsegTrainer,
        evaluate_dataset,
        forward,
        make_semseg_train_step,
    )
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools import workload as W
    from pointcontrast_tpu_torch.train import optim

    static, extra = expected_semseg_launches(model)
    base = static if base is None else {**dict.fromkeys(static, 0), **base}
    net = model.net if crf else model
    say("model", app=app, name=type(net).__name__ + (" + BilateralCRF" if crf else ""),
        params=sum(p.numel() for p in model.parameters()), per_step=base,
        filter_per_step=extra)
    cfg = SemsegConfig(lr=0.1, momentum=0.9, weight_decay=1e-4, max_iter=60000,
                       stat_freq=1, save_freq=10 ** 9, wrapper_lr=0.1 if crf else None,
                       checkpoint_dir=os.path.join(BUILD_DIR, "smoke_semseg"))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    scales = {"filter": cfg.wrapper_lr / cfg.lr} if crf else None

    losses = {}
    for mode in ("plain", "kernels"):
        m = copy.deepcopy(model).to(device)
        opt = optim.make_optimizer(m, cfg, scales)
        sched = optim.make_scheduler(opt, cfg, cfg.scheduler)
        step = make_semseg_train_step(cfg)
        with W.plain_ops() if mode == "plain" else contextlib.nullcontext():
            losses[mode] = float(step(m, opt, sched, [batch])["loss"])
        del m, opt, sched
    if getattr(net, "dtype", None) == torch.bfloat16:
        valid0 = batch.pyramid.levels[0].valid
        gen = torch.Generator(device=device).manual_seed(6)
        ct = torch.randn(valid0.shape[0], W.SEMSEG_CLASSES, device=device,
                         generator=gen) * valid0[:, None]
        _bf16_parity(app, losses, model,
                     lambda m, x: forward(m, dataclasses.replace(batch, feats=x)),
                     batch.feats, ct, valid0 > 0, device)
    else:
        _check_step_parity(app, losses)

    # the main path: SemsegTrainer, counted launches
    trainer = SemsegTrainer(model, itertools.repeat(batch), None, cfg,
                            W.SEMSEG_CLASSES, device, crf=crf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    D.reset_launches()
    history = trainer.train(steps)
    torch.cuda.synchronize()
    counts = {**K.launch_counts(), **D.launch_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    coin = np.random.RandomState(0)  # the trainer's filter coin, replayed
    filtered = sum(coin.rand() < 0.5 for _ in range(steps)) if crf else 0
    want = {k: v * steps + extra[k] * filtered for k, v in base.items()}
    step_ms = [1e3 * m["step_time"] for _, m in history]
    for i, (_, m) in enumerate(history):
        say("step", app=app, iter=i + 1, loss=f"{m['loss']:.6f}", acc=f"{m['acc']:.4f}",
            lr=m["lr"], step_ms=f"{step_ms[i]:.1f}")
    loss_list = [m["loss"] for _, m in history]
    if len(loss_list) != steps or not all(map(math.isfinite, loss_list)):
        raise AssertionError(f"{app}: non-finite or missing losses: {loss_list}")
    if counts != want:
        raise AssertionError(f"{app}: launch counts {counts} != expected {want}")
    steady = statistics.median(step_ms[1:])
    say("slice", app=app, steps=steps, filtered_steps=filtered, launches=counts,
        ms_per_step=f"{steady:.1f}",
        scenes_per_s=f"{batch.pyramid.num_batch / (steady / 1e3):.2f}",
        first_step_ms=f"{step_ms[0]:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
        card=repr(card))

    t0 = time.perf_counter()
    if scenes is not None:
        miou, ious, acc, n = evaluate_dataset(trainer.model, scenes, W.semseg_scheme(),
                                              W.SEMSEG_CLASSES, device,
                                              batch_size=len(scenes), crf=crf,
                                              layout=layout)
        say("eval", app=app, scenes=n, miou=f"{miou:.4f}", acc=f"{acc:.4f}",
            seconds=f"{time.perf_counter() - t0:.1f}")
        if n != len(scenes) or not 0.0 <= miou <= 100.0:
            raise AssertionError(f"{app}: evaluate_dataset gave mIoU {miou} over {n} "
                                 "scenes")
    trainer.model.eval()
    with torch.no_grad():
        out = forward(trainer.model, batch)
    valid = batch.pyramid.levels[0].valid > 0
    if (tuple(out.shape) != (batch.feats.shape[0], W.SEMSEG_CLASSES)
            or not bool(torch.isfinite(out).all()) or bool(out[~valid].any())):
        raise AssertionError(f"{app}: bad logits {tuple(out.shape)}")
    say("output", app=app, shape=tuple(out.shape), valid_rows=int(valid.sum()))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    return counts


def semseg_paths(device, card, paths):
    """The seven semseg main paths on one batch (``semseg bf16``, ``semseg
    crf bf16`` and ``semseg hyper bf16``: the shipped YAML's dtype); adds
    each one's (kernel checks' numbers, launch counts) to ``paths``.
    Returns the scenes."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools import workload as W

    scenes, batch = make_semseg_batch(device)
    model = W.semseg_model(seed=0)
    backbone = conv_phase("semseg", conv_checks(model, batch), paths)
    paths["semseg"] = (backbone, phase_semseg("semseg", model, batch, scenes, device,
                                              card, None))
    del model
    # the shipped YAML's net.dtype: the same net in bf16 (the bf16 forms)
    model = W.semseg_model(seed=0, dtype=torch.bfloat16)
    backbone_bf16 = conv_phase("semseg bf16", conv_checks(model, batch), paths)
    paths["semseg bf16"] = (backbone_bf16, phase_semseg("semseg bf16", model, batch, scenes,
                                                         device, card, None))
    del model
    model = W.semseg_model(seed=0, model="ResUNet18INBN")
    res = conv_phase("semseg inbn", conv_checks(model, batch), paths)
    sparse, detect = inbn_checks(model, batch)
    for name, r in phase_kernels(sparse, K).items():
        add_numbers(res, name, r)
    res.update(phase_kernels(detect, D, exact=("gather_rows",)))
    paths["semseg inbn"] = (res, phase_semseg("semseg inbn", model, batch, scenes,
                                              device, card, None))
    del model
    res = phase_kernels(segment_sum_general_check(device), K)
    paths["segment_sum general"] = (res, {})  # no main path: S past SEG_SMEM
    model = W.semseg_model(seed=0, crf=W.SEMSEG_CRF)
    res = {}
    for name, r in backbone.items():  # the same Res16UNet34C at the same shapes
        add_numbers(res, name, r)
    crf_checks = [c for c in conv_checks(model, batch) if c[1].startswith("flat")]
    for name, r in phase_kernels(crf_checks, K).items():
        add_numbers(res, name, r)
    paths["semseg crf"] = (res, phase_semseg("semseg crf", model, batch, scenes,
                                             device, card, W.SEMSEG_CRF))
    del model
    # the shipped YAML's model in its BilateralCRF, bf16: the filter's flat
    # conv in the bf16 forms (each tap rounded; dF scatter_gemm_bf16)
    model = W.semseg_model(seed=0, crf=W.SEMSEG_CRF, dtype=torch.bfloat16)
    res = {}
    for name, r in backbone_bf16.items():  # the same bf16 net at the same shapes
        add_numbers(res, name, r)
    crf_checks = [c for c in conv_checks(model, batch) if c[1].startswith("flat")]
    for name, r in phase_kernels(crf_checks, K).items():
        add_numbers(res, name, r)
    paths["semseg crf bf16"] = (res, phase_semseg("semseg crf bf16", model, batch, scenes,
                                                  device, card, W.SEMSEG_CRF))
    del model
    model = W.semseg_model(seed=0, model="MinkUNetHyper14INBN")
    res = conv_phase("semseg hyper", conv_checks(model, batch), paths)
    sparse, detect = inbn_checks(model, batch)
    exp = model.BLOCK.expansion  # block5's output unpooled twice, block6's once
    sparse += pool_checks(batch.pyramid, [("unpool", 1, model.PLANES[4] * exp),
                                          ("unpool", 0, model.PLANES[4] * exp),
                                          ("unpool", 0, model.PLANES[5] * exp)])
    for name, r in phase_kernels(sparse, K, exact=("gather_sum",)).items():
        add_numbers(res, name, r)
    res.update(phase_kernels(detect, D, exact=("gather_rows",)))
    paths["semseg hyper"] = (res, phase_semseg("semseg hyper", model, batch, scenes,
                                               device, card, None))
    del model
    # in bf16: the unpools' gather_sum_bf16 and, through the levels' down
    # maps, scatter_sum_bf16 (every add rounded, in ascending fine row)
    model = W.semseg_model(seed=0, model="MinkUNetHyper14INBN", dtype=torch.bfloat16)
    res = conv_phase("semseg hyper bf16", conv_checks(model, batch), paths)
    sparse, detect = inbn_checks(model, batch)
    sparse += pool_checks(batch.pyramid, [("unpool", 1, model.PLANES[4] * exp),
                                          ("unpool", 0, model.PLANES[4] * exp),
                                          ("unpool", 0, model.PLANES[5] * exp)],
                          dtype=torch.bfloat16)
    for name, r in phase_kernels(sparse, K).items():
        add_numbers(res, name, r)
    res.update(phase_kernels(detect, D, exact=("gather_rows",)))
    paths["semseg hyper bf16"] = (res, phase_semseg("semseg hyper bf16", model, batch,
                                                    scenes, device, card, None))
    return scenes


def pool_checks(pyramid, specs, dtype=None):
    """[(kernel, label, fn, args)]: gather_sum and its adjoint scatter_sum
    at each of ``specs``, (op, level, channels): "sum pool" is the k2s2 sum
    pool from ``level`` to ``level + 1`` through ``down_nbr`` (8 taps),
    "unpool" the average unpool from ``level + 1`` to ``level`` through
    ``up_parent`` (1 tap); random features and cotangents masked as the rows
    they stand for, the source's pad row left out of the scatter as the ops
    leave it.  A flat (voxel) pyramid is one chunk, as the ops take it.
    ``dtype=torch.bfloat16``: the bf16 forms as the ops call them (a chunked
    sum rounding every add, a flat one once; the unpool's adjoint through
    the level's down map)."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K

    lv = pyramid.levels
    flat = lv[0].up_parent.dim() == 1
    nb = 1 if flat else pyramid.num_batch
    gen = torch.Generator(device=lv[0].valid.device).manual_seed(5)
    s = [int(l.valid.shape[0]) // nb for l in lv]
    bf16 = dtype == torch.bfloat16
    checks = []
    for op, l, c in specs:
        down = lv[l].down_nbr[:, None] if flat else lv[l].down_nbr
        extra, inverse = (), ()
        if op == "sum pool":
            m, src, dst, taps = down, l, l + 1, list(range(8))
            extra = (not flat,) if bf16 else ()
        else:
            m, src, dst, taps = lv[l].up_parent.reshape(1, nb, -1), l + 1, l, [0]
            inverse = (down,) if bf16 else ()
        f = _masked_randn((nb, s[src], c), lv[src].valid, gen).to(dtype)
        ct = _masked_randn((nb, s[dst], c), lv[dst].valid, gen).to(dtype)
        tag = f"{op} L{src}->L{dst} S{s[src]}->S{s[dst]} C{c}"
        sfx = "_bf16" if bf16 else ""
        checks += [
            (f"gather_sum{sfx}", f"{tag} fwd", getattr(K, f"gather_sum{sfx}"),
             (f, m, taps, 0, s[dst], *extra)),
            (f"scatter_sum{sfx}", f"{tag} bwd", getattr(K, f"scatter_sum{sfx}"),
             (ct, m, taps, 0, s[src], s[src] - 1, *inverse)),
        ]
    return checks


def probe_checks(device):
    """gather_sum at the Pallas gather probes' own shapes (``PROBES``): a
    random [1, N, C] table and a random [K, 1, M] index."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K

    gen = torch.Generator(device=device).manual_seed(0)
    checks = []
    for label, (k, n, c, m) in PROBES.items():
        table = torch.randn(1, n, c, device=device, generator=gen)
        idx = torch.randint(0, n, (k, 1, m), device=device, generator=gen,
                            dtype=torch.int32)
        checks.append(("gather_sum", label, K.gather_sum,
                       (table, idx, list(range(k)), 0, m)))
    return checks


def _worst_gap(got, mode="kernels", skip=()) -> tuple:
    """(the worst ratio, [(tensor, error, reference)] by ratio, worst
    first) of ``got[mode]``'s tensors against ``got["plain"]``'s: each one's
    max error over its largest magnitude, the tensors in ``skip`` left
    out."""
    gaps = []
    for name, want in got["plain"].items():
        if name in skip:
            continue
        err = float((got[mode][name].float() - want.float()).abs().max())
        ref = float(want.float().abs().max())
        gaps.append((err / ref if ref else 0.0, name, err, ref))
    gaps.sort(reverse=True)
    return (gaps[0][0] if gaps else 0.0), [g[1:] for g in gaps]


def _l2_gap(got, mode="kernels", skip=()) -> float:
    """The relative L2 distance of ``got[mode]``'s tensors, taken as one
    vector, from ``got["plain"]``'s (those in ``skip`` left out), in f64."""
    num = den = 0.0
    for name, want in got["plain"].items():
        if name not in skip:
            num += float((got[mode][name].double() - want.double()).square().sum())
            den += float(want.double().square().sum())
    return math.sqrt(num / den) if den else 0.0


def _compare_runs(app, got, rtol=RTOL, skip=()):
    """Hold the kernel run's tensors to the plain run's: each one's max
    error within ``rtol`` of its largest magnitude (those in ``skip`` left
    out).  Returns the worst ratio."""
    worst, gaps = _worst_gap(got, skip=skip)
    failures = [(n, e, r) for n, e, r in gaps if not e <= rtol * r]
    if failures:
        raise AssertionError(f"{app}: kernels differ from the plain twins: "
                             f"{failures[:5]}")
    return worst


def _kernels_vs_plain(model, x, ct, run, device, modes=("kernels", "plain")):
    """{mode: tensors} of ``run(model, x)`` in train mode for each of
    ``modes`` (MODE_SWAPS; "kernels" and "plain" first): the output (a
    forward through the kernels, and one through the plain twins, under
    "output" of those two), and the gradients of the input and every
    parameter from ``ct`` (in the output's dtype), backpropagated once a
    mode through one forward of the kernels.  Every backward pass sees the
    same ReLU gates: two forwards that differ in the last bit open or
    shut the few gates whose inputs sit within rounding of zero, and each
    such gate moves the parameter gradients by ~1e-3 of their largest
    magnitude, whichever forward is right.  ``_ulp_spread`` reads that
    spread on the card from the plain twins alone."""
    import torch

    from pointcontrast_tpu_torch.tools.workload import plain_ops

    m = copy.deepcopy(model).to(device).train()
    x = x.detach().clone().requires_grad_(x.is_floating_point())
    with plain_ops(), torch.no_grad():
        out_plain = run(m, x)
    out = run(m, x)
    ct = ct.to(out.dtype)
    got = {}
    for i, mode in enumerate(modes):
        m.zero_grad(set_to_none=True)
        x.grad = None
        with _mode(mode):
            out.backward(ct, retain_graph=i < len(modes) - 1)
        torch.cuda.synchronize()
        got[mode] = {n: p.grad.clone() for n, p in m.named_parameters()}
        if x.grad is not None:
            got[mode]["input"] = x.grad.clone()
    got["kernels"]["output"], got["plain"]["output"] = out.detach(), out_plain
    return got


def _ulp_spread(model, x, ct, run, device):
    """The witness for ``_kernels_vs_plain``'s form: three train-mode
    forward + backward passes through the plain twins alone, from the same
    weights and cotangent, on ``x``, on ``x`` again, and on ``x`` moved one
    ulp up at every nonzero entry.  Returns {"same": r, "ulp": r} for the
    second and third pass against the first, r = (the output's max error
    over its largest magnitude, the worst such ratio over the parameter
    gradients, ReLU gates that flipped, ReLU gates in all)."""
    import torch

    from pointcontrast_tpu_torch.nn import resnet, resnet_block
    from pointcontrast_tpu_torch.tools.workload import plain_ops

    gates = []

    def relu(f):
        gates[-1].append(f > 0)
        return torch.relu(f)

    mods = (resnet, resnet_block)
    saved = [mod.relu for mod in mods]
    up = torch.where(x != 0, torch.nextafter(x, torch.full_like(x, math.inf)), x)
    runs = []
    try:
        for mod in mods:
            mod.relu = relu
        for xi in (x, x, up):
            m = copy.deepcopy(model).to(device).train()
            gates.append([])
            with plain_ops():
                out = run(m, xi)
                out.backward(ct)
            runs.append({"output": out.detach(),
                         **{n: p.grad for n, p in m.named_parameters()}})
            del m, out
    finally:
        for mod, fn in zip(mods, saved):
            mod.relu = fn

    def rel(a, b):
        ref = float(a.abs().max())
        return float((b - a).abs().max()) / ref if ref else 0.0

    spread = {}
    for key, i in (("same", 1), ("ulp", 2)):
        grads = max(rel(runs[0][n], runs[i][n]) for n in runs[0] if n != "output")
        flipped = sum(int((a != b).sum()) for a, b in zip(gates[0], gates[i]))
        spread[key] = (rel(runs[0]["output"], runs[i]["output"]), grads, flipped,
                       sum(g.numel() for g in gates[0]))
    return spread


def _resnet_ct(batch, device):
    """The ResNet paths' seeded cotangent of the logits, zero at pad rows."""
    import torch

    from pointcontrast_tpu_torch.tools import workload as W

    valid = batch.pyramid.levels[-1].valid
    gen = torch.Generator(device=device).manual_seed(6)
    return torch.randn(valid.shape[0], W.SEMSEG_CLASSES, device=device,
                       generator=gen) * valid[:, None]


def phase_resnet(app, model, batch, device, card):
    """A ResNet main path on the ResNet workload: one forward + backward
    with a fixed seeded cotangent through the kernels against the plain
    twins (``_kernels_vs_plain``: the output and every parameter gradient
    within RTOL of its largest magnitude; scatter_gemm adds with atomics),
    then RESNET_STEPS SGD steps with finite losses and the expected launch
    count of every kernel, and the eval logits.  A bf16 model
    (``model.dtype``): one SGD step through the kernels against the plain
    twins (the loss to BF16_LOSS_RTOL, the forward's logits to cosine
    BF16_COS_MIN, or BF16_STEP_LIMITS, beside the plain twins' spread
    under reversed tap sums, as the bf16 semseg paths), and the input and
    parameter gradients from one forward of the kernels, backpropagated
    through the kernels and through the plain twins, within
    BF16_GRAD_LIMITS (beside the reversed twins' spread; ``_bf16_parity``),
    in place of the f32 tolerances and the ulp spread."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.semseg.train import SemsegConfig
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools import workload as W
    from pointcontrast_tpu_torch.train import optim

    expect = expected_launches(model)
    say("model", app=app, name=type(model).__name__,
        params=sum(p.numel() for p in model.parameters()), per_step=expect)
    valid = batch.pyramid.levels[-1].valid
    ct = _resnet_ct(batch, device)

    def run(m, x):
        return m(x, batch.pyramid)

    cfg = SemsegConfig(lr=0.1, momentum=0.9, weight_decay=1e-4, max_iter=60000)
    if getattr(model, "dtype", None) == torch.bfloat16:
        losses = {}
        for mode in ("plain", "kernels"):
            m = copy.deepcopy(model).to(device)
            opt = optim.make_optimizer(m, cfg)
            sched = optim.make_scheduler(opt, cfg, cfg.scheduler)
            with W.plain_ops() if mode == "plain" else contextlib.nullcontext():
                losses[mode] = float(W.resnet_step(m, opt, sched, batch))
            del m, opt, sched
        _bf16_parity(app, losses, model, run, batch.feats, ct, valid > 0, device)
    else:
        got = _kernels_vs_plain(model, batch.feats, ct, run, device)
        worst = _compare_runs(app, got)
        say("parity", app=app, tensors=len(got["plain"]), worst_rel=f"{worst:.2e}",
            rtol=RTOL)
        del got
        for key, (out_rel, grad_rel, flipped, gates) in _ulp_spread(
                model, batch.feats, ct, run, device).items():
            say("spread", app=app, input=key, output_rel=f"{out_rel:.2e}",
                worst_grad_rel=f"{grad_rel:.2e}", relu_flipped=flipped, relu_gates=gates)

    m = copy.deepcopy(model).to(device)
    opt = optim.make_optimizer(m, cfg)
    sched = optim.make_scheduler(opt, cfg, cfg.scheduler)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    D.reset_launches()
    losses, step_ms = [], []
    for i in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(float(W.resnet_step(m, opt, sched, batch)))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        say("step", app=app, iter=i + 1, loss=f"{losses[-1]:.6f}",
            step_ms=f"{step_ms[-1]:.1f}")
    torch.cuda.synchronize()
    counts = {**K.launch_counts(), **D.launch_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict.fromkeys(counts, 0)
    want.update({k: v * RESNET_STEPS for k, v in expect.items()})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{app}: non-finite losses: {losses}")
    if counts != want:
        raise AssertionError(f"{app}: launch counts {counts} != expected {want}")
    steady = statistics.median(step_ms[1:])
    say("slice", app=app, steps=RESNET_STEPS, launches=counts,
        ms_per_step=f"{steady:.1f}",
        scenes_per_s=f"{batch.num_samples / (steady / 1e3):.2f}",
        first_step_ms=f"{step_ms[0]:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
        card=repr(card))
    m.eval()
    with torch.no_grad():
        out = m(batch.feats, batch.pyramid)
    if (tuple(out.shape) != (valid.shape[0], W.SEMSEG_CLASSES)
            or not bool(torch.isfinite(out).all()) or bool(out[valid == 0].any())):
        raise AssertionError(f"{app}: bad logits {tuple(out.shape)}")
    say("output", app=app, shape=tuple(out.shape), valid_rows=int(valid.sum()))
    return counts


def phase_se_blocks(batch, device):
    """SEBasicBlock(128 -> 128) and SEBottleneck(128 -> 32 x 4) at level 1
    of ``batch``: one forward + backward with a seeded cotangent through
    the kernels against the plain twins (``_kernels_vs_plain``: output,
    input gradient and every parameter gradient within RTOL of its largest
    magnitude)."""
    import torch

    from pointcontrast_tpu_torch.nn.senet_block import SEBasicBlock, SEBottleneck

    lv, nb = batch.pyramid.levels[1], batch.pyramid.num_batch
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(lv.valid.shape[0], 128, device=device, generator=gen) * lv.valid[:, None]
    ct = torch.randn(x.shape, device=device, generator=gen) * lv.valid[:, None]

    def run(block, x):
        return block(x, lv.nbr, lv.valid, lv.rev, lv.batch, nb)

    for cls, planes in ((SEBasicBlock, 128), (SEBottleneck, 32)):
        block = cls(128, planes, 27, 0.02, generator=torch.Generator().manual_seed(0))
        got = _kernels_vs_plain(block, x, ct, run, device)
        worst = _compare_runs(cls.__name__, got)
        say("se", block=cls.__name__, rows=int(lv.valid.sum()), channels=128,
            tensors=len(got["plain"]), worst_rel=f"{worst:.2e}", rtol=RTOL)


def resnet_paths(device, card, paths, scenes):
    """The ResNet18 and ResNet50 main paths on the ResNet workload's batch
    (the semseg workload's ``scenes``), in f32 and in bf16 (K4 and the sum
    pool in their bf16 forms); adds each one's (kernel checks' numbers,
    launch counts) to ``paths``; then the SE blocks."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools import workload as W

    t0 = time.perf_counter()
    host = W.resnet_batch(scenes)
    batch = host.to(device)
    pyr = batch.pyramid
    nb = pyr.num_batch
    say("data", app="resnet", seconds=f"{time.perf_counter() - t0:.1f}", chunks=nb,
        chunk_rows=[int(l.valid.shape[0]) // nb for l in pyr.levels],
        valid_rows=[int(l.valid.sum()) for l in pyr.levels],
        truncated=host.truncated_voxels,
        labelled_rows=int((batch.labels != 255).sum()))
    for name, dtype in itertools.product(("ResNet18", "ResNet50"), (None, torch.bfloat16)):
        model = W.resnet_model(seed=0, model=name, dtype=dtype)
        res = phase_kernels(conv_checks(model, batch), K)
        pools = pool_checks(pyr, [("sum pool", 0, model.INIT_DIM)], dtype=dtype)
        for kernel, r in phase_kernels(pools, K, exact=("gather_sum",)).items():
            add_numbers(res, kernel, r)
        app = name.lower() + ("" if dtype is None else " bf16")
        paths[app] = (res, phase_resnet(app, model, batch, device, card))
        del model
    phase_se_blocks(batch, device)


def phase_cli_semseg(model=None, layout=None, shipped_dtype=False, wrapper=None):
    """``apps.semseg.main`` on the card with the shipped config on
    ``SyntheticSemsegDataset`` and ``net.dtype=float32`` (the YAML's
    ``bfloat16`` with ``shipped_dtype``; and ``net.model=<model>``,
    ``data.layout=<layout>``, ``net.wrapper_type=<wrapper>`` when given): 3
    steps, one whole-split validation, a checkpoint; a second call resumes
    from it and has nothing left to train.  (The CRF's coin skips the
    filter in those 3 steps; the validation runs it: its forward.)"""
    import torch

    from pointcontrast_tpu_torch.apps import semseg as app
    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.sparse import kernels as K

    out = os.path.join(BUILD_DIR, "smoke_cli_semseg")
    shutil.rmtree(out, ignore_errors=True)
    args = ["data.dataset=SyntheticSemsegDataset",
            "optimizer.max_iter=3", "train.stat_freq=1", "train.val_freq=3",
            "train.save_freq=1000", f"train.out_dir={out}",
            "distributed.num_devices=1"] + ([f"net.model={model}"] if model else [])
    args += [f"data.layout={layout}"] if layout else []
    args += [f"net.wrapper_type={wrapper}"] if wrapper else []
    args += [] if shipped_dtype else ["net.dtype=float32"]
    sfx = "_bf16" if shipped_dtype else ""
    needed = [f"gather_gemm{sfx}", f"gather_wgrad{sfx}", f"parent_gemm{sfx}"]
    if model == "MinkUNetHyper14INBN":
        needed += [f"gather_sum{sfx}", f"scatter_sum{sfx}", "segment_sum"]
    if layout and layout.startswith("brick"):
        needed += [f"brick_gemm{sfx}", f"brick_wgrad{sfx}", f"gather_sum{sfx}",
                   f"scatter_sum{sfx}"]
    t0 = time.perf_counter()
    K.reset_launches()
    trainer, history = app.main(args)
    torch.cuda.synchronize()
    first = K.launch_counts()
    seconds = time.perf_counter() - t0
    ckpt = os.path.join(out, "weights", "checkpoint_3.pth")
    if (trainer.curr_iter != 3 or len(history) != 3 or not os.path.exists(ckpt)
            or trainer.device.type != "cuda" or not 0.0 <= trainer.best_miou <= 100.0):
        raise AssertionError("the semseg CLI run did not train, validate, save "
                             "and stay on the card")
    net = trainer.model.net if wrapper else trainer.model
    if (model and type(net).__name__ != model) or (
            wrapper and type(trainer.model).__name__ != wrapper):
        raise AssertionError(f"the semseg CLI trained {type(trainer.model).__name__}")
    if layout and trainer.layout != layout:
        raise AssertionError(f"the semseg CLI ran layout {trainer.layout}")
    if shipped_dtype and net.dtype != torch.bfloat16:
        raise AssertionError("the semseg CLI did not run the shipped bf16")
    if not all(first[k] for k in needed):
        raise AssertionError(f"the semseg CLI run missed a kernel: {first}")
    K.reset_launches()
    resumed, again = app.main(args)
    if resumed.curr_iter != 3 or again or any(K.launch_counts().values()):
        raise AssertionError("the resumed semseg CLI run trained again")
    say("cli", app="semseg", model=type(trainer.model).__name__, layout=trainer.layout,
        dtype=net.dtype,
        seconds=f"{seconds:.1f}", iters=trainer.curr_iter,
        best_miou=f"{trainer.best_miou:.4f}", launches=first,
        checkpoint=os.path.relpath(ckpt, ROOT), resumed_iter=resumed.curr_iter)
    shutil.rmtree(out, ignore_errors=True)


def brick_k5_checks(pyramid, feats, dtype=None):
    """The brick conv with a k = 5 plan (125 taps, ``conv1_kernel_size=5``,
    which no counted path runs) on level 0 of a brick pyramid: brick_gemm
    on the batch's input features (Cin 3 -> 32) and, with W[rev]^T, on a
    cotangent masked as the output, and brick_wgrad, random weights;
    ``dtype=bfloat16``: the bf16 forms on the bf16 casts (the stem's Cin =
    3 zero-filled to the mma's k16)."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.sparse.brick import _tap_reversal, build_plan, slot_steps

    bm, valid = pyramid.levels[0].nbr, pyramid.levels[0].valid
    plan = build_plan(5)
    steps, rev = slot_steps(plan), list(_tap_reversal(plan))
    gen = torch.Generator(device=feats.device).manual_seed(5)
    cin, cout = feats.shape[1], 32
    w = torch.randn(plan.num_taps, cin, cout, device=feats.device, generator=gen)
    w *= (2.0 / (plan.num_taps * cin)) ** 0.5
    ct = _masked_randn((1, feats.shape[0], cout), valid, gen)[0]
    sfx = "" if dtype is None else "_bf16"
    if dtype is not None:
        feats, w, ct = feats.to(dtype), w.to(dtype), ct.to(dtype)
    gemm, wgrad = getattr(K, f"brick_gemm{sfx}"), getattr(K, f"brick_wgrad{sfx}")
    tag = f"NB{bm.nbr.shape[1]} {plan.num_taps} taps {cin}->{cout}"
    return [(f"brick_gemm{sfx}", f"brick k5 fwd {tag}", gemm,
             (feats, bm.nbr, steps, w, valid, bm.order)),
            (f"brick_gemm{sfx}", f"brick k5 dF {tag}", gemm,
             (ct, bm.nbr, steps, w[rev].transpose(1, 2).contiguous(), valid, bm.order)),
            (f"brick_wgrad{sfx}", f"brick k5 dW {tag}", wgrad,
             (feats, bm.nbr, steps, ct, plan.num_taps, valid, bm.order))]


def pretrain_path(layout, device, card, paths, dtype=None):
    """The pretraining main path in ``layout`` ('chunked', 'voxel' or
    'brick:2'): its batches, every kernel at the shapes of one real
    forward against its twin, the kernels-vs-plain step and STEPS counted
    PretrainTrainer steps (launches from the forward's conv calls; the
    chunked and voxel layouts' must equal the model's ``expected_launches``:
    the same kernels, 0 scatter_gemm).  ``dtype=torch.bfloat16``: the
    ``pretrain bf16`` path (chunked), the bf16 forms at the bf16 forward's
    shapes, the stem's Cin = 3 among them."""
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools.workload import pretrain_model

    batches = make_batches(device, layout=layout)
    model = pretrain_model(seed=0, dtype=dtype)
    b = batches[0]
    calls = conv_calls(model, b.feats0, lambda m: m(b.feats0, b.pyramid0))
    expect = expected_from_calls(calls)
    if layout in ("chunked", "voxel") and expect != expected_launches(model):
        raise AssertionError(f"pretrain {layout}: {expect} != the model's "
                             f"{expected_launches(model)}")
    # the brick adjoints name each kept row once: exact, as the gathers
    exact = ("gather_sum", "scatter_sum") if layout.startswith("brick") else ("gather_sum",)
    app = "pretrain" if layout == "chunked" else f"pretrain {layout}"
    app += "" if dtype is None else " bf16"
    res = conv_phase(app, conv_checks(model, None, calls=calls), paths, exact=exact)
    del calls  # the forward's activations: out of the path's peak memory
    if layout.startswith("brick"):  # no main path: the k = 5 stem's plan
        k5 = "brick k5 shapes" + app.removeprefix(f"pretrain {layout}")
        paths[k5] = (phase_kernels(brick_k5_checks(b.pyramid0, b.feats0, dtype), K), {})
    paths[app] = (res, phase_slice(batches, device, card, app=app, expect=expect,
                                   dtype=dtype))


def pretrain_hardest_paths(device, card, paths):
    """The shipped pretraining trainer (configs/pretrain_default.yaml's
    HardestContrastiveLossTrainer) on the chunked layout: its batches (the
    ``pretrain`` path's scenes collated with ``mode="hardest"``: 4096
    positives and 1024 candidates a frame, bounds-checked), then ``pretrain
    hardest`` (f32) and ``pretrain hardest bf16``: the kernels-vs-plain
    step with the hardest negatives replayed and STEPS counted steps, whose
    launches must equal the NCE paths' ``expected_launches``.  The
    networks and shapes are those of ``pretrain`` and ``pretrain bf16``,
    whose checks hold each kernel against its twin: in the kernels line
    these paths name them (``checks_from``) beside their launches."""
    import torch

    from pointcontrast_tpu_torch.tools.workload import pretrain_model

    batches = make_batches(device, mode="hardest")
    for dtype, nce in ((None, "pretrain"), (torch.bfloat16, "pretrain bf16")):
        app = nce.replace("pretrain", "pretrain hardest")
        expect = expected_launches(pretrain_model(seed=0, dtype=dtype))
        paths[app] = (nce, phase_slice(batches, device, card, app, expect,
                                       dtype=dtype, mode="hardest"))


def phase_cli_pretrain(card):
    """``apps.pretrain.main`` on the card with configs/pretrain_default.yaml
    as shipped (HardestContrastiveLossTrainer, Res16UNet34C 3 -> 32 in
    bf16, 4 pairs a batch, npad0 131072, chunked), overriding only
    ``data.dataset=SyntheticPairDataset``, ``misc.out_dir``,
    ``opt.max_iter`` and ``trainer.stat_freq``: 3 steps and a checkpoint,
    then a second call with ``opt.max_iter=5`` that resumes from it and
    takes 2 more; each call's launches must equal the bf16 model's
    ``expected_launches`` a step.  Prints the logged ``step_time`` and
    ``data_time`` of each step, and the host's seconds a batch for the
    samples (``__getitem__``) and for ``collate_pair`` alone."""
    import numpy as np
    import torch

    from pointcontrast_tpu_torch.apps import pretrain as app
    from pointcontrast_tpu_torch.config import load_config
    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools.workload import pretrain_model

    out = os.path.join(BUILD_DIR, "smoke_cli_pretrain")
    shutil.rmtree(out, ignore_errors=True)
    args = [app.DEFAULT_CONFIG, "data.dataset=SyntheticPairDataset", f"misc.out_dir={out}",
            "trainer.stat_freq=1"]
    expect = expected_launches(pretrain_model(seed=0, dtype=torch.bfloat16))
    runs = []
    for max_iter in (3, 5):
        t0 = time.perf_counter()
        K.reset_launches()
        trainer, history = app.main(args + [f"opt.max_iter={max_iter}"])
        torch.cuda.synchronize()
        counts = K.launch_counts()
        runs.append((trainer, history, counts, time.perf_counter() - t0))
    (first, h1, c1, s1), (resumed, h2, c2, s2) = runs
    ckpt = os.path.join(out, "weights", "checkpoint_3.pth")
    if ([i for i, _ in h1] != [1, 2, 3] or [i for i, _ in h2] != [4, 5]
            or not os.path.exists(ckpt) or first.device.type != "cuda"
            or first.config.mode != "hardest" or first.model.dtype != torch.bfloat16):
        raise AssertionError("the pretrain CLI did not train the shipped hardest bf16 "
                             "trainer on the card, save and resume")
    if c1 != {k: 3 * v for k, v in expect.items()} or c2 != {k: 2 * v for k, v in expect.items()}:
        raise AssertionError(f"the pretrain CLI's launches {c1} / {c2} != 3 / 2 x {expect}")
    losses = [m[k] for _, m in h1 + h2 for k in ("loss", "pos_loss", "neg_loss")]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"the pretrain CLI's losses: {losses}")
    for it, m in h1 + h2:
        say("cli step", app="pretrain", iter=it, loss=f"{m['loss']:.6f}",
            pos_loss=f"{m['pos_loss']:.6f}", neg_loss=f"{m['neg_loss']:.6f}",
            step_s=f"{m['step_time']:.4f}", data_s=f"{m['data_time']:.4f}",
            truncated=m["truncated_voxels"], card=repr(card))

    # the host's cost of a batch, alone: the loader's samples, then collation
    cfg = load_config(app.DEFAULT_CONFIG, args[1:])
    ds = app.build_dataset(cfg)
    scheme = PadScheme(npad0=cfg.data.npad0, level_ratios=tuple(cfg.data.pad_ratios))
    rng = np.random.RandomState(0)
    sample_s, collate_s = [], []
    for b in range(3):
        t0 = time.perf_counter()
        samples = [ds.__getitem__(4 * b + i, rng=np.random.RandomState(b * 4 + i))
                   for i in range(cfg.trainer.batch_size)]
        t1 = time.perf_counter()
        collate_pair(samples, scheme, mode="hardest", npos=cfg.misc.npos,
                     num_pos=cfg.trainer.num_pos_per_batch * cfg.trainer.batch_size,
                     num_hn=cfg.trainer.num_hn_samples_per_batch * cfg.trainer.batch_size,
                     rng=rng, layout=cfg.data.layout)
        sample_s.append(t1 - t0)
        collate_s.append(time.perf_counter() - t1)
    say("cli", app="pretrain", trainer=cfg.trainer.trainer, dtype=first.model.dtype,
        layout=cfg.data.layout, seconds=f"{s1:.1f}", resumed_seconds=f"{s2:.1f}",
        iters=first.curr_iter, resumed_iter=resumed.curr_iter, launches=c1,
        checkpoint=os.path.relpath(ckpt, ROOT),
        step_s_median=f"{statistics.median(m['step_time'] for _, m in h1[1:] + h2):.4f}",
        data_s_median=f"{statistics.median(m['data_time'] for _, m in h1[1:] + h2):.4f}",
        samples_s_per_batch=[f"{t:.3f}" for t in sample_s],
        collate_s_per_batch=[f"{t:.3f}" for t in collate_s],
        loader_workers=cfg.misc.num_workers, card=repr(card))
    shutil.rmtree(out, ignore_errors=True)


DDP_RANKS = 2


def _flat_params(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _ranks_bit_equal(model) -> bool:
    """Whether every rank holds the same parameter bits: the MAX and the MIN
    of their int32 views over the ranks agree everywhere."""
    import torch
    import torch.distributed as dist

    bits = _flat_params(model).view(torch.int32)
    hi, lo = bits.clone(), bits.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return torch.equal(hi, lo)


class _NoStep:
    """An optimizer and scheduler that only clear gradients: the averaged
    one-process reference takes each rank's gradient from the train step
    itself, then steps its real SGD once on their mean."""

    def __init__(self, model):
        self.params = list(model.parameters())

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


def _reference_steps(cfg, dtype, batches, device):
    """One process: each step runs every rank's batch through the train
    step for its gradient, sets the mean g0/2 + g1/2 (what DDP's all-reduce
    of two ranks computes, with one rounding) and steps SGD and ExpLR once.
    Yields the flat parameters after each step."""
    import torch

    from pointcontrast_tpu_torch.tools.workload import pretrain_model
    from pointcontrast_tpu_torch.train import make_train_step
    from pointcontrast_tpu_torch.train import optim

    model = pretrain_model(seed=0, dtype=dtype).to(device)
    opt = optim.make_optimizer(model, cfg)
    sched = optim.make_scheduler(opt, cfg)
    step, noop = make_train_step(cfg), _NoStep(model)
    while True:
        grads = []
        for b in batches:
            step(model, noop, noop, b)
            grads.append([p.grad for p in model.parameters()])
        for p, *gs in zip(model.parameters(), *grads):
            p.grad = gs[0] / 2 + gs[1] / 2
        opt.step()
        sched.step()
        yield _flat_params(model)


def _nondeterministic_ops(cfg, dtype, batch, device) -> list:
    """The ops of one train step that PyTorch names as nondeterministic
    (``use_deterministic_algorithms(warn_only=True)``'s warnings)."""
    import warnings

    import torch

    from pointcontrast_tpu_torch.tools.workload import pretrain_model
    from pointcontrast_tpu_torch.train import make_train_step

    model = pretrain_model(seed=0, dtype=dtype).to(device)
    noop = _NoStep(model)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            make_train_step(cfg)(model, noop, noop, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0] for w in caught
                   if "deterministic" in str(w.message)})


def ddp_rank(spec):
    """A rank of the ``ddp pretrain`` phase (``parallel.launch.run``): the
    shipped trainer's step (hardest, chunked, Res16UNet34C 3 -> 32) under
    DDP on this rank's batch, DDP_STEPS times per dtype, the ranks' bits
    compared after each step; rank 0 then runs the averaged one-process
    reference on both ranks' batches and compares each step's parameters
    bit for bit.  Returns, gathered on rank 0, each rank's launches, step
    times, losses and checks."""
    import torch
    import torch.distributed as dist

    from pointcontrast_tpu_torch.parallel import mesh, multihost
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools.workload import pretrain_model
    from pointcontrast_tpu_torch.train import PretrainConfig, PretrainTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rank, world, device = multihost.initialize(spec["device"], backend=spec["backend"])
    try:
        batches = [b.to(device) for b in spec["batches"]]
        out = {"rank": rank, "world": world, "backend": dist.get_backend(),
               "device": str(device)}
        for label, dtype in spec["dtypes"]:
            cfg = PretrainConfig(mode="hardest", lr=0.1, stat_freq=1,
                                 checkpoint_dir=os.path.join(spec["dir"], label))
            trainer = PretrainTrainer(pretrain_model(seed=0, dtype=dtype), [], cfg, device)
            r = {"net": type(trainer.net).__name__, "ms": [], "loss": [], "equal": []}
            snaps = []
            torch.cuda.synchronize(device)
            K.reset_launches()
            for _ in range(DDP_STEPS):
                t0 = time.perf_counter()
                m = trainer._step(trainer.net, trainer.opt, trainer.sched, batches[rank])
                torch.cuda.synchronize(device)
                r["ms"].append(1e3 * (time.perf_counter() - t0))
                r["loss"].append(float(mesh.mean_over_ranks({"loss": m["loss"]})["loss"]))
                r["equal"].append(_ranks_bit_equal(trainer.model))
                if rank == 0:
                    snaps.append(_flat_params(trainer.model).clone())
            r["launches"] = K.launch_counts()
            del trainer, m
            if rank == 0:
                ref = _reference_steps(cfg, dtype, batches, device)
                r["reference_equal"], r["max_abs_diff"] = [], []
                for snap in snaps:
                    got = next(ref)
                    r["reference_equal"].append(torch.equal(got, snap))
                    r["max_abs_diff"].append(float((got - snap).abs().max()))
                del ref, snaps
                if not all(r["reference_equal"]):
                    r["nondeterministic_ops"] = _nondeterministic_ops(
                        cfg, dtype, batches[0], device)
            torch.cuda.empty_cache()
            out[label] = r
        got = [None] * world
        dist.all_gather_object(got, out, group=multihost.host_group())
        return got
    finally:
        multihost.shutdown()


def phase_ddp_pretrain(card, paths, nccl=False):
    """``ddp pretrain``: DDP_RANKS ranks (``parallel.launch.run``) run the
    shipped trainer's step (hardest, chunked, Res16UNet34C 3 -> 32, 4 pairs
    a rank: workload.pretrain_batches(mode="hardest"), batch r on rank r)
    DDP_STEPS times in bf16 and in f32.  On one card the two ranks share
    ``cuda:0`` over gloo (NCCL refuses two ranks on one GPU); ``nccl``: one
    rank a card over NCCL.  Holds (a) the ranks' parameters bit-equal after
    every step, (b) rank 0's parameters after every step bit-equal to one
    process that averages the two batches' gradients before the same SGD
    step (the bound is 0: the kernels repeat bit for bit, and DDP's g0/2 +
    g1/2 of two ranks is the reference's one rounding; a miss prints the
    ops PyTorch names nondeterministic), and (c) each rank's launches a
    step equal to the model's ``expected_launches`` (those of ``pretrain
    hardest`` / ``pretrain hardest bf16``).  Prints each rank's step ms:
    on one card two ranks share it, so this is no scaling figure.  Adds
    the bf16 and f32 runs' launches (both ranks) to ``paths``."""
    import torch

    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.parallel import launch
    from pointcontrast_tpu_torch.tools.workload import pretrain_batches, pretrain_model

    app = "ddp pretrain" + (" nccl" if nccl else "")
    dtypes = (("bf16", torch.bfloat16), ("f32", None))
    t0 = time.perf_counter()
    spec = dict(batches=pretrain_batches(None, n_batches=DDP_RANKS, mode="hardest"),
                dtypes=dtypes, dir=os.path.join(BUILD_DIR, "smoke_ddp"),
                device="cuda" if nccl else "cuda:0", backend="nccl" if nccl else "gloo")
    torch.cuda.empty_cache()
    got = launch.run(DDP_RANKS, ddp_rank, (spec,), device="cuda")
    seconds = time.perf_counter() - t0
    shutil.rmtree(spec["dir"], ignore_errors=True)
    for label, dtype in dtypes:
        expect = expected_launches(pretrain_model(seed=0, dtype=dtype))
        hardest = paths.get("pretrain hardest" + (" bf16" if dtype else ""))
        if hardest is not None and hardest[1] != {k: STEPS * v for k, v in expect.items()}:
            raise AssertionError(f"{app} {label}: the pretrain hardest path's launches "
                                 f"{hardest[1]} are not {STEPS} x {expect}")
        want = {k: DDP_STEPS * v for k, v in expect.items()}
        r0 = got[0][label]
        for r in got:
            rr = r[label]
            if rr["net"] != "DistributedDataParallel" or r["backend"] != spec["backend"]:
                raise AssertionError(f"{app} {label}: rank {r['rank']} ran {rr['net']} "
                                     f"over {r['backend']}")
            if rr["launches"] != want:
                raise AssertionError(f"{app} {label}: rank {r['rank']}'s launches "
                                     f"{rr['launches']} != {DDP_STEPS} x {expect}")
            say("ddp step", app=app, dtype=label, rank=r["rank"], device=r["device"],
                backend=r["backend"], step_ms=[f"{t:.1f}" for t in rr["ms"]],
                loss=[f"{l:.6f}" for l in rr["loss"]], ranks_bit_equal=rr["equal"],
                note=("two ranks on one card, gloo: not a scaling figure" if not nccl
                      else "one rank a card, NCCL"), card=repr(card))
        if not all(math.isfinite(l) for l in r0["loss"]):
            raise AssertionError(f"{app} {label}: losses {r0['loss']}")
        say("ddp check", app=app, dtype=label, steps=DDP_STEPS,
            ranks_bit_equal=all(r[label]["equal"] == [True] * DDP_STEPS for r in got),
            reference_bit_equal=r0["reference_equal"],
            reference_max_abs_diff=r0["max_abs_diff"],
            bound="0 (DDP's g0/2 + g1/2 of 2 ranks is the reference's one rounding; "
                  "the kernels repeat bit for bit)",
            launches_per_rank_step=expect,
            nondeterministic_ops=r0.get("nondeterministic_ops", []))
        if not all(r[label]["equal"] == [True] * DDP_STEPS for r in got):
            raise AssertionError(f"{app} {label}: the ranks' parameters differ")
        if r0["reference_equal"] != [True] * DDP_STEPS:
            raise AssertionError(
                f"{app} {label}: DDP's update is not the averaged one-process update "
                f"(max abs diff {r0['max_abs_diff']}; ops PyTorch names "
                f"nondeterministic: {r0.get('nondeterministic_ops')})")
        paths[f"{app} {label}"] = ("pretrain bf16" if dtype else "pretrain", {
            k: sum(r[label]["launches"][k] for r in got) for k in want})
    say("ddp", app=app, ranks=DDP_RANKS, backend=spec["backend"],
        seconds=f"{seconds:.1f}", card=repr(card))


def ddp_phases(card, paths):
    """The ``ddp`` phase: ``ddp pretrain`` (two ranks sharing cuda:0 over
    gloo; over NCCL on two cards where there are two) and ``ddp cli``."""
    import torch

    phase_ddp_pretrain(card, paths)
    if torch.cuda.device_count() >= 2:
        phase_ddp_pretrain(card, paths, nccl=True)
    else:
        say("ddp pretrain nccl", run=False,
            reason=f"{torch.cuda.device_count()} card visible: NCCL needs a card a rank")
    phase_ddp_cli(card)


def phase_ddp_cli(card):
    """``ddp cli``: ``apps.pretrain.main`` on configs/pretrain_default.yaml
    as shipped (hardest, bf16, chunked) under a world of one over NCCL, as
    ``torchrun --nproc_per_node 1`` sets the environment (``RANK=0
    WORLD_SIZE=1``): 3 steps and a rank-0 checkpoint (the module's names,
    no ``module.``), then a resume to 5; launches as ``cli pretrain``'s.
    Then the DDP step's ms against the unwrapped step's, in turns (DDP,
    plain, plain, DDP; STEPS steps each) on one model and batch under the
    same world-1 NCCL group."""
    import itertools

    import torch
    import torch.distributed as dist

    from pointcontrast_tpu_torch.apps import pretrain as app
    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.parallel import launch, multihost
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools.workload import pretrain_model
    from pointcontrast_tpu_torch.train import PretrainConfig, PretrainTrainer

    out = os.path.join(BUILD_DIR, "smoke_ddp_cli")
    shutil.rmtree(out, ignore_errors=True)
    args = [app.DEFAULT_CONFIG, "data.dataset=SyntheticPairDataset", f"misc.out_dir={out}",
            "trainer.stat_freq=1"]
    expect = expected_launches(pretrain_model(seed=0, dtype=torch.bfloat16))
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1")
    os.environ.update(env, MASTER_PORT=str(launch.free_port()))
    backends, initialize = [], multihost.initialize

    def recording(*a, **kw):  # the backend each CLI call's group took
        joined = initialize(*a, **kw)
        backends.append(dist.get_backend())
        return joined

    multihost.initialize = recording
    try:
        runs = []
        for max_iter in (3, 5):
            K.reset_launches()
            trainer, history = app.main(args + [f"opt.max_iter={max_iter}"])
            torch.cuda.synchronize()
            runs.append((trainer, history, K.launch_counts()))
        multihost.initialize = initialize
        (first, h1, c1), (resumed, h2, c2) = runs
        if backends != ["nccl", "nccl"]:
            raise AssertionError(f"the DDP CLI's process groups took {backends}, not NCCL")
        ckpt = os.path.join(out, "weights", "checkpoint_3.pth")
        state = torch.load(ckpt, map_location="cpu")["model"]
        if ([i for i, _ in h1] != [1, 2, 3] or [i for i, _ in h2] != [4, 5]
                or type(first.net).__name__ != "DistributedDataParallel"
                or any(k.startswith("module.") for k in state)
                or first.model.dtype != torch.bfloat16 or dist.is_initialized()):
            raise AssertionError("the pretrain CLI did not train the shipped trainer under "
                                 "DDP at world 1, save rank 0's module and resume")
        if (c1 != {k: 3 * v for k, v in expect.items()}
                or c2 != {k: 2 * v for k, v in expect.items()}):
            raise AssertionError(f"the DDP CLI's launches {c1} / {c2} != 3 / 2 x {expect}")
        losses = [m["loss"] for _, m in h1 + h2]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"the DDP CLI's losses: {losses}")
        say("ddp cli", world=1, backend=backends[0], iters=[i for i, _ in h1 + h2],
            loss=[f"{l:.6f}" for l in losses], checkpoint=os.path.relpath(ckpt, ROOT),
            launches=c1, step_s=[f"{m['step_time']:.4f}" for _, m in h1 + h2],
            card=repr(card))
        del first, resumed, runs, state
        shutil.rmtree(out, ignore_errors=True)

        # the DDP step against the unwrapped one, in turns, world 1 over NCCL
        os.environ["MASTER_PORT"] = str(launch.free_port())
        _, _, device = multihost.initialize("cuda")
        backend = dist.get_backend()
        try:
            batches = make_batches(device, mode="hardest")
            cfg = PretrainConfig(mode="hardest", lr=0.1)
            trainer = PretrainTrainer(pretrain_model(seed=0, dtype=torch.bfloat16), [],
                                      cfg, device)
            feed = itertools.cycle(batches)
            ms = {"ddp": [], "plain": []}
            for turn in ("ddp", "plain", "plain", "ddp"):
                net = trainer.net if turn == "ddp" else trainer.model
                for _ in range(STEPS):
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    trainer._step(net, trainer.opt, trainer.sched, next(feed))
                    torch.cuda.synchronize(device)
                    ms[turn].append(1e3 * (time.perf_counter() - t0))
            # each turn's first step is a warm-up after the switch
            med = {k: statistics.median(v[1:STEPS] + v[STEPS + 1:]) for k, v in ms.items()}
            say("ddp step world1", backend=backend, dtype="bf16",
                ddp_ms=f"{med['ddp']:.2f}", unwrapped_ms=f"{med['plain']:.2f}",
                ratio=f"{med['ddp'] / med['plain']:.4f}",
                ddp_share=f"{1 - med['plain'] / med['ddp']:.4f}",
                ddp_ms_all=[f"{t:.1f}" for t in ms["ddp"]],
                unwrapped_ms_all=[f"{t:.1f}" for t in ms["plain"]], card=repr(card))
            del trainer, batches
        finally:
            multihost.shutdown()
    finally:
        multihost.initialize = initialize
        for k in (*env, "MASTER_PORT"):
            os.environ.pop(k, None)


def semseg_layout_paths(device, card, paths, scenes):
    """The semseg main paths in the voxel layout (Res16UNet34C 3 -> 20 in
    the BilateralCRF wrapper: the backbone's flat K1-K3 and the filter's
    flat conv) and in the brick layout (Res16UNet34C on ``brick``: two
    brick levels, then flat; ``semseg brick bf16``: the same net in bf16,
    the shipped YAML's dtype), on the workload's scenes: every kernel at
    the shapes of one real forward (and, on voxel, the flat pools' at a
    sum pool and two unpools), the kernels-vs-plain step and counted
    steps (STEPS with the CRF, whose coin first applies the filter at the
    fifth; LAYOUT_STEPS without), evaluate_dataset in the layout."""
    import torch

    from pointcontrast_tpu_torch.semseg.train import forward
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools import workload as W

    for layout, crf, dtype in (("voxel", W.SEMSEG_CRF, None), ("brick", None, None),
                               ("brick", None, torch.bfloat16)):
        _, batch = make_semseg_batch(device, scenes, layout, crf=crf is not None)
        model = W.semseg_model(seed=0, crf=crf, dtype=dtype)
        calls = conv_calls(model, batch.feats, lambda m: forward(m, batch))
        checks = conv_checks(model, batch, calls=calls)
        if layout == "voxel":  # the flat pools, which no counted path runs
            checks += pool_checks(batch.pyramid, [("sum pool", 0, 64),
                                                  ("unpool", 1, 128), ("unpool", 0, 96)])
        app = f"semseg {layout}" + (" bf16" if dtype else "")
        # the brick adjoints name each kept row once; the flat unpools' do not
        res = conv_phase(app, checks, paths, exact=("gather_sum",) + (
            ("scatter_sum",) if layout == "brick" else ()))
        base = None if crf else expected_from_calls(calls)
        del calls, checks
        paths[app] = (res, phase_semseg(app, model, batch, scenes, device, card, crf,
                                        steps=STEPS if crf else LAYOUT_STEPS, layout=layout,
                                        base=base))
        del model, batch


def _counted_pass(model, batch, run, ct, device):
    """{kernel: launches} of one train-mode forward ``run(m, feats)`` of a
    copy of ``model`` and its backward from ``ct``; raises unless the
    output and every parameter gradient are finite."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.sparse import kernels as K

    m = copy.deepcopy(model).to(device).train()
    torch.cuda.synchronize()
    K.reset_launches()
    D.reset_launches()
    out = run(m, batch.feats)
    out.backward(ct.to(out.dtype))
    torch.cuda.synchronize()
    counts = {**K.launch_counts(), **D.launch_counts()}
    if not (bool(torch.isfinite(out).all())
            and all(bool(torch.isfinite(p.grad).all()) for p in m.parameters())):
        raise AssertionError(f"{type(model).__name__}: non-finite output or gradients")
    return counts


def st_reduced_path(app, model, batch, device, card, paths, ct_level):
    """A 4-D net at reduced depth (``st`` phase): its kernels at the shapes
    of one real forward (K1 and the flat K4 in their tap groups; the
    ResNets' sum pool) against their twins; in f32 one forward + backward
    through the kernels against the plain twins (output and every
    parameter gradient within RTOL of its largest magnitude, from one
    saved forward, ``_kernels_vs_plain``); then one counted forward +
    backward whose launches must equal ``expected_from_calls`` (+ the sum
    pool's two).  A seeded cotangent at level ``ct_level``'s rows."""
    import torch

    from pointcontrast_tpu_torch.nn.resnet import ResNetBase
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools import workload as W

    valid = batch.pyramid.levels[ct_level].valid
    gen = torch.Generator(device=device).manual_seed(6)
    ct = torch.randn(valid.shape[0], W.SEMSEG_CLASSES, device=device,
                     generator=gen) * valid[:, None]

    def run(m, x):
        return m(x, batch.pyramid)

    calls = conv_calls(model, batch.feats, lambda m: run(m, batch.feats))
    checks = [c for c in conv_checks(model, batch, calls=calls)
              if not c[1].startswith("K3 parent ")]
    pooled = isinstance(model, ResNetBase)
    if pooled:
        checks += pool_checks(batch.pyramid, [("sum pool", 0, model.INIT_DIM)],
                              dtype=model.dtype)
    say("model", app=app, name=type(model).__name__, layers=model.LAYERS,
        params=sum(p.numel() for p in model.parameters()),
        taps=sorted({int(p.shape[0]) for p in model.parameters() if p.dim() == 3}))
    res = phase_kernels(checks, K, exact=("gather_sum",))
    if model.dtype is None:
        got = _kernels_vs_plain(model, batch.feats, ct, run, device)
        worst = _compare_runs(app, got)
        say("parity", app=app, tensors=len(got["plain"]), worst_rel=f"{worst:.2e}",
            rtol=RTOL)
        del got
    want = dict.fromkeys((fn.__name__ for fn in K.KERNELS), 0)
    want.update(expected_from_calls(calls))
    if pooled:
        sfx = "_bf16" if model.dtype == torch.bfloat16 else ""
        want[f"gather_sum{sfx}"] += 1
        want[f"scatter_sum{sfx}"] += 1
    counts = _counted_pass(model, batch, run, ct, device)
    got = {k: v for k, v in counts.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{app}: launch counts {got} != expected {want}")
    say("slice", app=app, launches=got, card=repr(card))
    paths[app] = (res, counts)


def st_paths(device, card, paths, scenes=None):
    """The 4-D spatio-temporal paths (the ``st`` phase) on the workload's
    4-D batch (``tools.workload.st_semseg_batch``): ``semseg st`` and
    ``semseg st bf16``, STRes16UNet34 3 -> 20 at full width (29-tap hybrid
    block convs: K1 in one launch; the 27-tap (3, 3, 3, 1) stem; 8-child
    strided convs), each kernel at one real forward's shapes against its
    twin (not K3's parent design, which no path runs), the kernels-vs-plain
    step, ST_STEPS counted SemsegTrainer steps
    (no evaluate_dataset: the 3-D collation has no 4-D form); at reduced
    depth ``semseg st tesseract`` (STResTesseract16UNet18A, one block a
    stage: its 81-tap stem and block convs run K1 in three groups; f32 and
    bf16) and ``semseg st resnet`` (STResNet14: the 81-tap k3s2 K4 in three
    groups) forward and backward against the twins (``st_reduced_path``);
    then the 3-D repair, ``semseg k5`` and ``semseg k5 bf16``: the chunked
    Res16UNet34C with ``conv1_kernel_size=5`` on the semseg ``scenes`` (its
    125-tap stem: K1 in four groups, the bf16 forward's f32 partials), the
    stem's checks beside the ``semseg`` paths' (same net, same shapes; all
    of its convs' when those paths did not run), the kernels-vs-plain step
    and LAYOUT_STEPS counted steps (no ``scenes``: no k5 paths)."""
    import torch

    from pointcontrast_tpu_torch.nn.registry import load_model
    from pointcontrast_tpu_torch.semseg.train import forward
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools import workload as W

    def st_batch(model):
        t0 = time.perf_counter()
        host = W.st_semseg_batch(model=model)
        batch = host.to(device)
        lv0 = host.pyramid.levels[0]
        n0, dropped = int(lv0.valid.sum()), float(host.truncated_voxels)
        say("data", app="semseg st", model=model, seconds=f"{time.perf_counter() - t0:.1f}",
            sequences=host.num_samples, frames=W.ST_FRAMES, shift=W.ST_SHIFT,
            rows=[int(l.valid.shape[0]) for l in host.pyramid.levels],
            valid_rows=[int(l.valid.sum()) for l in host.pyramid.levels],
            truncated=dropped, truncated_share=f"{dropped / (n0 + dropped):.2e}",
            taps={"block": lv0.nbr.shape[0],
                  "stem": (lv0.nbr if lv0.nbr0 is None else lv0.nbr0).shape[0],
                  "down": lv0.down_nbr.shape[0]})
        if dropped >= 0.01 * (n0 + dropped):
            raise AssertionError(f"the 4-D batch drops {dropped} voxels: 1% or more")
        return batch

    batch = st_batch("STRes16UNet34")
    for dtype in (None, torch.bfloat16):
        model = W.semseg_model(seed=0, model="STRes16UNet34", dtype=dtype)
        calls = conv_calls(model, batch.feats, lambda m: forward(m, batch))
        app = "semseg st" + (" bf16" if dtype else "")
        res = phase_kernels([c for c in conv_checks(model, batch, calls=calls)
                             if not c[1].startswith("K3 parent ")], K)
        base = expected_from_calls(calls)
        del calls
        paths[app] = (res, phase_semseg(app, model, batch, None, device, card, None,
                                        steps=ST_STEPS, base=base))
        del model
    del batch
    batch = st_batch("STResTesseract16UNet18A")
    tesseract = type("STResTesseract16UNet18A", (load_model("STResTesseract16UNet18A"),),
                     {"LAYERS": (1,) * 8})
    for dtype in (None, torch.bfloat16):
        model = tesseract(3, W.SEMSEG_CLASSES, bn_momentum=0.02, dtype=dtype,
                          generator=torch.Generator().manual_seed(0))
        st_reduced_path("semseg st tesseract" + (" bf16" if dtype else ""), model, batch,
                        device, card, paths, 0)
    del batch, model
    batch = st_batch("STResNet14")
    st_reduced_path("semseg st resnet", W.semseg_model(seed=0, model="STResNet14"),
                    batch, device, card, paths, -1)
    del batch
    if scenes is None:
        return
    t0 = time.perf_counter()
    batch = W.semseg_batch(scenes, conv0_kernel_size=5).to(device)
    say("data", app="semseg k5", seconds=f"{time.perf_counter() - t0:.1f}",
        stem_taps=batch.pyramid.levels[0].nbr0.shape[0])
    for dtype in (None, torch.bfloat16):
        app = "semseg k5" + (" bf16" if dtype else "")
        model = W.semseg_model(seed=0, dtype=dtype, conv1_kernel_size=5)
        calls = conv_calls(model, batch.feats, lambda m: forward(m, batch))
        checks = [c for c in conv_checks(model, batch, calls=calls)
                  if not c[1].startswith("K3 parent ")]
        shared = "semseg" + (" bf16" if dtype else "")
        if shared in paths:  # the same net past the stem, at the same shapes
            checks = [c for c in checks if "conv0p1s1" in c[1]]
        res = phase_kernels(checks, K)
        res = (shared, res) if shared in paths else res
        base = expected_from_calls(calls)
        del calls
        paths[app] = (res, phase_semseg(app, model, batch, None, device, card, None,
                                        steps=LAYOUT_STEPS, base=base))
        del model


def votenet_path(layout, device, card, paths, steps, dtype=None):
    """The sparse-conv VoteNet at the YAML's shapes on batches collated in
    ``layout`` ('chunked' or 'voxel'): the backbone's kernels at the shapes
    of one real forward and K6-K8 against their twins, the kernels-vs-plain
    step, ``steps`` counted steps and one evaluate.  ``dtype=bfloat16``:
    the ``votenet bf16`` path, the backbone in the YAML's bf16 (the bf16
    forms at its forward's shapes).  Returns the first batch's clouds
    [B, N, 3]."""
    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools.workload import votenet_model

    vb = make_votenet_batches(device, layout)
    model = votenet_model(seed=0, dtype=dtype)
    b = vb[0]
    calls = conv_calls(model.backbone_net.net, b.voxel_feats,
                       lambda m: m(b.voxel_feats, b.voxel_pyramid))
    app = "votenet" if layout == "chunked" else f"votenet {layout}"
    app += "" if dtype is None else " bf16"
    res = conv_phase(app, conv_checks(None, None, calls=calls), paths)
    del calls
    res.update(phase_kernels(
        detect_kernel_checks(b), D,
        exact=("furthest_point_sample", "ball_query", "gather_rows")))
    paths[app] = (res, phase_votenet(vb, device, card, model, app, steps=steps))
    return b.point_clouds[..., 0:3].contiguous()


def kernels_line(paths: dict) -> list:
    """The kernels line's entries from {main path: (its kernel checks'
    numbers, its launch counts)}: each path's own launches and numbers
    under ``paths``; at the top level all paths' launches and all their
    checks' numbers together.  A path whose checks are another path's (the
    hardest paths': the NCE paths' networks at the same shapes) names that
    path in place of its numbers; a path that shares another's checks and
    adds its own (``semseg k5``: ``semseg``'s net past the stem) gives
    ``(that path, its own numbers)``.  Its entries carry ``checks_from``
    and its own numbers only, and the top level adds each check once.  A
    kernel launched on a path but not checked at that path's shapes
    fails."""
    def numbers(r):
        return {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
                **{k: r[k] for k in OPTIONAL_MS}}

    def split(path):
        """(the path whose checks it borrows or None, its own checks)."""
        res = paths[path][0]
        if isinstance(res, str):
            return res, {}
        return res if isinstance(res, tuple) else (None, res)

    def checks(path):
        borrowed, own = split(path)
        return {**(paths[borrowed][0] if borrowed else {}), **own}

    def entry(path, name):
        borrowed, own = split(path)
        e = {"launches": paths[path][1].get(name, 0)}
        if borrowed is not None and name in paths[borrowed][0]:
            e["checks_from"] = borrowed
        return {**e, **numbers(own[name])} if name in own else e

    total = {}
    for path, (_, counts) in paths.items():
        unchecked = [n for n, c in counts.items() if c and n not in checks(path)]
        if unchecked:
            raise AssertionError(f"{path}: launched but not checked: {unchecked}")
        for name, r in split(path)[1].items():
            add_numbers(total, name, r)
    return [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": sum(counts.get(name, 0) for _, counts in paths.values()),
         **numbers(r),
         "paths": {path: entry(path, name) for path in paths if name in checks(path)}}
        for name, r in total.items()
    ]


def votenet_bf16_spread(seeds) -> int:
    """The bf16 VoteNet step's loss under summation order alone, the
    reading BF16_VOTENET_LOSS_RTOL is set from: for each seed (the weights'
    and the scenes') and each of its two batches, one step through the
    kernels (its FPS picks and ball-query groups recorded), the plain twins
    replaying them, the plain twins with gather_gemm_bf16's taps summed in
    reverse order replaying them, and the plain twins on their own picks.
    One ``[spread]`` line a batch (the losses' relative differences to the
    plain step), then a JSON line of their largest values."""
    import torch

    from pointcontrast_tpu_torch.cuda_build import BUILD_DIR
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.train import DetectConfig
    from pointcontrast_tpu_torch.tools.workload import votenet_batches, votenet_model

    card = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    dc = ScannetDatasetConfig()
    cfg = DetectConfig(checkpoint_dir=os.path.join(BUILD_DIR, "spread_votenet"))
    top = {"kernels": 0.0, "reversed": 0.0, "no_replay": 0.0}
    for seed in seeds:
        model = votenet_model(seed=seed, dtype=torch.bfloat16)
        for i, batch in enumerate(votenet_batches(device, seed=seed)):
            picks = []
            k = _votenet_step_outputs(model, dc, cfg, batch, device, plain=False,
                                      picks=picks)
            p = _votenet_step_outputs(model, dc, cfg, batch, device, plain=True,
                                      picks=picks)
            r = _votenet_step_outputs(model, dc, cfg, batch, device, plain=True,
                                      picks=picks, reverse=True)
            own = _votenet_step_outputs(model, dc, cfg, batch, device, plain=True)
            rel = {"kernels": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
                   "reversed": abs(r["loss"] - p["loss"]) / abs(p["loss"]),
                   "no_replay": abs(k["loss"] - own["loss"]) / abs(own["loss"])}
            for key, v in rel.items():
                top[key] = max(top[key], v)
            say("spread", seed=seed, batch=i, loss_plain=f"{p['loss']:.8f}",
                **{f"{key}_loss_rel": f"{v:.3e}" for key, v in rel.items()},
                no_replay_flipped={n: int((k["ints"][n] != v).sum())
                                   for n, v in own["ints"].items()}, card=card)
    print(json.dumps({"votenet_bf16_loss_rel_max": top, "seeds": list(seeds),
                      "rtol": BF16_VOTENET_LOSS_RTOL}), flush=True)
    return 0


def bf16_spread(label, cases, seeds, fwd_modes, bwd_modes) -> int:
    """A bf16 path under summation order alone, the readings its
    BF16_STEP_LIMITS and BF16_GRAD_LIMITS are set from, and the controls
    they must refuse: for each seed and each case ``cases(seed, device)``
    yields, (name, model, run, x, ct, valid, loss_of), the train-mode
    output and its loss in each of ``fwd_modes`` (MODE_SWAPS) against
    "plain" (``_mode_outputs``), and the input and parameter gradients from
    one forward of the kernels in each of ``bwd_modes`` ("kernels" first)
    against "plain" (``_kernels_vs_plain``: the worst ratio of
    ``_worst_gap`` and the relative L2 distance of ``_l2_gap``).  One
    ``[spread]`` line a case and seed, then a JSON line of the worst
    readings by case."""
    import torch

    card = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    worst = {}
    for seed in seeds:
        for name, model, run, x, ct, valid, loss_of in cases(seed, device):
            outs = _mode_outputs(model, lambda m: run(m, x), device, modes=("plain", *fwd_modes))
            loss = {k: float(loss_of(v)) for k, v in outs.items()}
            r = {}
            for mode in fwd_modes:
                r[f"{mode}_loss_rel"] = abs(loss[mode] - loss["plain"]) / abs(loss["plain"])
                r[f"{mode}_cosine"] = _agreement(outs[mode][valid], outs["plain"][valid])["cosine"]
            del outs
            got = _kernels_vs_plain(model, x, ct, run, device,
                                    modes=("kernels", "plain", *bwd_modes[1:]))
            worst_of = {}
            for mode in bwd_modes:
                r[f"{mode}_grad_rel"], gaps = _worst_gap(got, mode, skip=("output",))
                r[f"{mode}_grad_l2"] = _l2_gap(got, mode, skip=("output",))
                worst_of[mode] = gaps[0][0]
            del got
            top = worst.setdefault(name, {})
            for key, v in r.items():
                pick = min if key.endswith("cosine") else max
                top[key] = pick(top.get(key, v), v)
            say("spread", seed=seed, net=name, loss_plain=f"{loss['plain']:.8f}",
                **{k: f"{v:.7f}" if k.endswith("cosine") else f"{v:.3e}" for k, v in r.items()},
                worst_grad_of=worst_of, card=card)
            del model
    print(json.dumps({f"{label}_bf16_worst": worst, "seeds": list(seeds),
                      "limits": BF16_STEP_LIMITS, "grad_limits": BF16_GRAD_LIMITS}),
          flush=True)
    return 0


def resnet_bf16_spread(seeds) -> int:
    """``bf16_spread`` of ResNet18 and ResNet50 in bf16 on the ResNet
    workload's batch of each seed (the weights' and the scenes'): the
    logits' cross-entropy in the modes "kernels", "reversed" and "pertap",
    the gradients in "kernels", "reversed", "pertap_dF", "pertap_all" and
    "drop_tap"."""
    import torch

    from pointcontrast_tpu_torch.losses.semseg import cross_entropy_ignore
    from pointcontrast_tpu_torch.tools import workload as W

    def cases(seed, device):
        batch = W.resnet_batch(W.SemsegScenes(seed=seed), seed=seed).to(device)
        for name in ("ResNet18", "ResNet50"):
            yield (name, W.resnet_model(seed=seed, model=name, dtype=torch.bfloat16),
                   lambda m, x: m(x, batch.pyramid), batch.feats, _resnet_ct(batch, device),
                   batch.pyramid.levels[-1].valid > 0,
                   lambda out: cross_entropy_ignore(out, batch.labels, 255))

    return bf16_spread("resnet", cases, seeds, ("kernels", "reversed", "pertap"),
                       ("kernels", "reversed", "pertap_dF", "pertap_all", "drop_tap"))


def brick_bf16_spread(seeds) -> int:
    """``bf16_spread`` of the two brick bf16 paths on each seed's data and
    weights: ``pretrain brick:2 bf16`` (Res16UNet34C 3 -> 32 on the brick:2
    pretraining batch, its NCE loss) and ``semseg brick bf16``
    (Res16UNet34C 3 -> 20 on the semseg scenes in the brick layout, the
    cross-entropy), in the modes "kernels" and "reversed" (the plain twins
    with every bf16 GEMM's f32 sums in another order) against "plain",
    from the cotangents the paths' parity uses."""
    import torch

    from pointcontrast_tpu_torch.losses.contrastive import point_info_nce_loss
    from pointcontrast_tpu_torch.losses.semseg import cross_entropy_ignore
    from pointcontrast_tpu_torch.tools import workload as W
    from pointcontrast_tpu_torch.train import PretrainConfig

    def ct_for(valid, c, device):
        gen = torch.Generator(device=device).manual_seed(6)
        return torch.randn(valid.shape[0], c, device=device, generator=gen) * valid[:, None]

    def cases(seed, device):
        b = make_batches(device, layout="brick:2", seed=seed)[0]
        valid = b.pyramid0.levels[0].valid
        yield ("pretrain brick:2 bf16", W.pretrain_model(seed=seed, dtype=torch.bfloat16),
               lambda m, x: m(x, b.pyramid0), b.feats0, ct_for(valid, 32, device), valid > 0,
               lambda out: point_info_nce_loss(out, out, b.q_idx, b.k_idx, b.pair_valid,
                                               temperature=PretrainConfig().nce_t))
        _, batch = make_semseg_batch(device, W.SemsegScenes(seed=seed), "brick", crf=False)
        valid = batch.pyramid.levels[0].valid
        yield ("semseg brick bf16", W.semseg_model(seed=seed, dtype=torch.bfloat16),
               lambda m, x: m(x, batch.pyramid), batch.feats,
               ct_for(valid, W.SEMSEG_CLASSES, device), valid > 0,
               lambda out: cross_entropy_ignore(out, batch.labels, 255))

    return bf16_spread("brick", cases, seeds, ("kernels", "reversed"), ("kernels", "reversed"))


def _sweep_groups(constant, device):
    """{path: [checks]} a blocks sweep times: SCATTER_BLOCKS, the ResNets'
    K4 dF and the CRF's flat dF (scatter_gemm); WGRAD_BLOCKS, the
    tensor-core gather_wgrad_bf16 checks (a bf16 G) of the pretrain, semseg
    and VoteNet bf16 forwards."""
    import torch

    from pointcontrast_tpu_torch.tools import workload as W

    groups = {}
    if constant == "SCATTER_BLOCKS":
        scenes, batch = make_semseg_batch(device)
        model = W.semseg_model(seed=0, crf=W.SEMSEG_CRF)
        groups["semseg crf"] = [c for c in conv_checks(model, batch)
                                if c[1].startswith("flat dF")]
        del model, batch
        rbatch = W.resnet_batch(scenes).to(device)
        for name in ("ResNet18", "ResNet50"):
            model = W.resnet_model(seed=0, model=name)
            groups[name.lower()] = [c for c in conv_checks(model, rbatch)
                                    if c[1].startswith("K4 dF")]
            del model
        return groups
    bf = torch.bfloat16

    def mma(checks):
        return [c for c in checks if c[0] == "gather_wgrad_bf16" and c[3][4].dtype == bf]

    b = make_batches(device, n_batches=1)[0]
    model = W.pretrain_model(seed=0, dtype=bf)
    groups["pretrain bf16"] = mma(conv_checks(model, None, calls=conv_calls(
        model, b.feats0, lambda m: m(b.feats0, b.pyramid0))))
    _, batch = make_semseg_batch(device)
    groups["semseg bf16"] = mma(conv_checks(W.semseg_model(seed=0, dtype=bf), batch))
    vb = make_votenet_batches(device, "chunked")[0]
    net = W.votenet_model(seed=0, dtype=bf).backbone_net.net
    groups["votenet bf16"] = mma(conv_checks(None, None, calls=conv_calls(
        net, vb.voxel_feats, lambda m: m(vb.voxel_feats, vb.voxel_pyramid))))
    return groups


def blocks_sweep(constant, multiples) -> int:
    """A kernel's device ms with a block target of ``sparse.kernels`` at
    each of ``multiples`` of its unit: ``SCATTER_BLOCKS`` (the blocks below
    which scatter_gemm splits a tile's steps, in GEMM_BLOCKS) or
    ``WGRAD_BLOCKS`` (the blocks gather_wgrad aims its row slices at, in
    132 SMs; timed on the tensor-core gather_wgrad_bf16), summed over each
    path's checks (``_sweep_groups``), each held at every setting to its
    plain twin (scatter_gemm) or to its bound (gather_wgrad_bf16).  Two
    rounds, the list and then the list reversed; one ``[sweep]`` line a
    setting, path and round, and a JSON line of {path: {multiple: [device
    ms of each round]}}."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K

    phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    groups = _sweep_groups(constant, device)
    unit = K.GEMM_BLOCKS if constant == "SCATTER_BLOCKS" else 132

    def check(label, fn, args, m):
        got = fn(*args)
        if constant == "SCATTER_BLOCKS":
            err, ref = _max_err(got, K.scatter_gemm_plain(*args))
            ok, what = err <= ATOL + RTOL * ref, f"{err:.3e} of {ref:.3e}"
        else:
            ratio = K.bound_ratio(got, *K.gather_wgrad_bf16_bound(*args))
            ok, what = ratio <= 1.0, f"bound ratio {ratio:.3e}"
        if not ok:
            raise AssertionError(f"{label} at {m}x: {what}")

    saved = getattr(K, constant)
    table = {path: {m: [] for m in multiples} for path in groups}
    try:
        for order in (list(multiples), list(reversed(multiples))):
            for m in order:
                setattr(K, constant, m * unit)
                for path, checks in groups.items():
                    total = 0.0
                    for _, label, fn, args in checks:
                        check(label, fn, args, m)
                        total += _device_ms(fn, args)
                    table[path][m].append(total)
                    say("sweep", path=repr(path), multiple=m, blocks=m * unit,
                        checks=len(checks), device_ms=f"{total:.4f}")
    finally:
        setattr(K, constant, saved)
    print(json.dumps({constant.lower(): table}), flush=True)
    return 0


def main() -> int:
    sys.path.insert(0, ROOT)
    sweeps = {"--scatter-blocks": "SCATTER_BLOCKS", "--wgrad-blocks": "WGRAD_BLOCKS"}
    if sys.argv[1:2] and sys.argv[1] in sweeps:
        return blocks_sweep(sweeps[sys.argv[1]], [int(m) for m in sys.argv[2].split(",")])
    if sys.argv[1:2] == ["--votenet-bf16-spread"]:
        return votenet_bf16_spread([int(m) for m in sys.argv[2].split(",")])
    if sys.argv[1:2] == ["--resnet-bf16-spread"]:
        return resnet_bf16_spread([int(m) for m in sys.argv[2].split(",")])
    if sys.argv[1:2] == ["--brick-bf16-spread"]:
        return brick_bf16_spread([int(m) for m in sys.argv[2].split(",")])
    if sys.argv[1:2] == ["--ddp"]:  # the ddp phase alone, after the build
        card = phase_device()
        phase_build()
        ddp_phases(card, {})
        return 0
    if sys.argv[1:2] == ["--st"]:  # the st phase alone, after the build
        card = phase_device()
        phase_build()
        import torch

        from pointcontrast_tpu_torch.tools.workload import SemsegScenes

        paths = {}
        st_paths(torch.device("cuda", 0), card, paths, SemsegScenes())
        print(json.dumps({"kernels": kernels_line(paths)}), flush=True)
        return 0
    t0 = time.perf_counter()
    card = phase_device()
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.tools.workload import votenet_model

    phase_build()
    device = torch.device("cuda", 0)
    fps_pick_floor(device)
    paths = {}  # main path -> (its kernel checks' numbers, its launch counts)
    for layout in ("chunked", "voxel", "brick:2"):
        pretrain_path(layout, device, card, paths)
    for layout in ("chunked", "voxel", "brick:2"):
        pretrain_path(layout, device, card, paths, dtype=torch.bfloat16)
    pretrain_hardest_paths(device, card, paths)
    phase_cli_pretrain(card)
    ddp_phases(card, paths)
    clouds = votenet_path("chunked", device, card, paths, STEPS)
    res = phase_kernels(fps_checks(clouds), D, exact=("furthest_point_sample",))
    paths["fps shapes"] = (res, {})  # no main path: the other cluster sizes
    del clouds
    votenet_path("voxel", device, card, paths, LAYOUT_STEPS)
    votenet_path("chunked", device, card, paths, STEPS, dtype=torch.bfloat16)
    pbatches = make_pointnet2_batches(device)
    pmodel = votenet_model(seed=0, backbone="pointnet2")
    res = phase_kernels(
        pointnet2_kernel_checks(pmodel, pbatches[0]), D,
        exact=("furthest_point_sample", "ball_query", "gather_rows", "three_nn"))
    paths["votenet pointnet2"] = (res, phase_votenet(pbatches, device, card, pmodel,
                                                     "votenet pointnet2"))
    phase_boxnet(pbatches, device)
    del pbatches
    phase_cli()
    phase_cli(sparse=True)
    phase_cli(sparse=True, backbone_model="MinkUNetHyper14INBN")
    scenes = semseg_paths(device, card, paths)
    semseg_layout_paths(device, card, paths, scenes)
    phase_cli_semseg()
    phase_cli_semseg(shipped_dtype=True)
    phase_cli_semseg("ResUNet18INBN", shipped_dtype=True)
    phase_cli_semseg("MinkUNetHyper14INBN")
    phase_cli_semseg("MinkUNetHyper14INBN", shipped_dtype=True)
    phase_cli_semseg(shipped_dtype=True, wrapper="BilateralCRF")
    phase_cli_semseg(layout="voxel")
    phase_cli_semseg(layout="brick")
    phase_cli_semseg(layout="brick", shipped_dtype=True)
    st_paths(device, card, paths, scenes)
    resnet_paths(device, card, paths, scenes)
    del scenes
    res = phase_kernels(probe_checks(device), K, exact=("gather_sum",))
    paths["pallas probes"] = (res, {})  # no main path: checked at their shapes
    kernels = kernels_line(paths)
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
