#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pointcontrast_tpu_torch``) on one
NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. device: requires CUDA; prints ``nvidia-smi`` name and power limit;
  2. build: compiles the sm_90a kernels (csrc/sparse_conv.cu and
     csrc/detect_ops.cu, one nvcc each, in parallel) and the host kernel-map
     library from this checkout's sources;
  the pretraining path:
  3. data: collates the pretraining batches (SyntheticPairDataset, 4 pairs
     per step, PadScheme.scannet(npad0=131072), 4096 NCE pairs, fused
     frames, chunked layout) and moves them to the card, bounds-checked;
  4. kernels: every sparse-conv kernel against its plain-torch twin on the
     card at the path's shapes taken from one real batch (f32, TF32 off),
     with times;
  5. slice: Res16UNet34C (3 -> 32, L2-normalised) -- one step through the
     kernels against the same step through the plain twins from the same
     weights and batch, then 5 SGD steps under PretrainTrainer with finite
     losses and the expected launch count of every kernel;
  the VoteNet detection path (configs/votenet_default.yaml, f32):
  6. data: two batches of 8 synthetic scenes x 40000 points, 2.5 cm voxels,
     npad0 262144 with the YAML's pad ratios, chunked, bounds-checked;
  7. kernels: FPS, ball query, gather and scatter-add against their twins
     at the path's shapes from one real batch, with times;
  8. parity: one VoteNet step through the kernels against the same step
     through the plain twins, from the same weights and batch;
  9. slice: 5 DetectTrainer.train_epoch steps (Res16UNet34C 3 -> 256, Adam)
     with finite losses and the expected launch count of all eight
     kernels, then one evaluate pass (mAP in [0, 1]) and the shapes and
     finiteness of the eval outputs.
Then one JSON line with the per-kernel results, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: non-zero exit, no
result line.
"""
from __future__ import annotations

import contextlib
import copy
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
# kernel vs plain twin, f32 on both sides: |err| <= ATOL + RTOL * max|ref|
# (the sums run in different orders; gather_wgrad adds row slices with
# unordered f32 atomics)
RTOL, ATOL = 1e-4, 1e-5
# one step's loss, kernels vs plain twins (55 convs + train-mode BN deep);
# the VoteNet step's backbone output and seed features are held to RTOL
LOSS_RTOL = 1e-4
# one VoteNet step through the kernels vs the plain twins: backbone output,
# seed features and (while every integer output agrees) the loss; with
# flipped argmin/argmax outputs, the loss to LOSS_RTOL_FLIPPED and at most
# MAX_FLIPPED of any integer set differing
LOSS_RTOL_FLIPPED, MAX_FLIPPED = 1e-3, 0.01
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
}


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
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("native kernel-map library failed to build")
    say("build", nvcc_wall_s=f"{wall:.1f}",
        nvcc_s={n: round(r["seconds"], 1) for n, r in info.items()},
        gxx_s=f"{time.perf_counter() - t0:.1f}")


def make_batches(device, **kw):
    from pointcontrast_tpu_torch.tools.workload import pretrain_batches

    t0 = time.perf_counter()
    dev = pretrain_batches(device, **kw)
    lv = dev[0].pyramid0.levels
    nb = dev[0].pyramid0.num_batch
    say("data", seconds=f"{time.perf_counter() - t0:.1f}", chunks=nb,
        chunk_rows=[int(l.valid.shape[0]) // nb for l in lv],
        valid_rows=[int(l.valid.sum()) for l in lv],
        truncated=[float(b.truncated_voxels) for b in dev],
        pairs=[int(b.pair_valid.sum()) for b in dev])
    return dev


def _masked_randn(shape, valid, gen):
    import torch

    x = torch.randn(shape, device=valid.device, generator=gen)
    return x * valid.reshape(shape[0], shape[1], 1)


def kernel_checks(batch):
    """[(kernel, label, fn, args)] at the main path's shapes of one batch."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K

    lv = batch.pyramid0.levels
    nb = batch.pyramid0.num_batch
    dev = batch.feats0.device
    gen = torch.Generator(device=dev).manual_seed(0)
    s = [int(l.valid.shape[0]) // nb for l in lv]
    rev = lv[0].rev
    center = next(i for i, r in enumerate(rev) if r == i)
    taps = [i for i in range(27) if i != center]
    rtaps = [rev[i] for i in taps]

    def feats(level, c):
        return _masked_randn((nb, s[level], c), lv[level].valid, gen)

    def w(k, cin, cout):
        return torch.randn(k, cin, cout, device=dev, generator=gen) * (2.0 / (k * cin)) ** 0.5

    def k1(level, cin, cout, name):
        f, ct, wt = feats(level, cin), feats(level, cout), w(27, cin, cout)
        wtt = wt.transpose(1, 2)
        out = [
            ("gather_gemm", f"K1 fwd {name} L{level} {cin}->{cout}", K.gather_gemm,
             (f, lv[level].nbr, taps, 0, wt[taps], wt[center], s[level])),
            ("gather_wgrad", f"K1 dW {name} L{level} {cin}x{cout}", K.gather_wgrad,
             (f, None, None, 0, ct, lv[level].nbr, list(rev), 0, 27, s[level])),
        ]
        if cin != 3:  # the stem's input needs no gradient
            out.append(("gather_gemm", f"K1 dF {name} L{level} {cout}->{cin}",
                        K.gather_gemm,
                        (ct, lv[level].nbr, rtaps, 0, wtt[taps].contiguous(),
                         wtt[center].contiguous(), s[level])))
        return out

    checks = []
    checks += k1(0, 3, 32, "stem")
    checks += k1(0, 128, 96, "block8_0.conv1")
    checks += k1(4, 256, 256, "block4")
    checks += k1(3, 384, 256, "block5_0.conv1")
    # K2 conv1p1s2 (L0 -> L1, 32 -> 32)
    f0, ct1, w2 = feats(0, 32), feats(1, 32), w(8, 32, 32)
    checks += [
        ("gather_gemm", "K2 fwd L0->L1 32->32", K.gather_gemm,
         (f0, lv[0].down_nbr, list(range(8)), 0, w2, None, s[1])),
        ("parent_gemm", "K2 dF L1->L0 32->32", K.parent_gemm,
         (ct1, lv[0].up_parent, lv[0].up_offset, w2.transpose(1, 2).contiguous())),
        ("gather_wgrad", "K2 dW 32x32", K.gather_wgrad,
         (f0, lv[0].down_nbr, list(range(8)), 0, ct1, None, None, 0, 8, s[1])),
    ]
    # K3 convtr7p2s2 (L1 -> L0, 96 -> 96)
    f1, ct0, w3 = feats(1, 96), feats(0, 96), w(8, 96, 96)
    dy = K.scatter_parent_plain(ct0, lv[0].up_parent, lv[0].up_offset, 8, s[1])
    checks += [
        ("parent_gemm", "K3 fwd L1->L0 96->96", K.parent_gemm,
         (f1, lv[0].up_parent, lv[0].up_offset, w3)),
        ("scatter_parent", "K3 bwd scatter L0->L1 96", K.scatter_parent,
         (ct0, lv[0].up_parent, lv[0].up_offset, 8, s[1])),
        ("gather_gemm", "K3 dF stacked 96->96", K.gather_gemm,
         (dy, None, None, s[1], w3.transpose(1, 2).contiguous(), None, s[1])),
        ("gather_wgrad", "K3 dW 96x96", K.gather_wgrad,
         (f1, None, None, 0, dy, None, None, s[1], 8, s[1])),
    ]
    return checks


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


def phase_kernels(checks, module, exact=()):
    """Each check's kernel vs its plain twin; kernels named in ``exact`` must
    equal it bit for bit, the others agree to ATOL + RTOL * max|ref|.
    Returns {kernel: {max_abs_err, ms, plain_ms}} with the times summed over
    the kernel's checked shapes."""
    import torch

    results = {fn.__name__: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for fn in module.KERNELS}
    failures = []
    for name, label, fn, args in checks:
        plain = getattr(module, name + "_plain")
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        plain_ms = _time_ms(plain, args)
        ms = _time_ms(fn, args)
        err = float((got.double() - want.double()).abs().max())
        ref = float(want.double().abs().max())
        if name in exact:
            ok = got.dtype == want.dtype and torch.equal(got, want)
        else:
            ok = bool(torch.isfinite(got).all()) and err <= ATOL + RTOL * ref
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        say("kernel", name=name, check=repr(label), shape=tuple(got.shape),
            max_abs_err=f"{err:.3e}", max_abs_ref=f"{ref:.3e}",
            rel=f"{err / max(ref, 1e-30):.2e}", exact=name in exact,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", ok=ok)
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"kernels disagree with their plain twins: {failures}")
    return results


def expected_launches(model) -> dict:
    """Kernel launches of one training step, from the model's conv layout:
    K1 fwd + dF (not for the stem, whose input needs no gradient) + dW;
    K2 fwd + dF + dW; K3 fwd + scatter + dF + dW."""
    from pointcontrast_tpu_torch.nn.layers import SparseConv, SparseConvTranspose

    convs = [m for m in model.modules() if isinstance(m, SparseConv)]
    n_same = sum(1 for m in convs if m.weight.shape[0] == 27)
    n_down = sum(1 for m in convs if m.weight.shape[0] == 8)
    n_tr = sum(1 for m in model.modules() if isinstance(m, SparseConvTranspose))
    return {
        "gather_gemm": n_same + (n_same - 1) + n_down + n_tr,
        "gather_wgrad": n_same + n_down + n_tr,
        "parent_gemm": n_tr + n_down,
        "scatter_parent": n_tr,
    }


def phase_slice(batches, device, card):
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

    model = pretrain_model(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    expect = expected_launches(model)
    say("model", name="Res16UNet34C", params=n_params, per_step=expect)
    cfg = PretrainConfig(lr=0.1, stat_freq=1, save_freq=10 ** 9,
                         checkpoint_dir=os.path.join(BUILD_DIR, "smoke_ckpt"))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)

    # one step through the kernels vs the plain twins, same weights + batch
    losses = {}
    for mode in ("plain", "kernels"):
        m = copy.deepcopy(model).to(device)
        opt = optim.make_optimizer(m, cfg)
        sched = optim.make_scheduler(opt, cfg)
        step = make_train_step(cfg)
        with plain_ops() if mode == "plain" else contextlib.nullcontext():
            losses[mode] = float(step(m, opt, sched, batches[0])["loss"])
        del m, opt, sched
    rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    say("parity", loss_kernels=f"{losses['kernels']:.8f}",
        loss_plain=f"{losses['plain']:.8f}", rel=f"{rel:.2e}", rtol=LOSS_RTOL)
    if not (rel <= LOSS_RTOL):
        raise AssertionError(f"kernel step loss differs from plain: rel {rel:.2e}")

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
        say("step", iter=i + 1, loss=f"{m['loss']:.6f}", lr=m["lr"],
            step_ms=f"{1e3 * m['step_time']:.1f}")
    if len(loss_list) != STEPS or not all(map(math.isfinite, loss_list)):
        raise AssertionError(f"non-finite or missing losses: {loss_list}")
    want = {k: v * STEPS for k, v in expect.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    steady = statistics.median(step_ms[1:])
    say("slice", steps=STEPS, launches=counts, ms_per_step=f"{steady:.1f}",
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
    if float((norms[valid] - 1).abs().max()) > 1e-4 or bool(out[~valid].any()):
        raise AssertionError("output rows are not unit-norm / pad rows not zero")
    say("output", shape=tuple(out.shape), valid_rows=int(valid.sum()))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    return counts


def make_votenet_batches(device):
    from pointcontrast_tpu_torch.tools.workload import votenet_batches

    t0 = time.perf_counter()
    dev = votenet_batches(device)
    pyr = dev[0].voxel_pyramid
    nb = pyr.num_batch
    say("data", app="votenet", seconds=f"{time.perf_counter() - t0:.1f}",
        scenes=nb, points=int(dev[0].point_clouds.shape[1]),
        chunk_rows=[int(l.valid.shape[0]) // nb for l in pyr.levels],
        valid_rows=[[int(l.valid.sum()) for l in b.voxel_pyramid.levels]
                    for b in dev])
    return dev


def detect_kernel_checks(batch):
    """[(kernel, label, fn, args)] for K6-K8 at the VoteNet step's shapes,
    from one real batch: the backbone's FPS over the 40000-point clouds and
    its seed gathers, then the proposal module's FPS, ball query (r 0.3,
    16 samples) and [xyz, feature] group over a 1024-vote cloud (the seeds
    moved by offsets of the voting module's scale), with the backward
    scatter-adds of the gathers that carry a gradient."""
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D

    dev = batch.point_clouds.device
    gen = torch.Generator(device=dev).manual_seed(1)
    xyz = batch.point_clouds[..., 0:3].contiguous()
    b_ = xyz.shape[0]
    s0 = batch.voxel_feats.shape[0] // b_
    seeds = D.furthest_point_sample_plain(xyz, 1024)
    seed_xyz = D.gather_rows_plain(xyz, seeds)
    votes = seed_xyz + 0.05 * torch.randn(seed_xyz.shape, device=dev, generator=gen)
    props = D.furthest_point_sample_plain(votes, 256)
    centres = D.gather_rows_plain(votes, props)
    group = D.ball_query_plain(centres, votes, 0.3, 16)
    rows = torch.gather(batch.point_voxel_idx, 1, seeds.long()).reshape(1, -1)
    vout = torch.randn(1, b_ * s0, 256, device=dev, generator=gen)
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
          b_ * s0)),
        ("scatter_add_rows", "K8 bwd proposal centres", D.scatter_add_rows,
         (torch.randn(b_, 256, 3, device=dev, generator=gen), props, 1024)),
        ("scatter_add_rows", "K8 bwd group 259", D.scatter_add_rows,
         (torch.randn(b_, 256, 16, 259, device=dev, generator=gen), group,
          1024)),
    ]


def expected_detect_launches(model) -> dict:
    """Detect-kernel launches of one VoteNet training step, from the model:
    FPS in the backbone and in the proposal module (vote or seed FPS); a
    ball query per set-abstraction module; gathers of the backbone's seed
    xyz and seed features and of each SA module's centres and one group;
    a scatter-add for each gather whose table needs a gradient (all but the
    seed xyz, which reads the input cloud)."""
    from pointcontrast_tpu_torch.detect.modules import PointnetSAModuleVotes

    n_sa = sum(isinstance(m, PointnetSAModuleVotes) for m in model.modules())
    fps = 1 + (model.pnet.sampling in ("vote_fps", "seed_fps"))
    return {"furthest_point_sample": fps, "ball_query": n_sa,
            "gather_rows": 2 + 2 * n_sa, "scatter_add_rows": 1 + 2 * n_sa}


def _votenet_step_outputs(model, dc, cfg, batch, device, plain):
    """One DetectTrainer.train_epoch step of a copy of ``model``, through the
    plain twins or the kernels; returns its loss, backbone output, seed
    features and integer outputs (the ball query recomputed from the step's
    votes and centres, in the same mode)."""
    import torch

    from pointcontrast_tpu_torch.detect import ops as dops
    from pointcontrast_tpu_torch.detect.train import DetectTrainer
    from pointcontrast_tpu_torch.tools.workload import plain_ops

    m = copy.deepcopy(model)
    seen = {}
    hooks = [
        m.backbone_net.net.register_forward_hook(
            lambda mod, inp, out: seen.__setitem__("vout", out.detach())),
        m.register_forward_hook(lambda mod, inp, out: seen.__setitem__("ep", out)),
    ]
    with plain_ops() if plain else contextlib.nullcontext():
        trainer = DetectTrainer(m, dc, cfg, device)
        loss = trainer.train_epoch(iter([batch]), 1)
        ep = seen["ep"]
        bq = dops.ball_query(ep["aggregated_vote_xyz"].detach(),
                             ep["vote_xyz"].detach(), 0.3, 16)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    return {
        "loss": loss, "vout": seen["vout"],
        "seed_features": ep["seed_features"].detach(),
        "ints": {"fps_seeds": ep["seed_inds"],
                 "fps_proposals": ep["aggregated_vote_inds"],
                 "ball_query": bq, "object_assignment": ep["object_assignment"]},
    }


def phase_votenet(batches, device, card):
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
    from pointcontrast_tpu_torch.tools.workload import votenet_model

    model = votenet_model(seed=0)
    dc = ScannetDatasetConfig()
    expect = {**expected_launches(model.backbone_net.net),
              **expected_detect_launches(model)}
    say("model", app="votenet",
        name=f"VoteNet(sparseconv {type(model.backbone_net.net).__name__} 3->256)",
        params=sum(p.numel() for p in model.parameters()), per_step=expect)
    cfg = DetectConfig(checkpoint_dir=os.path.join(BUILD_DIR, "smoke_votenet"))
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)

    # one step through the kernels vs the plain twins, same weights + batch
    res = {mode: _votenet_step_outputs(model, dc, cfg, batches[0], device,
                                       plain=mode == "plain")
           for mode in ("plain", "kernels")}
    p, k = res["plain"], res["kernels"]
    rel = {name: float((k[name] - p[name]).abs().max() / p[name].abs().max())
           for name in ("vout", "seed_features")}
    flipped = {name: int((k["ints"][name] != v).sum())
               for name, v in p["ints"].items()}
    frac = max(flipped[n] / p["ints"][n].numel() for n in flipped)
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    loss_rtol = LOSS_RTOL if not any(flipped.values()) else LOSS_RTOL_FLIPPED
    say("parity", app="votenet", loss_kernels=f"{k['loss']:.8f}",
        loss_plain=f"{p['loss']:.8f}", loss_rel=f"{loss_rel:.2e}",
        loss_rtol=loss_rtol, backbone_rel=f"{rel['vout']:.2e}",
        seed_features_rel=f"{rel['seed_features']:.2e}", flipped=flipped)
    if not (max(rel.values()) <= RTOL and loss_rel <= loss_rtol
            and frac <= MAX_FLIPPED):
        raise AssertionError("VoteNet kernel step differs from the plain step")
    del res, p, k

    # the main path: DetectTrainer.train_epoch, STEPS steps, counted launches
    trainer = DetectTrainer(model, dc, cfg, device)
    loader = itertools.cycle(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    D.reset_launches()
    losses, step_ms = [], []
    for i in range(STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch(loader, 1))  # syncs on its loss
        step_ms.append(1e3 * (time.perf_counter() - t0))
        say("step", app="votenet", iter=i + 1, loss=f"{losses[-1]:.6f}",
            step_ms=f"{step_ms[-1]:.1f}")
    torch.cuda.synchronize()
    counts = {**K.launch_counts(), **D.launch_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite losses: {losses}")
    want = {name: v * STEPS for name, v in expect.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    steady = statistics.median(step_ms[1:])
    scenes = int(batches[0].point_clouds.shape[0])
    say("slice", app="votenet", steps=STEPS, launches=counts,
        ms_per_step=f"{steady:.1f}", scenes_per_s=f"{scenes / (steady / 1e3):.2f}",
        first_step_ms=f"{step_ms[0]:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
        card=repr(card))

    # one evaluation pass, then what comes out of the eval-mode model
    t0 = time.perf_counter()
    metrics = trainer.evaluate(iter(batches), None)
    maps = {t: float(m["mAP"]) for t, m in metrics.items()}
    say("eval", app="votenet", batches=len(batches), mAP=maps,
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
    say("output", app="votenet", fields=len(shapes), proposals=npr)
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    return counts


def main() -> int:
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    card = phase_device()
    import torch

    from pointcontrast_tpu_torch.detect import kernels as D
    from pointcontrast_tpu_torch.sparse import kernels as K

    phase_build()
    device = torch.device("cuda", 0)
    batches = make_batches(device)
    results = phase_kernels(kernel_checks(batches[0]), K)
    counts = phase_slice(batches, device, card)
    del batches
    vbatches = make_votenet_batches(device)
    results.update(phase_kernels(
        detect_kernel_checks(vbatches[0]), D,
        exact=("furthest_point_sample", "ball_query", "gather_rows")))
    vcounts = phase_votenet(vbatches, device, card)
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": (counts if name in counts else vcounts)[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
