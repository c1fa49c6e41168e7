"""Where a training step's time goes on one GPU.

    python -m pointcontrast_tpu_torch.tools.profile_step
        [--app pretrain|votenet|semseg|resnet] [--backbone sparseconv|pointnet2]
        [--model Res16UNet34C|ResUNet18INBN|MinkUNetHyper14INBN|ResNet18|...]
        [--crf] [--layout chunked|voxel|brick|brick:N]
        [--dtype float32|bfloat16] [--steps 10]

On the ``tools.workload`` step of the app (f32, TF32 off, or with ``--dtype
bfloat16`` the nets' bf16 activations, as the shipped YAMLs' ``net.dtype``,
with bf16 matmuls reducing in f32; PointNet++ and the ResNets have no bf16
mode): ``pretrain`` is
Res16UNet34C + PointInfoNCE + SGD over 4 fused pairs; ``votenet`` is the
shipped VoteNet config (8 scenes x 40000 points, 256 proposals) over the
sparse-conv Res16UNet34C 3 -> 256 (``--backbone sparseconv``, the YAML's
default) or PointNet++ (``--backbone pointnet2``) + its loss + Adam;
``semseg`` is the JAX benchmark's semseg step (6 scenes, ~250k voxels at
2 cm, 20 classes) through ``--model`` (Res16UNet34C by default), in a
BilateralCRF with ``--crf`` (the filter applied on every step) + the CE
loss + SGD and PolyLR; ``resnet`` is the same scenes through a ResNet
(``--model``, ResNet18 by default) on its 6-level pyramid, CE at the
level-5 rows, the same optimizer.  ``--layout`` collates the pretraining
and semseg batches in the chunked (default), voxel or brick[:N] layout.
  1. ms/step of the kernel path and of the plain-torch twins
     (``workload.plain_ops``), timed in turns (plain, kernels, kernels,
     plain), each from the same seeded weights after two warm-up steps, host
     clock around ``torch.cuda.synchronize()``;
  2. ms/step of each phase of the kernel path (forward, loss, backward,
     optimizer), host clock with a synchronise after each phase;
  3. one ``torch.profiler`` window over the kernel path: the device's busy
     time (union of its kernel and copy intervals) against the window's wall
     time, device time by kernel name, and the launches a step: all of
     them and those of PyTorch's copy kernels and memcpys (casts and
     ``contiguous`` copies among them), by name.
Prints one JSON summary as its last line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import time
import types
from collections import defaultdict

import torch

from pointcontrast_tpu_torch.tools import workload

PHASES = ("forward", "loss", "backward", "optimizer")


def _pretrain_app(layout="chunked", dtype=None):
    from pointcontrast_tpu_torch.losses.contrastive import point_info_nce_loss
    from pointcontrast_tpu_torch.train import PretrainConfig, make_train_step
    from pointcontrast_tpu_torch.train import optim

    cfg = PretrainConfig(lr=0.1)
    train_step = make_train_step(cfg)

    def fresh(model):
        m = copy.deepcopy(model).cuda()
        opt = optim.make_optimizer(m, cfg)
        return m, (opt, optim.make_scheduler(opt, cfg))

    def step(m, state, batch):
        train_step(m, state[0], state[1], batch)

    def phases(m, state, batch, mark):
        opt, sched = state
        opt.zero_grad(set_to_none=True)
        mark()
        f = m(batch.feats0, batch.pyramid0)
        mark()
        loss = point_info_nce_loss(f, f, batch.q_idx, batch.k_idx,
                                   batch.pair_valid, cfg.nce_t)
        mark()
        loss.backward()
        mark()
        opt.step()
        sched.step()
        mark()

    return types.SimpleNamespace(
        batches=workload.pretrain_batches("cuda", layout=layout),
        model=workload.pretrain_model(seed=0, dtype=dtype), unit="pairs",
        per_step=workload.PAIRS, fresh=fresh, step=step, phases=phases)


def _votenet_app(backbone="sparseconv", dtype=None):
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.train import (
        DetectConfig,
        DetectTrainer,
        batch_to_inputs,
        batch_to_labels,
        get_bn_momentum,
        loss_of,
        make_detect_train_step,
    )

    dc, cfg = ScannetDatasetConfig(), DetectConfig(checkpoint_dir="")
    train_step = make_detect_train_step(dc)

    def fresh(model):
        trainer = DetectTrainer(copy.deepcopy(model), dc, cfg, "cuda")
        trainer.set_bn_momentum(get_bn_momentum(0, cfg))
        return trainer.model, trainer.opt

    def step(m, opt, batch):
        train_step(m, opt, batch)

    def phases(m, opt, batch, mark):
        m.train()
        opt.zero_grad(set_to_none=True)
        mark()
        end_points = m(batch_to_inputs(batch))
        mark()
        end_points.update(batch_to_labels(batch))
        loss, _ = loss_of(m)(end_points, dc)
        mark()
        loss.backward()
        mark()
        opt.step()
        mark()

    voxel = workload.VOTENET_VOXEL if backbone == "sparseconv" else None
    return types.SimpleNamespace(
        batches=workload.votenet_batches("cuda", voxel=voxel),
        model=workload.votenet_model(seed=0, backbone=backbone, dtype=dtype),
        unit="scenes",
        per_step=workload.VOTENET_SCENES, fresh=fresh, step=step,
        phases=phases)


def _semseg_app(model="Res16UNet34C", crf=False, layout="chunked", dtype=None):
    from pointcontrast_tpu_torch.losses.semseg import cross_entropy_ignore
    from pointcontrast_tpu_torch.semseg.train import (
        SemsegConfig,
        forward,
        make_semseg_train_step,
    )
    from pointcontrast_tpu_torch.train import optim

    cfg = SemsegConfig(lr=0.1, max_iter=60000, wrapper_lr=0.1 if crf else None)
    train_step = make_semseg_train_step(cfg)
    scenes = workload.SemsegScenes()
    batch = workload.semseg_batch(scenes, crf=workload.SEMSEG_CRF,
                                  layout=layout).to("cuda")

    def fresh(model):
        m = copy.deepcopy(model).cuda()
        opt = optim.make_optimizer(m, cfg, {"filter": 1.0} if crf else None)
        return m, (opt, optim.make_scheduler(opt, cfg, cfg.scheduler))

    def step(m, state, batch):
        train_step(m, state[0], state[1], [batch])

    def phases(m, state, batch, mark):
        opt, sched = state
        m.train()
        opt.zero_grad(set_to_none=True)
        mark()
        logits = forward(m, batch)
        mark()
        loss = cross_entropy_ignore(logits, batch.labels, cfg.ignore_label)
        mark()
        loss.backward()
        mark()
        opt.step()
        sched.step()
        mark()

    return types.SimpleNamespace(
        batches=[batch],
        model=workload.semseg_model(seed=0, model=model,
                                    crf=workload.SEMSEG_CRF if crf else None, dtype=dtype),
        unit="scenes", per_step=len(scenes), fresh=fresh, step=step,
        phases=phases)


def _resnet_app(model="ResNet18"):
    from pointcontrast_tpu_torch.losses.semseg import cross_entropy_ignore
    from pointcontrast_tpu_torch.semseg.train import SemsegConfig
    from pointcontrast_tpu_torch.train import optim

    cfg = SemsegConfig(lr=0.1, max_iter=60000)
    scenes = workload.SemsegScenes()
    batch = workload.resnet_batch(scenes).to("cuda")

    def fresh(model):
        m = copy.deepcopy(model).cuda()
        opt = optim.make_optimizer(m, cfg)
        return m, (opt, optim.make_scheduler(opt, cfg, cfg.scheduler))

    def step(m, state, batch):
        workload.resnet_step(m, state[0], state[1], batch)

    def phases(m, state, batch, mark):
        opt, sched = state
        m.train()
        opt.zero_grad(set_to_none=True)
        mark()
        logits = m(batch.feats, batch.pyramid)
        mark()
        loss = cross_entropy_ignore(logits, batch.labels, 255)
        mark()
        loss.backward()
        mark()
        opt.step()
        sched.step()
        mark()

    return types.SimpleNamespace(
        batches=[batch], model=workload.resnet_model(seed=0, model=model),
        unit="scenes", per_step=len(scenes), fresh=fresh, step=step,
        phases=phases)


APPS = {"pretrain": _pretrain_app, "votenet": _votenet_app, "semseg": _semseg_app,
        "resnet": _resnet_app}


def _warm(app, steps=2):
    m, state = app.fresh(app.model)
    for i in range(steps):
        app.step(m, state, app.batches[i % len(app.batches)])
    torch.cuda.synchronize()
    return m, state


def _timed_steps(app, steps, plain):
    with workload.plain_ops() if plain else contextlib.nullcontext():
        m, state = _warm(app)
        t0 = time.perf_counter()
        for i in range(steps):
            app.step(m, state, app.batches[i % len(app.batches)])
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def _phase_ms(app, steps):
    """Mean ms/step of each phase, synchronising after each one."""
    m, state = _warm(app)
    total = dict.fromkeys(PHASES, 0.0)
    for i in range(steps):
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        app.phases(m, state, app.batches[i % len(app.batches)], mark)
        for name, a, z in zip(PHASES, marks, marks[1:]):
            total[name] += 1e3 * (z - a)
    return {k: v / steps for k, v in total.items()}


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _profile(app, steps):
    """(window wall us, device busy us, {kernel name: (us, count)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m, state = _warm(app)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            app.step(m, state, app.batches[i % len(app.batches)])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]  # optimizer step ranges, not work
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    return wall_us, busy, dict(by_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", choices=sorted(APPS), default="pretrain")
    ap.add_argument("--backbone", choices=("sparseconv", "pointnet2"),
                    default="sparseconv", help="votenet only")
    ap.add_argument("--model", help="semseg (default Res16UNet34C) and resnet "
                    "(default ResNet18)")
    ap.add_argument("--crf", action="store_true", help="semseg only")
    ap.add_argument("--layout", default="chunked",
                    help="pretrain and semseg: chunked, voxel, brick or brick:N")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the nets' activations (pretrain, votenet sparseconv, semseg)")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    model = {"semseg": args.model or "Res16UNet34C",
             "resnet": args.model or "ResNet18"}.get(args.app)
    kw = {"pretrain": {"layout": args.layout},
          "votenet": {"backbone": args.backbone},
          "semseg": {"model": model, "crf": args.crf, "layout": args.layout},
          "resnet": {"model": model}}.get(args.app, {})
    if args.dtype != "float32":
        kw["dtype"] = getattr(torch, args.dtype)
    app = APPS[args.app](**kw)
    steps = args.steps

    times = {"plain": [], "kernels": []}
    peak = 0
    for mode in ("plain", "kernels", "kernels", "plain"):
        torch.cuda.reset_peak_memory_stats()
        ms = _timed_steps(app, steps, plain=mode == "plain")
        if mode == "kernels":
            peak = max(peak, torch.cuda.max_memory_allocated())
        times[mode].append(ms)
        print(f"[time] {args.app} {mode} ms_per_step={ms:.3f}", flush=True)
    print(f"[memory] kernels peak_mem_gib={peak / 2 ** 30:.3f}", flush=True)

    phases = _phase_ms(app, steps)
    print("[phase] ms/step " + " ".join(f"{k}={v:.3f}" for k, v in phases.items()),
          flush=True)

    wall_us, busy_us, by_name = _profile(app, steps)
    if busy_us == 0:
        raise RuntimeError("the profiler recorded no device activity")
    print(f"[profile] steps={steps} wall_ms_per_step={wall_us / steps / 1e3:.3f} "
          f"device_busy_ms_per_step={busy_us / steps / 1e3:.3f} "
          f"idle_share={1 - busy_us / wall_us:.4f}", flush=True)
    total = sum(us for us, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in ranked[:25]:
        print(f"[kernel] {us / steps / 1e3:9.3f} ms/step {100 * us / total:6.2f}% "
              f"launches/step={count / steps:g} {name[:110]}", flush=True)
    # copies and casts (PyTorch's copy kernels, memcpys): their names differ
    # past the first 110 characters, so each gets its head and tail
    copies = {name: count for name, (_, count) in by_name.items()
              if "copy" in name.lower() or name.startswith("Memcpy")}
    for name, count in sorted(copies.items(), key=lambda kv: -kv[1]):
        label = name if len(name) <= 150 else f"{name[:60]} ... {name[-90:]}"
        print(f"[copy] launches/step={count / steps:g} {label}", flush=True)
    launches = sum(count for _, count in by_name.values()) / steps
    copy_launches = sum(copies.values()) / steps
    print(f"[launches] per_step={launches:g} copies_per_step={copy_launches:g}", flush=True)
    summary = {
        "app": args.app,
        "backbone": args.backbone if args.app == "votenet" else None,
        "model": model,
        "crf": args.crf if args.app == "semseg" else None,
        "layout": args.layout if args.app in ("pretrain", "semseg") else None,
        "dtype": args.dtype,
        "card": card,
        "ms_per_step": times,
        "peak_mem_gib_kernels": peak / 2 ** 30,
        f"{app.unit}_per_s_kernels": app.per_step / (min(times["kernels"]) / 1e3),
        "phase_ms_per_step": phases,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "launches_per_step": launches,
        "copy_launches_per_step": copy_launches,
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
