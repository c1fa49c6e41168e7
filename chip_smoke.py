#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pointcontrast_tpu_torch``) on one
NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. device: requires CUDA; prints ``nvidia-smi`` name and power limit;
  2. build: compiles the sm_90a kernels (csrc/sparse_conv.cu) and the host
     kernel-map library from this checkout's sources;
  3. data: collates the pretraining batches (SyntheticPairDataset, 4 pairs
     per step, PadScheme.scannet(npad0=131072), 4096 NCE pairs, fused
     frames, chunked layout) and moves them to the card, bounds-checked;
  4. kernels: every kernel against its plain-torch twin on the card at the
     main path's shapes taken from one real batch (f32, TF32 off), with
     times;
  5. slice: Res16UNet34C (3 -> 32, L2-normalised) -- one step through the
     kernels against the same step through the plain twins from the same
     weights and batch, then 5 SGD steps under PretrainTrainer with finite
     losses and the expected launch count of every kernel.
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
# one step's loss, kernels vs plain twins (55 convs + train-mode BN deep)
LOSS_RTOL = 1e-4
SOURCE = "pointcontrast_tpu_torch/csrc/sparse_conv.cu"
REPLACES = {  # the JAX op each kernel replaces (custom-VJP XLA programs)
    "gather_gemm": "pointcontrast_tpu/sparse/ops.py:376",
    "gather_wgrad": "pointcontrast_tpu/sparse/ops.py:440",
    "parent_gemm": "pointcontrast_tpu/sparse/ops.py:768",
    "scatter_parent": "pointcontrast_tpu/sparse/ops.py:803",
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
    from pointcontrast_tpu_torch.sparse import kernels, native

    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)  # build from source
    info = kernels.build_kernels()
    for line in info["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("native kernel-map library failed to build")
    say("build", nvcc_s=f"{info['seconds']:.1f}",
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


def phase_kernels(batch):
    """Each kernel vs its plain twin; returns {kernel: {max_abs_err, ms,
    plain_ms}} with the times summed over the kernel's checked shapes."""
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K

    results = {fn.__name__: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for fn in K.KERNELS}
    failures = []
    for name, label, fn, args in kernel_checks(batch):
        plain = getattr(K, name + "_plain")
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        plain_ms = _time_ms(plain, args)
        ms = _time_ms(fn, args)
        err = float((got - want).abs().max())
        ref = float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= ATOL + RTOL * ref
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        say("kernel", name=name, check=repr(label), shape=tuple(got.shape),
            max_abs_err=f"{err:.3e}", max_abs_ref=f"{ref:.3e}",
            rel=f"{err / max(ref, 1e-30):.2e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", ok=ok)
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
                         checkpoint_dir=os.path.join(K.BUILD_DIR, "smoke_ckpt"))
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


def main() -> int:
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    card = phase_device()
    import torch

    phase_build()
    device = torch.device("cuda", 0)
    batches = make_batches(device)
    results = phase_kernels(batches[0])
    counts = phase_slice(batches, device, card)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": counts[name],
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
