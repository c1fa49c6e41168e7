"""The bf16 brick kernels against an older form of them, on the card, in
turns: ``brick_gemm_bf16`` and ``brick_wgrad_bf16`` of this tree (their
wrappers in ``sparse/kernels.py``) and the same two entries of another
``csrc/sparse_conv.cu`` (the parent commit's, say), built into its own
directory under the git-ignored ``_build/`` and loaded with ctypes beside
this tree's library.  The checks are ``chip_smoke.py``'s: every brick conv
shape of one forward of ``pretrain brick:2 bf16`` and ``semseg brick bf16``
(forward, dF on W[rev]^T, dW) and ``brick k5 shapes bf16``.  Each check is
timed as device-only ms (``chip_smoke._device_ms``) in the order this
tree, other, other, this tree, and both outputs are held to the check's
bound of the exact sum; ``--f32`` adds both sources' f32 kernels at the
same shapes in turns.  Prints one ``[turn]`` line a check, one ``[sum]``
line a path and kernel, then one JSON line.  The other source's brick
entries must be the slot-row form's: ``pc_brick_gemm`` and
``pc_brick_wgrad`` taking a ``bf16_`` flag.  From the repo's root, the
other source's csrc directory unpacked under a git-ignored directory
(e.g. ``git archive <rev> pointcontrast_tpu_torch/csrc | tar -x -C
_checkout/parent``):

    python3 scripts/brick_turns.py --other _checkout/parent/pointcontrast_tpu_torch/csrc

Where ``brick_gemm_bf16`` is the same code on both sides, its ratio is the
turns' spread (a control).  ``--reckon`` instead counts,
on the host and with no card, what each dW design reads and runs at these
paths' shapes (``reckon``)."""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PATHS = ("pretrain brick:2 bf16", "semseg brick bf16", "brick k5 shapes bf16")


def build_other(csrc: str):
    """Start compiling ``csrc``/sparse_conv.cu as ``cuda_build`` compiles the
    tree's, into ``_build/other/``; returns (process, library path)."""
    from pointcontrast_tpu_torch import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "other")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "sparse_conv_sm90a.so")
    cmd = [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib,
           os.path.join(csrc, "sparse_conv.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


class Other:
    """The other library's brick entries, called as the slot-row form's
    wrappers called them: the bf16 forms and (``bf16=False``) the f32
    kernels."""

    def __init__(self, path):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib = ctypes.CDLL(path)
        sigs = {"pc_brick_gemm": [vp, vp, ci, vp, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp],
                "pc_brick_wgrad": [vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                   ci, vp],
                "pc_gather_wgrad_tiles": [ci, ci, ci]}
        for name, argtypes in sigs.items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def brick_gemm_bf16(self, x, nbr, steps, w, valid=None, order=None, bf16=True):
        import torch

        from pointcontrast_tpu_torch.cuda_build import ptr, stream
        from pointcontrast_tpu_torch.sparse import kernels as K

        nb, (taps, cin, cout) = nbr.shape[1], w.shape
        table, centre = K._slot_table_on(steps, taps, x.device)
        out = torch.empty(nb * 8, cout, device=x.device, dtype=x.dtype)
        rc = self.lib.pc_brick_gemm(ptr(x), ptr(nbr), nbr.shape[0], ptr(table), taps, centre,
                                    ptr(w), ptr(valid), ptr(order), ptr(out), nb, cin, cout,
                                    int(bf16), stream())
        if rc:
            raise RuntimeError(f"other pc_brick_gemm: error {rc}")
        return out

    def brick_wgrad_bf16(self, x, nbr, steps, ct, num_taps, valid=None, order=None,
                         bf16=True):
        import torch

        from pointcontrast_tpu_torch.cuda_build import ptr, stream
        from pointcontrast_tpu_torch.sparse import kernels as K

        nb, cin, cout = nbr.shape[1], x.shape[1], ct.shape[1]
        table, centre = K._slot_table_on(steps, num_taps, x.device)
        rows = nb * 8
        tiles = self.lib.pc_gather_wgrad_tiles(cin, cout, int(bf16))
        slices = max(1, min(-(-rows // 256), -(-K.WGRAD_BLOCKS // (tiles * num_taps))))
        ws = tickets = None
        if slices > 1:
            ws = torch.empty(slices, num_taps, cin, cout, device=x.device)
            tickets = torch.zeros(tiles * num_taps, device=x.device, dtype=torch.int32)
        dw = torch.empty(num_taps, cin, cout, device=x.device)
        rc = self.lib.pc_brick_wgrad(ptr(x), ptr(nbr), ptr(table), num_taps, centre, ptr(ct),
                                     ptr(valid), ptr(order), ptr(dw), ptr(ws), ptr(tickets),
                                     nb, cin, cout, slices, int(bf16), stream())
        if rc:
            raise RuntimeError(f"other pc_brick_wgrad: error {rc}")
        return dw.to(torch.bfloat16) if bf16 else dw

    def brick_gemm(self, *args):
        return self.brick_gemm_bf16(*args, bf16=False)

    def brick_wgrad(self, *args):
        return self.brick_wgrad_bf16(*args, bf16=False)


def path_checks(device):
    """{path: [(kernel, label, args)]}: the bf16 brick checks of the three
    paths, as ``chip_smoke.py`` builds them."""
    import torch

    import chip_smoke as S
    from pointcontrast_tpu_torch.semseg.train import forward
    from pointcontrast_tpu_torch.tools import workload as W

    bf16 = torch.bfloat16
    out = {}
    b = S.make_batches(device, layout="brick:2")[0]
    model = W.pretrain_model(seed=0, dtype=bf16)
    calls = S.conv_calls(model, b.feats0, lambda m: m(b.feats0, b.pyramid0))
    out[PATHS[0]] = [c for c in S.conv_checks(model, None, calls=calls)
                     if c[0].startswith("brick")]
    out[PATHS[2]] = S.brick_k5_checks(b.pyramid0, b.feats0, bf16)
    del calls, model
    _, batch = S.make_semseg_batch(device, None, "brick", crf=False)
    model = W.semseg_model(seed=0, dtype=bf16)
    calls = S.conv_calls(model, batch.feats, lambda m: forward(m, batch))
    out[PATHS[1]] = [c for c in S.conv_checks(model, batch, calls=calls)
                     if c[0].startswith("brick")]
    return {p: [(name, label, args) for name, label, _, args in cs] for p, cs in out.items()}


def turns(checks, other, f32=False):
    """One ``[turn]`` line a check and [(path, kernel, label, this_ms,
    other_ms, f32_ms, other_f32_ms)], device ms each the mean of its two
    turns; ``f32``: the f32 kernels of both at the same shapes too (the
    widened operands), in turns, and their outputs bit-equal."""
    import torch

    import chip_smoke as S
    from pointcontrast_tpu_torch.sparse import kernels as K

    rows = []
    for path, cs in checks.items():
        for name, label, args in cs:
            mine, theirs = getattr(K, name), getattr(other, name)
            ratios = []
            for fn in (mine, theirs):
                got = fn(*args)
                torch.cuda.synchronize()
                ratios.append(K.bound_ratio(got, *getattr(K, S.BOUNDED[name])(*args)))
            t = [S._device_ms(fn, args) for fn in (mine, theirs, theirs, mine)]
            this_ms, other_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            f32_ms = other_f32_ms = None
            extra = {}
            if f32:
                wide, f = tuple(map(S._widened, args)), name.removesuffix("_bf16")
                mine32, theirs32 = getattr(K, f), getattr(other, f)
                same = S._equal(mine32(*wide), theirs32(*wide))
                u = [S._device_ms(fn, wide) for fn in (mine32, theirs32, theirs32, mine32)]
                f32_ms, other_f32_ms = (u[0] + u[3]) / 2, (u[1] + u[2]) / 2
                extra = {"f32_ms": f"{f32_ms:.4f}", "other_f32_ms": f"{other_f32_ms:.4f}",
                         "f32_ratio": f"{f32_ms / other_f32_ms:.4f}", "f32_bit_equal": same}
            S.say("turn", path=repr(path), kernel=name, check=repr(label),
                  this_ms=f"{this_ms:.4f}", other_ms=f"{other_ms:.4f}",
                  ratio=f"{this_ms / other_ms:.3f}",
                  turns="/".join(f"{v:.4f}" for v in t),
                  bound_ratio=f"{ratios[0]:.3e}", other_bound_ratio=f"{ratios[1]:.3e}", **extra)
            if max(ratios) > 1.0:
                raise AssertionError(f"{label}: outside the bound ({ratios})")
            rows.append((path, name, label, this_ms, other_ms, f32_ms, other_f32_ms))
    return rows


def main_card(args) -> int:
    import torch

    import chip_smoke as S
    from pointcontrast_tpu_torch import cuda_build

    if not torch.cuda.is_available():
        print("brick_turns needs a CUDA device (or --reckon)", file=sys.stderr)
        return 1
    card = S.phase_device()
    t0 = time.perf_counter()
    proc, lib = build_other(args.other)  # beside the tree's own build
    info = cuda_build.build(["sparse_conv"])
    _, err = proc.communicate(timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {args.other}/sparse_conv.cu:\n{err}")
    for which, text in (("this", info["sparse_conv"]["ptxas"]), ("other", err)):
        for entry, regs, stack, spills in S.ptxas_entries(text):
            if entry.startswith("brick"):
                S.say("ptxas", lib=which, kernel=entry, registers=regs, stack_bytes=stack,
                      spill_bytes=spills)
    other = Other(lib)
    S.say("build", seconds=f"{time.perf_counter() - t0:.1f}")
    device = torch.device("cuda", 0)
    rows = turns(path_checks(device), other, f32=args.f32)
    sums = {}
    for path, name, _, *ms in rows:
        s = sums.setdefault((path, name), [0.0] * 4)
        for i, v in enumerate(ms):
            s[i] += v or 0.0
    for (path, name), (a, b, c, d) in sums.items():
        S.say("sum", path=repr(path), kernel=name, this_ms=f"{a:.4f}", other_ms=f"{b:.4f}",
              ratio=f"{a / b:.3f}", **({"f32_ms": f"{c:.4f}", "other_f32_ms": f"{d:.4f}",
                                        "f32_ratio": f"{c / d:.4f}"} if args.f32 else {}))
    print(json.dumps({"card": card, "turns": [
        dict(zip(("path", "kernel", "check", "this_ms", "other_ms", "f32_ms", "other_f32_ms"),
                 r)) for r in rows]}))
    return 0


# Res16UNet34C's brick convs on the two brick levels, as chip_smoke.py's
# checks take them: (level, Cin, Cout); a dW check each
CONVS = ((0, 3, 32), (0, 128, 96), (0, 96, 96), (1, 32, 32), (1, 128, 96), (1, 96, 96))


def _q(cout, top, step):
    """The tile of ``step`` q columns (q <= top) that pads ``cout`` least,
    the larger on a tie (``gm::q_for``'s rule)."""
    best = 1
    for q in range(2, top + 1):
        if -(-cout // (step * q)) * step * q <= -(-cout // (step * best)) * step * best:
            best = q
    return step * best


def _level_facts(pyr_level, steps):
    """Per-level counts the dW designs read from, from the level's map and
    ``valid``: bricks, live bricks (an occupied slot), occupied slots, the
    live (tap, output slot) pairs, and the (brick, neighbour row) pairs
    whose bricks both hold an occupied slot."""
    from pointcontrast_tpu_torch.sparse.kernels import brick_slot_table

    nbr = np.asarray(pyr_level.nbr.nbr, np.int64)
    nb = nbr.shape[1]
    occ = np.asarray(pyr_level.valid).reshape(nb, 8) > 0
    live = occ.any(1)
    table, centre = brick_slot_table(steps, 27)
    src = lambda d: np.arange(nb) if d == centre else nbr[d]  # noqa: E731
    pairs = sum(int((occ[:, p] & occ[src(d), s]).sum())
                for t in range(27) for p in range(8) for d, s in [divmod(int(table[t, p]), 8)])
    return dict(nb=nb, live=int(live.sum()), occ=int(occ.sum()), pairs=pairs,
                live_nbrs=int(sum((live & live[src(d)]).sum() for d in range(nbr.shape[0]))))


def _designs(f, cin, cout):
    """{design: (L2 -> SM MB, tensor-core GFLOP)} of one dW check, the
    pairs' rows and the maps read a tap: the slot-row compaction (the
    order and valid a slot row, the table, the map and the source's valid
    an occupied one: 12 + 12 bytes), the pair form (Cin > 8: valid a
    (brick, slot), the map and the source's valid an occupied one: 4 + 8)
    and the brick form (Cin <= 8: one dense product a neighbour row over
    the live bricks' whole rows)."""
    pairs_bytes = f["pairs"] * (cin + cout) * 2
    mma = f["pairs"] * _q(cin, 4, 32) * _q(cout, 4, 32) * 2 / 1e9
    out = {"slot rows": ((pairs_bytes + 27 * (f["nb"] * 8 * 12 + f["occ"] * 12)) / 1e6, mma)}
    if cin <= 8:
        m, n = -(-8 * cin // 32) * 32, -(-8 * cout // 128) * 128
        out["bricks"] = (f["live_nbrs"] * 16 * (cin + cout) / 1e6,
                         f["live_nbrs"] * m * n * 2 / 1e9)
    else:
        out["bricks"] = ((pairs_bytes + 27 * (f["nb"] * 8 * 4 + f["occ"] * 8)) / 1e6, mma)
    return out


def reckon() -> int:
    """Print, for each brick dW check of both brick paths, what the
    slot-row form and this tree's forms read from L2 (MB: the pairs' rows
    and the maps) and their tensor-core products (GFLOP), from the paths'
    first host batches (no card)."""
    from pointcontrast_tpu_torch.sparse.brick import build_plan, slot_steps
    from pointcontrast_tpu_torch.tools import workload as W

    steps = slot_steps(build_plan(3))
    batches = {"pretrain brick:2": W.pretrain_batches(None, n_batches=1,
                                                      layout="brick:2")[0].pyramid0,
               "semseg brick": W.semseg_batch(W.SemsegScenes(), layout="brick").pyramid}
    rows = []
    for path, pyr in batches.items():
        facts = [_level_facts(pyr.levels[lv], steps) for lv in (0, 1)]
        for lv, f in enumerate(facts):
            print(f"[level] path={path!r} level={lv} " + " ".join(f"{k}={v}" for k, v in
                                                                   f.items()), flush=True)
        for lv, cin, cout in CONVS:
            for design, (mb, gflop) in _designs(facts[lv], cin, cout).items():
                rows.append(dict(path=path, level=lv, cin=cin, cout=cout, design=design,
                                 mb=mb, gflop=gflop))
                print("[reckon] " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                                             f"{k}={v!r}" if isinstance(v, str) else
                                             f"{k}={v}" for k, v in rows[-1].items()),
                      flush=True)
        for design in ("slot rows", "bricks"):
            d = [r for r in rows if r["path"] == path and r["design"] == design]
            print(f"[reckon sum] path={path!r} kernel=brick_wgrad_bf16 design={design!r} "
                  f"mb={sum(r['mb'] for r in d):.1f} gflop={sum(r['gflop'] for r in d):.1f}",
                  flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a csrc directory holding the older sparse_conv.cu")
    ap.add_argument("--f32", action="store_true", help="time the f32 kernels too")
    ap.add_argument("--reckon", action="store_true", help="the host-side reckoning only")
    args = ap.parse_args()
    if args.reckon:
        return reckon()
    if not args.other:
        ap.error("--other is needed on the card")
    return main_card(args)


if __name__ == "__main__":
    sys.exit(main())
