"""Training-step time of this checkout against another, in turns on one GPU.

    python -m pointcontrast_tpu_torch.tools.step_turns --base DIR
        [--app pretrain|votenet|semseg|resnet] [--backbone sparseconv|pointnet2]
        [--model NAME] [--crf] [--layout chunked|voxel|brick|brick:N]
        [--dtype float32|bfloat16] [--base-dtype float32|bfloat16]
        [--pairs 10] [--steps 5]

``DIR`` is another checkout of the repo, for example the parent commit
unpacked by ``git archive``, or this one (``--base .``) to compare two
dtypes.  One worker process runs ``profile_step``'s app (the
``tools.workload`` step, f32, TF32 off; ``--dtype bfloat16`` the nets'
bf16 activations, ``--base-dtype`` the base side's where it differs, and
then the base checkout must know ``--dtype`` too) on each checkout's
package, from the same seeded weights; both build their kernels and take
two warm-up steps.  Then they take turns, one at a time: a turn runs
``--steps`` steps of one side and reports its ms/step (host clock around
the steps and a ``torch.cuda.synchronize()``).  A pair is one turn of each
side; the side that goes first alternates.  After the pairs each side runs
one more turn with every kernel wrapper (a function with a ``launches``
counter) timed on the host clock where the package's modules import it
by name: the host ms a step spends in each wrapper, its checks and its
launch included.  Each worker also reports its peak device memory over its
turns (``torch.cuda.max_memory_allocated`` from the first turn on: the
steps' own peak, the warm-up's left out).

Prints one ``[turn]`` line a turn, one ``[wrapper]`` line a wrapper and
side, one ``[peak]`` line a side, then each side's median and quartiles,
the pairs this checkout won (ties count for neither), and a verdict on "this checkout's step is no
slower than the base's by more than ``BOUND``" (5%):

  met         its median is within the bound and the base's own quartile
              spread (over its median) is within it too, or every turn of
              this checkout is faster than every turn of the base;
  not met     its median is past the bound and the spread within it;
  unresolved  otherwise: the spread is wider than the bound.

Prints one JSON summary as its last line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

_TURN = "@@turn "
BOUND = 0.05


def _app_kwargs(args):
    model = {"semseg": args.model or "Res16UNet34C",
             "resnet": args.model or "ResNet18"}.get(args.app)
    kw = {"pretrain": {"layout": args.layout},
          "votenet": {"backbone": args.backbone},
          "semseg": {"model": model, "crf": args.crf, "layout": args.layout},
          "resnet": {"model": model}}.get(args.app, {})
    if args.dtype != "float32":  # an older checkout's apps take no dtype
        import torch

        kw["dtype"] = getattr(torch, args.dtype)
    return kw


def _timed_wrappers():
    """Replaces every kernel wrapper where the package's other modules call
    it with one that adds its host time and calls to a tally; returns
    ({name: [seconds, calls]}, a function that puts the originals back).
    The defining module keeps the original, so the launch counters still
    count."""
    tally, timed, patched = {}, {}, []

    def timer(fn):
        acc = tally.setdefault(fn.__name__, [0.0, 0])

        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[0] += time.perf_counter() - t0
                acc[1] += 1
        return call

    for mod in [m for name, m in sys.modules.items()
                if name.startswith("pointcontrast_tpu_torch.") and m is not None]:
        for attr, fn in list(vars(mod).items()):
            if (callable(fn) and hasattr(fn, "launches")
                    and getattr(fn, "__module__", None) != mod.__name__):
                timed.setdefault(fn, timer(fn))
                setattr(mod, attr, timed[fn])
                patched.append((mod, attr, fn))

    def restore():
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)
    return tally, restore


def _worker(args) -> int:
    """Runs the app of the checkout on PYTHONPATH; one turn per line of
    standard input ("run", or "wrappers" for the turn with the wrappers
    timed), one ``@@turn`` JSON line per turn on standard output."""
    import torch

    from pointcontrast_tpu_torch.tools import profile_step

    root = os.path.realpath(os.environ["PYTHONPATH"].split(os.pathsep)[0])
    if not os.path.realpath(profile_step.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {profile_step.__file__}, not the package in {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    app = profile_step.APPS[args.app](**_app_kwargs(args))
    m, state = profile_step._warm(app)
    print(_TURN + json.dumps({"ready": True}), flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k = 0
    for line in sys.stdin:
        cmd = line.strip()
        if cmd not in ("run", "wrappers"):
            break
        tally, restore = _timed_wrappers() if cmd == "wrappers" else (None, None)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            app.step(m, state, app.batches[k % len(app.batches)])
            k += 1
        torch.cuda.synchronize()
        reply = {"ms": 1e3 * (time.perf_counter() - t0) / args.steps,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if tally is not None:
            restore()
            reply["wrappers"] = {name: [1e3 * sec / args.steps, calls / args.steps]
                                 for name, (sec, calls) in tally.items() if calls}
        print(_TURN + json.dumps(reply), flush=True)
    return 0


def _turn(proc, cmd) -> dict:
    proc.stdin.write(cmd + "\n")
    proc.stdin.flush()
    return _reply(proc)


def _reply(proc) -> dict:
    for line in proc.stdout:
        if line.startswith(_TURN):
            return json.loads(line[len(_TURN):])
        sys.stdout.write(line)
    raise RuntimeError(f"worker exited with code {proc.wait()}")


def _quartiles(xs):
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"q1": q1, "median": med, "q3": q3}


def _verdict(this, base, bound) -> str:
    spread = (base["q3"] - base["q1"]) / base["median"]
    if max(this["all"]) < min(base["all"]):
        return "met"
    past = this["median"] > base["median"] * (1 + bound)
    if spread > bound:
        return "unresolved"
    return "not met" if past else "met"


def _compare(this, base, bound):
    wins = sum(a < b for a, b in zip(this, base))
    a, b = _quartiles(this), _quartiles(base)
    a["all"], b["all"] = this, base
    return {"this": a, "base": b, "this_wins": wins, "pairs": len(this),
            "base_spread": (b["q3"] - b["q1"]) / b["median"],
            "verdict": _verdict(a, b, bound)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--app", default="pretrain",
                    choices=("pretrain", "votenet", "semseg", "resnet"))
    ap.add_argument("--backbone", choices=("sparseconv", "pointnet2"),
                    default="sparseconv", help="votenet only")
    ap.add_argument("--model", help="semseg (default Res16UNet34C) and resnet "
                    "(default ResNet18)")
    ap.add_argument("--crf", action="store_true", help="semseg only")
    ap.add_argument("--layout", default="chunked",
                    help="pretrain and semseg: chunked, voxel, brick or brick:N")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the nets' activations (pretrain, votenet sparseconv, semseg)")
    ap.add_argument("--base-dtype", choices=("float32", "bfloat16"),
                    help="the base side's dtype (default: --dtype)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=5, help="steps a turn")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args)
    if args.base is None:
        ap.error("--base is required")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("step_turns needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"this": here, "base": os.path.abspath(args.base)}
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           *(argv if argv is not None else sys.argv[1:])]
    procs = {}
    try:
        for side, root in roots.items():
            env = dict(os.environ, PYTHONPATH=root)
            side_cmd = cmd + (["--dtype", args.base_dtype]
                              if side == "base" and args.base_dtype else [])
            procs[side] = subprocess.Popen(side_cmd, cwd=root, env=env, text=True,
                                           stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        for proc in procs.values():
            _reply(proc)  # built and warmed up
        ms = {"this": [], "base": []}
        for i in range(args.pairs):
            for side in (("this", "base") if i % 2 == 0 else ("base", "this")):
                ms[side].append(_turn(procs[side], "run")["ms"])
                print(f"[turn] pair={i} side={side} ms_per_step={ms[side][-1]:.3f}",
                      flush=True)
        last = {side: _turn(proc, "wrappers") for side, proc in procs.items()}
        wrappers = {side: reply["wrappers"] for side, reply in last.items()}
        peak = {side: reply["peak_gib"] for side, reply in last.items()}
        for side, gib in peak.items():
            print(f"[peak] side={side} peak_mem_gib={gib:.4f}", flush=True)
        for side, tally in wrappers.items():
            for name, (host_ms, calls) in sorted(tally.items()):
                print(f"[wrapper] side={side} {name} host_ms_per_step={host_ms:.3f} "
                      f"calls_per_step={calls:g}", flush=True)
            print(f"[wrapper] side={side} all host_ms_per_step="
                  f"{sum(v[0] for v in tally.values()):.3f}", flush=True)
        for proc in procs.values():
            proc.stdin.write("stop\n")
            proc.stdin.close()
            if proc.wait(timeout=120) != 0:
                raise RuntimeError(f"worker exited with code {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    summary = {"app": args.app, "layout": args.layout, "model": args.model,
               "dtype": args.dtype, "base_dtype": args.base_dtype or args.dtype,
               "backbone": args.backbone if args.app == "votenet" else None,
               "card": card, "steps_per_turn": args.steps, "bound": BOUND,
               "ms_per_step": _compare(ms["this"], ms["base"], BOUND),
               "peak_mem_gib": peak,
               "wrapper_host_ms_per_step": wrappers}
    c = summary["ms_per_step"]
    print(f"[ms_per_step] this median {c['this']['median']:.3f} "
          f"(q1 {c['this']['q1']:.3f}, q3 {c['this']['q3']:.3f}) base median "
          f"{c['base']['median']:.3f} (q1 {c['base']['q1']:.3f}, q3 "
          f"{c['base']['q3']:.3f}) this wins {c['this_wins']}/{c['pairs']} "
          f"base spread {c['base_spread']:.4f} verdict {c['verdict']}", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
