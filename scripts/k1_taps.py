"""K1, the same-level conv, past 32 taps on the card: a k = 5 stem (125
taps) on a chunked and on a flat (voxel) pyramid, in f32 and bf16, forward
and backward through the kernels, against the same pass through their
plain twins.  Each case prints whether the kernels took it, their launches
and the largest error of the output and of dW over their largest
magnitude, then one JSON line of all cases.  Uses only APIs that the port
has had since its flat layout, so it also runs against an older checkout
of the package: the one first on ``PYTHONPATH``.  From the repo's root:

    PYTHONPATH=. python3 scripts/k1_taps.py
"""
from __future__ import annotations

import json
import sys

import numpy as np


def _coords(seed=0, n=(3000, 2500), extent=40):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _stem_map(layout, device):
    """(nbr0 [125, B, S] int32, rev0, valid [B*S], live order [B, S]) of a
    two-level pyramid with a k = 5 stem, as the ops take it."""
    from pointcontrast_tpu_torch.data.collate import check_pyramid_bounds, pyramid_to
    from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
    from pointcontrast_tpu_torch.sparse.topology import build_pyramid

    c = _coords()
    if layout == "chunked":
        pyr = build_chunked_pyramid(c, 2, [4096, 4096], num_batch=2, conv0_kernel_size=5)[0]
    else:
        pyr = build_pyramid(c, 2, npads=[8192, 8192], num_batch=2, conv0_kernel_size=5)[0]
    check_pyramid_bounds(pyr)
    lv = pyramid_to(pyr, device).levels[0]
    return lv.nbr0, lv.rev0, lv.valid, lv.nbr0_order


def _case(layout, dtype, device):
    import torch

    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.sparse import ops
    from pointcontrast_tpu_torch.tools.workload import plain_ops

    nbr, rev, valid, order = _stem_map(layout, device)
    gen = torch.Generator(device=device).manual_seed(0)
    n, k = valid.shape[0], nbr.shape[0]
    f = (torch.randn(n, 16, device=device, generator=gen) * valid[:, None]).to(dtype)
    w = (0.1 * torch.randn(k, 16, 32, device=device, generator=gen)).to(dtype)
    ct = (torch.randn(n, 32, device=device, generator=gen) * valid[:, None]).to(dtype)

    def run():
        fw = w.clone().requires_grad_()
        out = ops.sparse_conv(f, nbr, fw, valid_out=valid, rev=rev, order=order)
        out.backward(ct)
        return out.detach(), fw.grad

    result = {"layout": layout, "dtype": str(dtype).removeprefix("torch."), "taps": k}
    K.reset_launches()
    try:
        got = run()
        if device.type == "cuda":
            torch.cuda.synchronize()
    except ValueError as e:  # a launch refused the tap count
        result.update(ok=False, refused=str(e))
        return result
    result["launches"] = {name: c for name, c in K.launch_counts().items() if c}
    with plain_ops():
        want = run()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    result.update(ok=True, out_rel=rel(got[0], want[0]), dw_rel=rel(got[1], want[1]))
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_taps needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    results = []
    for layout in ("chunked", "voxel"):
        for dtype in (torch.float32, torch.bfloat16):
            r = _case(layout, dtype, device)
            print("[k1 taps] " + " ".join(f"{key}={v}" for key, v in r.items()), flush=True)
            results.append(r)
    print(json.dumps({"k1_taps": results, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
