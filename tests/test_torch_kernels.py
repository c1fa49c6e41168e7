"""The kernel wrappers of ``pointcontrast_tpu_torch.sparse.kernels``: their
CPU contract here, and each CUDA kernel against its plain twin on a card.

This file imports no JAX, so the card's machine (which has none) runs its
``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kernels.py"""
import numpy as np
import pytest
import torch

from pointcontrast_tpu_torch.sparse import kernels
from pointcontrast_tpu_torch.sparse.brick import build_plan, slot_steps
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid

NPADS = [512, 512, 480, 96, 30]


def _coords(rng, num_batch=3, n_per=(150, 90, 120), extent=24):
    out = []
    for b in range(num_batch):
        flat = rng.choice(extent ** 3, n_per[b], replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((n_per[b], 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def pyr():
    pyr, _, _, orphan = build_chunked_pyramid(_coords(np.random.RandomState(0)),
                                              5, NPADS, num_batch=3)
    assert not orphan.any()
    return pyr


def _feats(rng, valid, c):
    f = np.zeros((valid.shape[0], c), np.float32)
    f[valid > 0] = rng.randn(int(valid.sum()), c)
    return f


def _idx(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def test_cpu_wrappers_run_plain_twins_without_counting(pyr):
    """On CPU tensors a wrapper is its plain twin and launches nothing."""
    rng = np.random.RandomState(4)
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    b_ = 3
    x3 = torch.from_numpy(_feats(rng, lv.valid, 4)).reshape(b_, -1, 4)
    x1 = torch.from_numpy(_feats(rng, lv1.valid, 4)).reshape(b_, -1, 4)
    w = torch.from_numpy(rng.randn(27, 4, 6).astype(np.float32))
    nbr, upp, upo = _idx(lv.nbr), _idx(lv.up_parent), _idx(lv.up_offset)
    s, s1 = x3.shape[1], x1.shape[1]
    taps = list(range(27))
    g3 = torch.from_numpy(rng.randn(b_, s, 6).astype(np.float32))
    calls = [
        (kernels.gather_gemm, kernels.gather_gemm_plain,
         (x3, nbr, taps, 0, w, None, s)),
        (kernels.gather_wgrad, kernels.gather_wgrad_plain,
         (x3, None, None, 0, g3, nbr, taps, 0, 27, s)),
        (kernels.parent_gemm, kernels.parent_gemm_plain, (x1, upp, upo, w[:8])),
        (kernels.scatter_parent, kernels.scatter_parent_plain,
         (g3, upp, upo, 8, s1)),
        (kernels.scatter_gemm, kernels.scatter_gemm_plain,
         (g3, nbr, taps, w, s, s - 1)),
        (kernels.segment_sum, kernels.segment_sum_plain,
         (x3.reshape(-1, 4), _idx(lv.batch), b_ + 1)),
        (kernels.gather_sum, kernels.gather_sum_plain,
         (x3, _idx(lv.down_nbr), range(8), 0, s1)),
        (kernels.scatter_sum, kernels.scatter_sum_plain,
         (x3, upp[None], [0], 0, s1, s1 - 1)),
    ]
    bf = torch.bfloat16
    x3b, x1b, wb, g3b = x3.to(bf), x1.to(bf), w.to(bf), g3.to(bf)
    calls += [
        (kernels.gather_gemm_bf16, kernels.gather_gemm_bf16_plain,
         (x3b, nbr, taps, 0, wb, None, s)),
        (kernels.gather_wgrad_bf16, kernels.gather_wgrad_bf16_plain,
         (x3b, None, None, 0, g3b, nbr, taps, 0, 27, s)),
        (kernels.parent_gemm_bf16, kernels.parent_gemm_bf16_plain,
         (x1b, upp, upo, wb[:8])),
        (kernels.scatter_parent_bf16, kernels.scatter_parent_bf16_plain,
         (g3b, upp, upo, 8, s1)),
        (kernels.scatter_gemm_bf16, kernels.scatter_gemm_bf16_plain,
         (g3b, nbr, taps, wb, s, s - 1)),
        (kernels.gather_sum_bf16, kernels.gather_sum_bf16_plain,
         (x3b, _idx(lv.down_nbr), range(8), 0, s1)),
        (kernels.scatter_sum_bf16, kernels.scatter_sum_bf16_plain,
         (x3b, upp[None], [0], 0, s1, s1 - 1, _idx(lv.down_nbr))),
    ]
    # the brick forms on two bricks, every neighbour row the first brick
    steps = slot_steps(build_plan(3))
    bnbr, xb = torch.zeros(27, 2, dtype=torch.int32), x3b.reshape(-1, 4)[:16]
    calls += [
        (kernels.brick_gemm_bf16, kernels.brick_gemm_bf16_plain, (xb, bnbr, steps, wb)),
        (kernels.brick_wgrad_bf16, kernels.brick_wgrad_bf16_plain,
         (xb, bnbr, steps, g3b.reshape(-1, 6)[:16], 27)),
    ]
    kernels.reset_launches()
    for fn, plain, args in calls:
        torch.testing.assert_close(fn(*args), plain(*args), rtol=0, atol=0)
    assert kernels.launch_counts() == {
        "gather_gemm": 0, "gather_wgrad": 0, "parent_gemm": 0,
        "scatter_parent": 0, "scatter_gemm": 0, "segment_sum": 0,
        "gather_sum": 0, "scatter_sum": 0, "brick_gemm": 0, "brick_wgrad": 0,
        "gather_gemm_bf16": 0, "gather_wgrad_bf16": 0, "parent_gemm_bf16": 0,
        "scatter_parent_bf16": 0, "scatter_gemm_bf16": 0, "gather_sum_bf16": 0,
        "scatter_sum_bf16": 0, "brick_gemm_bf16": 0, "brick_wgrad_bf16": 0}


@pytest.mark.parametrize("case", ["map_rows", "tap_range", "stacked_overrun",
                                  "weight_cin", "parent_shape", "wgrad_batch"])
def test_wrappers_reject_operands_that_overrun_their_tables(pyr, case):
    """The CUDA kernels read through raw pointers, so every wrapper checks
    that its maps, taps and stacked blocks stay inside the tables it is
    given, on any device."""
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, lv1.valid.shape[0] // b_
    x0, x1 = torch.zeros(b_, s0, 4), torch.zeros(b_, s1, 4)
    w27, w8 = torch.zeros(27, 4, 6), torch.zeros(8, 4, 6)
    nbr, upp, upo = _idx(lv.nbr), _idx(lv.up_parent), _idx(lv.up_offset)
    taps = list(range(27))
    calls = {
        "map_rows": lambda: kernels.gather_gemm(x0[:, 1:], nbr, taps, 0, w27,
                                                None, s0 - 1),
        "tap_range": lambda: kernels.gather_gemm(x0, nbr, taps[1:] + [27], 0,
                                                 w27, None, s0),
        "stacked_overrun": lambda: kernels.gather_gemm(x1, None, None, s1, w8,
                                                       None, s1),
        "weight_cin": lambda: kernels.gather_gemm(x0, nbr, taps, 0,
                                                  torch.zeros(27, 5, 6), None, s0),
        "parent_shape": lambda: kernels.parent_gemm(x1, upp[:2], upo, w8),
        "wgrad_batch": lambda: kernels.gather_wgrad(x0, None, None, 0, x0[:2],
                                                    nbr, taps, 0, 27, s0),
    }
    with pytest.raises(ValueError):
        calls[case]()


def test_plain_twins_agree_with_dense_definitions(pyr):
    """The twins' index conventions, spelt out row by row on a tiny case:
    taps read map rows, stacked tables read j * tap_stride + s."""
    rng = np.random.RandomState(6)
    lv = pyr.levels[3]
    b_, s = 3, lv.valid.shape[0] // 3
    x = torch.from_numpy(rng.randn(b_, s, 2).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 2, 3).astype(np.float32))
    nbr = _idx(lv.nbr)
    got = kernels.gather_gemm_plain(x, nbr, [5, 9], 0, w, None, s)
    want = torch.zeros(b_, s, 3)
    for b in range(b_):
        for r in range(s):
            for j, t in enumerate([5, 9]):
                want[b, r] += x[b, nbr[t, b, r]] @ w[j]
    torch.testing.assert_close(got, want)
    stacked = kernels.gather_gemm_plain(x, None, None, s // 2, w, None, s // 2)
    want = x[:, : s // 2] @ w[0] + x[:, s // 2: 2 * (s // 2)] @ w[1]
    torch.testing.assert_close(stacked, want)


def test_scatter_twins_agree_with_dense_definitions(pyr):
    """scatter_gemm adds ct W^T into the rows the map names (skipping one
    row), the adjoint of gather_gemm; segment_sum adds rows by id."""
    rng = np.random.RandomState(7)
    lv = pyr.levels[3]
    b_, s = 3, lv.valid.shape[0] // 3
    nbr = _idx(lv.nbr)
    g = torch.from_numpy(rng.randn(b_, s, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 2, 3).astype(np.float32))
    got = kernels.scatter_gemm_plain(g, nbr, [5, 9], w, s, s - 1)
    want = torch.zeros(b_, s, 2)
    for b in range(b_):
        for r in range(s):
            for j, t in enumerate([5, 9]):
                if nbr[t, b, r] != s - 1:
                    want[b, nbr[t, b, r]] += g[b, r] @ w[j].T
    torch.testing.assert_close(got, want)
    x = torch.from_numpy(rng.randn(b_, s, 2).astype(np.float32))
    fwd = kernels.gather_gemm_plain(x, nbr, [5, 9], 0, w, None, s)
    adj = kernels.scatter_gemm_plain(g, nbr, [5, 9], w, s, -1)
    torch.testing.assert_close((fwd * g).sum(), (x * adj).sum())
    seg = _idx(lv.batch)
    rows = torch.from_numpy(rng.randn(b_ * s, 2).astype(np.float32))
    want = torch.stack([rows[seg == i].sum(0) for i in range(b_ + 1)])
    torch.testing.assert_close(kernels.segment_sum_plain(rows, seg, b_ + 1), want)


@pytest.mark.cuda
def test_kernels_match_plain_twins_on_card(pyr):
    """Each CUDA kernel against its plain twin on the card (f32, TF32 off),
    counting one launch per kernel call.  chip_smoke.py repeats this at the
    pretraining step's full shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, lv1.valid.shape[0] // b_
    x0 = torch.randn(b_, s0, 3, device=dev, generator=gen)
    x1 = torch.randn(b_, s1, 5, device=dev, generator=gen)
    w27 = torch.randn(27, 3, 8, device=dev, generator=gen)
    w8 = torch.randn(8, 5, 8, device=dev, generator=gen)
    nbr, down = _idx(lv.nbr).to(dev), _idx(lv.down_nbr).to(dev)
    upp, upo = _idx(lv.up_parent).to(dev), _idx(lv.up_offset).to(dev)
    calls = [
        (kernels.gather_gemm, (x0, nbr, list(range(27)), 0, w27, None, s0)),
        (kernels.gather_gemm, (x0, nbr, list(range(1, 27)), 0, w27[1:],
                               w27[0], s0)),
        (kernels.gather_wgrad, (x0, None, None, 0, x0, nbr, list(range(27)),
                                0, 27, s0)),
        (kernels.gather_wgrad, (x0, down, list(range(8)), 0, x1, None, None,
                                0, 8, s1)),
        (kernels.parent_gemm, (x1, upp, upo, w8)),
        (kernels.scatter_parent, (torch.randn(b_, s0, 5, device=dev, generator=gen),
                                  upp, upo, 8, s1)),
        (kernels.gather_gemm, (x0, down, list(range(8)), 0,
                               torch.randn(8, 3, 4, device=dev, generator=gen),
                               None, s1)),
        (kernels.scatter_gemm, (torch.randn(b_, s0, 8, device=dev, generator=gen),
                                nbr, list(range(27)), w27, s0, s0 - 1)),
        (kernels.segment_sum, (x0.reshape(-1, 3), _idx(lv.batch).to(dev), b_ + 1)),
        (kernels.segment_sum, (torch.randn(b_ * s0, 70, device=dev, generator=gen),
                               _idx(lv.batch).to(dev), b_ + 1)),
        # float4 rows (C % 4 == 0), scalar rows (C = 3) and the counts (C = 1)
        (kernels.gather_sum, (torch.randn(b_, s0, 8, device=dev, generator=gen),
                              down, range(8), 0, s1)),
        (kernels.gather_sum, (x0, down, range(8), 0, s1)),
        (kernels.gather_sum, (x0[..., :1].contiguous(), down, [2, 5], 0, s1)),
        (kernels.gather_sum, (x1, upp[None], [0], 0, s0)),
        (kernels.scatter_sum, (torch.randn(b_, s0, 8, device=dev, generator=gen),
                               upp[None], [0], 0, s1, s1 - 1)),
        (kernels.scatter_sum, (x1, down, range(8), 0, s0, -1)),
    ]
    kernels.reset_launches()
    for fn, args in calls:
        got = fn(*args)
        want = getattr(kernels, fn.__name__ + "_plain")(*args)
        torch.cuda.synchronize()
        if fn is kernels.gather_sum:  # the same additions in the same order
            assert torch.equal(got, want)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert sum(kernels.launch_counts().values()) == len(calls)


@pytest.mark.cuda
def test_brick_kernels_match_plain_twins_on_card():
    """brick_gemm (plans of kernel 3 and 5, Cin 3 and 37, Cout 20 and 40:
    ragged channel tiles) and brick_wgrad against their plain twins on the
    card, one launch a call.  chip_smoke.py repeats this at the brick
    paths' full shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from pointcontrast_tpu_torch.sparse import brick

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    pyr = brick.build_brick_pyramid(_coords(np.random.RandomState(1)), 3,
                                    [512, 480, 200, 60], num_batch=3,
                                    brick_levels=2)[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    calls = []
    for level, k, cin, cout in ((0, 3, 3, 20), (0, 5, 37, 40), (1, 3, 32, 32)):
        lv = pyr.levels[level]
        valid = torch.from_numpy(lv.valid).to(dev)[:, None]
        nbr = _idx(lv.nbr.nbr).to(dev)
        steps = brick.slot_steps(brick.build_plan(k))
        taps = brick.build_plan(k).num_taps
        x = torch.randn(valid.shape[0], cin, device=dev, generator=gen) * valid
        ct = torch.randn(valid.shape[0], cout, device=dev, generator=gen) * valid
        w = torch.randn(taps, cin, cout, device=dev, generator=gen)
        calls += [(kernels.brick_gemm, (x, nbr, steps, w)),
                  (kernels.brick_wgrad, (x, nbr, steps, ct, taps))]
    kernels.reset_launches()
    for fn, args in calls:
        got = fn(*args)
        want = getattr(kernels, fn.__name__ + "_plain")(*args)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
    assert kernels.launch_counts()["brick_gemm"] == 3
    assert kernels.launch_counts()["brick_wgrad"] == 3
