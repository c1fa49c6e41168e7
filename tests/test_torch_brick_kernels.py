"""The brick layout's conv kernels, ``sparse.kernels.brick_gemm`` and
``brick_wgrad``, with the level's occupied slots (``valid``) and slot order
(``brick.slot_order``).  On the CPU: the masked twins against JAX
``brick_conv`` at levels 0 and 1 with k = 3 and k = 5 (values, dF at the
occupied slots, dW, the bias gradient); the masked twins exactly zero at the
empty slots, equal to the unmasked twins at the occupied ones and blind to
what the empty slots hold; the slot orders of a brick:2 pyramid (a
permutation, the occupied slots first, in brick order); the bounds check's
refusal of a broken order; the slot table against the plan and against the
kernel offsets.  On a card (``cuda``-marked): each kernel against its masked
twin at Cin 3, 6 (not a multiple of 4) and 32 to 96, at k = 5, on one
brick, on a level with no occupied slot, with and without the order, and
``brick_wgrad`` bit-equal from two launches.

Tolerances: against JAX, 1e-5 of the largest magnitude, as
``tests/test_torch_brick.py``'s ``_check`` (the same products summed in
another order); on the card, 1e-4 of the largest magnitude (f32 sums in
another order, as ``chip_smoke.py``'s RTOL); what the kernels skip and
zero, exactly.

JAX is imported inside a fixture (one ``jax.vjp`` per case), so the card's
machine, which has none, runs the ``cuda`` tests:  python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_brick_kernels.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.data.collate import check_pyramid_bounds
from pointcontrast_tpu_torch.sparse import brick, kernels
from pointcontrast_tpu_torch.sparse.kernel_map import kernel_offsets

NPADS = [560, 520, 300, 100, 40, 16]  # tests/test_torch_brick.py's fixture
CASES = [(0, 3, 5, 7), (0, 5, 6, 5), (1, 3, 5, 7), (1, 5, 4, 6)]  # level, k, Cin, Cout


def _coords(seed=0, n=(200, 150, 170), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def pyr():
    """A brick:2 pyramid of 5 levels (no truncation), on the host."""
    return brick.build_brick_pyramid(_coords(), num_levels=5, npads=NPADS, num_batch=3,
                                     brick_levels=2)[0]


def _feats(rng, valid, c):
    f = np.zeros((valid.shape[0], c), np.float32)
    f[valid > 0] = rng.randn(int((valid > 0).sum()), c)
    return f


def _case(pyr, level, k, cin, cout):
    """Numpy inputs of one case: features and cotangent zero at the empty
    slots, weights, bias, and the level's map, valid and order."""
    lv = pyr.levels[level]
    rng = np.random.RandomState(100 * level + 10 * k + cin)
    taps = brick.build_plan(k).num_taps
    return dict(f=_feats(rng, lv.valid, cin),
                w=rng.randn(taps, cin, cout).astype(np.float32) * 0.3,
                b=rng.randn(cout).astype(np.float32),
                ct=_feats(rng, lv.valid, cout),
                nbr=np.asarray(lv.nbr.nbr, np.int32), valid=lv.valid,
                order=lv.nbr.order, k=k)


@pytest.fixture(scope="module")
def jax_brick_conv(pyr):
    """JAX ``brick_conv``'s values and gradients (features, weights, bias)
    for every case of CASES."""
    import jax
    import jax.numpy as jnp

    from pointcontrast_tpu.sparse import brick as jbrick

    out = {}
    for case in CASES:
        c = _case(pyr, *case)
        plan, nbr = jbrick.build_plan(c["k"]), jnp.asarray(c["nbr"])

        def fn(f, w, b, plan=plan, nbr=nbr, valid=c["valid"]):
            return jbrick.brick_conv(f, nbr, w, plan, bias=b, valid_out=valid)

        y, vjp = jax.vjp(fn, *(jnp.asarray(c[n]) for n in ("f", "w", "b")))
        out[case] = (np.asarray(y), *(np.asarray(g) for g in vjp(jnp.asarray(c["ct"]))))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[f"L{c[0]}-k{c[1]}-{c[2]}to{c[3]}" for c in CASES])
def test_masked_twins_match_jax_brick_conv(pyr, jax_brick_conv, case):
    """``brick_conv`` with the level's valid and slot order (on the CPU:
    the masked twins) against JAX's custom-VJP brick conv."""
    c = _case(pyr, *case)
    jy, jdf, jdw, jdb = jax_brick_conv[case]
    f, w, b = (_t(c[n]).requires_grad_(True) for n in ("f", "w", "b"))
    kernels.reset_launches()
    y = brick.brick_conv(f, _t(c["nbr"]), w, brick.build_plan(c["k"]), bias=b,
                         valid_out=_t(c["valid"]), order=_t(c["order"]))
    y.backward(_t(c["ct"]))
    ok = c["valid"] > 0
    _close(y.detach().numpy(), jy, "values")
    assert np.all(y.detach().numpy()[~ok] == 0), "empty slots must stay exactly 0"
    _close(f.grad.numpy()[ok], jdf[ok], "dF")
    assert np.all(f.grad.numpy()[~ok] == 0), "dF is exactly 0 at the empty slots"
    _close(w.grad.numpy(), jdw, "dW")
    _close(b.grad.numpy(), jdb, "bias")
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("case", CASES, ids=[f"L{c[0]}-k{c[1]}-{c[2]}to{c[3]}" for c in CASES])
def test_masked_twins_skip_exactly_the_empty_slots(pyr, case):
    """With ``valid`` the twins give exact zeros at the empty slots, equal
    the unmasked twins bit for bit at the occupied ones (and in dW) when the
    empty slots hold zeros, and ignore what the empty slots hold."""
    c = _case(pyr, *case)
    steps = brick.slot_steps(brick.build_plan(c["k"]))
    taps = c["w"].shape[0]
    nbr, valid, order, w = _t(c["nbr"]), _t(c["valid"]), _t(c["order"]), _t(c["w"])
    f, ct = _t(c["f"]), _t(c["ct"])
    empty = valid == 0
    junk_f = torch.where(empty[:, None], torch.randn(f.shape, dtype=f.dtype), f)
    junk_ct = torch.where(empty[:, None], torch.randn(ct.shape, dtype=ct.dtype), ct)

    y = kernels.brick_gemm_plain(f, nbr, steps, w, valid, order)
    assert torch.all(y[empty] == 0)
    assert torch.equal(y[~empty], kernels.brick_gemm_plain(f, nbr, steps, w)[~empty])
    assert torch.equal(y, kernels.brick_gemm_plain(junk_f, nbr, steps, w, valid))
    assert torch.equal(y, kernels.brick_gemm(f, nbr, steps, w, valid, order))
    dw = kernels.brick_wgrad_plain(f, nbr, steps, ct, taps, valid, order)
    assert torch.equal(dw, kernels.brick_wgrad_plain(f, nbr, steps, ct, taps))
    assert torch.equal(dw, kernels.brick_wgrad_plain(junk_f, nbr, steps, junk_ct, taps, valid))
    assert torch.equal(dw, kernels.brick_wgrad(f, nbr, steps, ct, taps, valid, order))


@pytest.mark.parametrize("level", [0, 1])
def test_slot_orders_put_the_occupied_slots_first(pyr, level):
    """Each brick level's maps carry one slot order: a permutation of the
    [NB * 8] rows, the occupied slots first in brick order, as many as
    ``valid.sum()``; it moves to the device with the pyramid."""
    from pointcontrast_tpu_torch.data.collate import pyramid_to

    lv = pyr.levels[level]
    order, valid = lv.nbr.order, lv.valid
    n = int(valid.sum())
    assert order.dtype == np.int32 and order.shape == valid.shape
    assert np.array_equal(np.sort(order), np.arange(valid.shape[0]))
    assert np.all(valid[order[:n]] > 0) and np.all(valid[order[n:]] == 0)
    assert np.array_equal(order[:n], np.flatnonzero(valid))
    assert 0 < n < valid.shape[0]
    dev = pyramid_to(pyr, "cpu").levels[level].nbr
    assert dev.order.dtype == torch.int32 and np.array_equal(dev.order.numpy(), order)


def test_stem_map_of_k5_shares_the_slot_order():
    """A k = 5 stem (``conv0_kernel_size=5``) gets its own BrickMap on
    level 0, with the level's slot order."""
    tp = brick.build_brick_pyramid(_coords(1), num_levels=5, npads=NPADS, num_batch=3,
                                   conv0_kernel_size=5, brick_levels=2)[0]
    lv = tp.levels[0]
    assert lv.nbr0.plan.num_taps == 125
    assert np.array_equal(lv.nbr0.order, lv.nbr.order)
    check_pyramid_bounds(tp)


@pytest.mark.parametrize("fault", ["not a permutation", "out of range", "shape"])
def test_pyramid_bounds_refuse_a_broken_slot_order(pyr, fault):
    lv = pyr.levels[0]
    keep = lv.nbr.order
    bad = keep.copy()
    if fault == "not a permutation":
        bad[5] = bad[6]
    elif fault == "out of range":
        bad[5] = keep.shape[0]
    else:
        bad = bad[:-1]
    lv.nbr.order = bad
    try:
        with pytest.raises(ValueError, match="order"):
            check_pyramid_bounds(pyr)
    finally:
        lv.nbr.order = keep
    check_pyramid_bounds(pyr)


@pytest.mark.parametrize("k", [3, 5])
def test_slot_table_equals_the_plan(k):
    """``brick_slot_table``: table[t, p] = 8 d + s for every (d, s, p) at
    which ``slot_steps`` names tap t, and, from the kernel offsets alone,
    offset(t) + p = 2 offset(d) + s on each axis; the centre row is the
    zero offset's."""
    plan = brick.build_plan(k)
    steps = brick.slot_steps(plan)
    table, centre = kernels.brick_slot_table(steps, plan.num_taps)
    assert table.shape == (plan.num_taps, 8) and table.dtype == np.int32
    named = 0
    for d, is_centre, tm in steps:
        assert is_centre == (d == centre)
        for s in range(8):
            for p in range(8):
                if tm[s][p] >= 0:
                    assert table[tm[s][p], p] == 8 * d + s
                    named += 1
    assert named == table.size
    nbrs, offs = kernel_offsets(3, 3), kernel_offsets(k, 3)
    bits = np.array([[(v >> a) & 1 for a in range(3)] for v in range(8)])
    for t in range(plan.num_taps):
        for p in range(8):
            d, s = divmod(int(table[t, p]), 8)
            assert np.array_equal(offs[t] + bits[p], 2 * nbrs[d] + bits[s])
    assert not nbrs[centre].any()


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _on(card, c):
    return {n: (torch.from_numpy(np.ascontiguousarray(v)).to(card)
                if isinstance(v, np.ndarray) else v) for n, v in c.items()}


def _agree(got, want, what):
    torch.cuda.synchronize()
    scale = max(float(want.abs().max()), 1e-6)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale, msg=what)


def _hold(c, exact_zero=True):
    """brick_gemm (forward, and dF with W[rev]^T) and brick_wgrad against
    their masked twins on the card; the kernels' zeros and brick_wgrad's
    repeat exact."""
    plan = brick.build_plan(c["k"])
    steps = brick.slot_steps(plan)
    rev = list(brick._tap_reversal(plan))
    wrev = c["w"][rev].transpose(1, 2).contiguous()
    args = (c["nbr"], steps)
    kernels.reset_launches()
    for x, w in ((c["f"], c["w"]), (c["ct"], wrev)):
        got = kernels.brick_gemm(x, *args, w, c["valid"], c["order"])
        _agree(got, kernels.brick_gemm_plain(x, *args, w, c["valid"]), "brick_gemm")
        if exact_zero:
            assert torch.all(got[c["valid"] == 0] == 0)
        unordered = kernels.brick_gemm(x, *args, w, c["valid"])
        assert torch.equal(got, unordered), "the order changes no bit"
    dw = kernels.brick_wgrad(c["f"], *args, c["ct"], w.shape[0], c["valid"], c["order"])
    _agree(dw, kernels.brick_wgrad_plain(c["f"], *args, c["ct"], w.shape[0], c["valid"]),
           "brick_wgrad")
    again = kernels.brick_wgrad(c["f"], *args, c["ct"], w.shape[0], c["valid"], c["order"])
    assert torch.equal(dw, again), "brick_wgrad gives the same bits from two launches"
    assert kernels.launch_counts()["brick_gemm"] == 4
    assert kernels.launch_counts()["brick_wgrad"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("level,k,cin,cout", [(0, 3, 3, 32), (0, 3, 6, 20), (0, 3, 32, 32),
                                              (1, 3, 64, 64), (1, 3, 96, 128),
                                              (0, 5, 3, 32), (1, 5, 6, 5)])
def test_brick_kernels_match_masked_twins_on_card(pyr, card, level, k, cin, cout):
    _hold(_on(card, _case(pyr, level, k, cin, cout)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
def test_brick_kernels_on_one_brick(card, k):
    """A level whose only occupied brick holds 5 of its 8 slots (the other
    bricks are pad bricks)."""
    cell = np.array([[0, x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])[:5]
    pyr = brick.build_brick_pyramid(cell.astype(np.int32), num_levels=3, npads=[16, 8, 4, 2],
                                    num_batch=1, brick_levels=1)[0]
    lv = pyr.levels[0]
    assert int(lv.valid.sum()) == 5 and int((lv.valid.reshape(-1, 8) > 0).any(1).sum()) == 1
    rng = np.random.RandomState(k)
    taps = brick.build_plan(k).num_taps
    _hold(_on(card, dict(f=_feats(rng, lv.valid, 7), ct=_feats(rng, lv.valid, 9),
                         w=rng.randn(taps, 7, 9).astype(np.float32),
                         nbr=np.asarray(lv.nbr.nbr, np.int32), valid=lv.valid,
                         order=lv.nbr.order, k=k)))


@pytest.mark.cuda
def test_brick_kernels_on_a_level_with_no_occupied_slot(pyr, card):
    c = _case(pyr, 1, 3, 32, 32)
    c["valid"] = np.zeros_like(c["valid"])
    c["order"] = brick.slot_order(c["valid"])
    c["f"] = np.zeros_like(c["f"])
    c["ct"] = np.zeros_like(c["ct"])
    c = _on(card, c)
    _hold(c)
    steps = brick.slot_steps(brick.build_plan(3))
    y = kernels.brick_gemm(c["f"], c["nbr"], steps, c["w"], c["valid"], c["order"])
    dw = kernels.brick_wgrad(c["f"], c["nbr"], steps, c["ct"], 27, c["valid"], c["order"])
    assert not y.any() and not dw.any()
