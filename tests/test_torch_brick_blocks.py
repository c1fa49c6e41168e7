"""The bf16 brick dW's two forms: ``brick_wgrad_bf16`` on the tensor cores
compacts each tap's live pairs brick by brick, reading the occupied slots
from the level's ``valid`` (the pair form, Cin > 8), and up to
``kernels.BRICK_NARROW`` input channels multiplies whole bricks a
neighbour row, the empty slots' channels loaded as zeros (the brick form,
JAX's own block product).  ``brick_gemm_bf16`` runs the f32 kernel's slot-row
tiles, held here to the same bounds.  On the CPU:

  - both dW schemes emulated in float64 from the map and ``valid`` (the
    pair form's live pairs a tap; the brick form's masked products a
    neighbour row, gathered into taps from the slot table), with and
    without non-zero values at the empty slots, equal to the twin, at k =
    3 and 5, brick:1 and brick:2, roomy and truncating pyramids;
  - the bounds ``brick_gemm_bf16_bound`` / ``brick_wgrad_bf16_bound``
    refusing three wrong outputs each: a tap left out, a neighbour brick
    swapped, every product rounded to bf16 before the sum.

On a card (``cuda``-marked): both kernels against their twins within the
bound at Cin 3, 6, 32, 64 and 128 (the brick form up to Cin 8, the pair
form past it), at k = 5, on one brick and on a level with no occupied slot,
with and without the slot order, with non-zero values at the empty slots;
the same bits from two launches; one launch a call.  No JAX import, so the
card's machine, which has none, runs the ``cuda`` tests:  python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_brick_blocks.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.sparse import brick
from pointcontrast_tpu_torch.sparse import kernels as sk

BF = torch.bfloat16
ROOMY = [560, 520, 300, 100, 40, 16]  # tests/test_torch_brick_kernels.py's
TIGHT = [560, 300, 110, 40, 16, 8]  # levels 1 and up drop coarse voxels


def _coords(seed=0, n=(200, 150, 170), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def pyramids():
    """{(brick levels, npads name): host pyramid} of one cloud."""
    return {(bl, name): brick.build_brick_pyramid(_coords(), num_levels=5, npads=npads,
                                                  num_batch=3, brick_levels=bl)[0]
            for bl in (1, 2) for name, npads in (("roomy", ROOMY), ("tight", TIGHT))}


def _levels(pyr):
    return [lv for lv in pyr.levels if isinstance(lv.nbr, brick.BrickMap)]


def _operands(lv, k, cin, cout, seed, dtype=torch.float64, junk=False):
    """x and ct zero at the empty slots (``junk``: random there too),
    weights, the level's map, valid and slot order, as tensors."""
    rng = np.random.RandomState(seed)
    valid = lv.valid > 0
    keep = np.ones_like(valid) if junk else valid
    x = rng.randn(valid.shape[0], cin) * keep[:, None]
    ct = rng.randn(valid.shape[0], cout) * keep[:, None]
    taps = brick.build_plan(k).num_taps
    w = rng.randn(taps, cin, cout) * (2.0 / (taps * cin)) ** 0.5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(x=t(x).to(dtype), ct=t(ct).to(dtype), w=t(w).to(dtype),
                nbr=t(np.asarray(lv.nbr.nbr, np.int32)), valid=t(lv.valid),
                order=t(lv.nbr.order), steps=brick.slot_steps(brick.build_plan(k)), taps=taps)


def _emulate(c):
    """The two dW schemes in float64 from the map and ``valid``: (pair
    form, brick form)."""
    x, ct, nbr = c["x"], c["ct"], c["nbr"].long()
    nb, taps, k3 = nbr.shape[1], c["taps"], nbr.shape[0]
    cin, cout = x.shape[1], ct.shape[1]
    occ = (c["valid"] != 0).reshape(nb, 8)
    table, centre = sk.brick_slot_table(c["steps"], taps)
    src = lambda d: torch.arange(nb) if d == centre else nbr[d]  # noqa: E731
    x3, ct3 = x.reshape(nb, 8, cin), ct.reshape(nb, 8, cout)
    # the pair form: brick b's output slot p and its source (d, s) at tap t
    # both occupied; the rows as they are (a live pair's rows are occupied)
    pair = torch.zeros(taps, cin, cout, dtype=x.dtype)
    for t in range(taps):
        for p in range(8):
            d, s = divmod(int(table[t, p]), 8)
            live = occ[:, p] & occ[src(d), s]
            pair[t] += x3[src(d)[live], s].T @ ct3[live, p]
    # the brick form: R_d = sum over the bricks b and their neighbours
    # nbr[d, b], both holding an occupied slot, of the masked whole rows
    xb = (x3 * occ[..., None]).reshape(nb, 8 * cin)
    cb = (ct3 * occ[..., None]).reshape(nb, 8 * cout)
    r_d = []
    for d in range(k3):
        both = occ.any(1) & occ[src(d)].any(1)
        r_d.append(xb[src(d)[both]].T @ cb[both])
    dense = torch.zeros(taps, cin, cout, dtype=x.dtype)
    for t in range(taps):
        for p in range(8):
            d, s = divmod(int(table[t, p]), 8)
            dense[t] += r_d[d][s * cin:(s + 1) * cin, p * cout:(p + 1) * cout]
    return pair, dense


@pytest.mark.parametrize("bl,npads,k,level", [(2, "tight", 3, 0), (2, "tight", 3, 1),
                                              (2, "tight", 5, 0), (2, "roomy", 3, 0),
                                              (2, "roomy", 5, 1), (1, "tight", 3, 0),
                                              (1, "roomy", 5, 0), (1, "roomy", 3, 0)])
def test_kernel_schemes_are_the_twins(pyramids, bl, npads, k, level):
    """The pair form's dW over the live pairs and the brick form's (whole
    bricks, their empty slots zeroed, gathered into taps from the slot
    table) equal the twin in float64, also where x and ct hold values at
    the empty slots (the twin masks them)."""
    lv = _levels(pyramids[(bl, npads)])[level]
    for junk in (False, True):
        c = _operands(lv, k, 5, 7, seed=10 * k + level, junk=junk)
        pair, dense = _emulate(c)
        ref = sk.brick_wgrad_plain(c["x"], c["nbr"], c["steps"], c["ct"], c["taps"],
                                   c["valid"])
        torch.testing.assert_close(pair, ref, rtol=0, atol=1e-12)
        torch.testing.assert_close(dense, ref, rtol=0, atol=1e-12)


def _bf16(c):
    return {n: v.to(BF) if torch.is_tensor(v) and v.is_floating_point() and n != "valid" else v
            for n, v in c.items()}


@pytest.mark.parametrize("control", ["tap left out", "neighbour swapped",
                                     "products rounded"])
@pytest.mark.parametrize("kernel", ["gemm", "wgrad"])
def test_bounds_refuse_wrong_outputs(pyramids, kernel, control):
    """Three outputs a broken kernel could give, each outside its bound (the
    twin itself inside): the centre tap never added; one live brick's two
    live neighbours swapped; every bf16 x bf16 product rounded to bf16
    before an exact sum (rounded once more)."""
    c = _bf16(_operands(_levels(pyramids[(2, "roomy")])[0], 3, 16, 8, seed=7))
    x, ct, w, nbr, valid, steps, taps = (c[n] for n in ("x", "ct", "w", "nbr", "valid",
                                                        "steps", "taps"))
    if kernel == "gemm":
        bound = sk.brick_gemm_bf16_bound(x, nbr, steps, w, valid)
        twin = lambda nbr_=nbr, w_=w: sk.brick_gemm_bf16_plain(x, nbr_, steps, w_, valid)  # noqa
    else:
        bound = sk.brick_wgrad_bf16_bound(x, nbr, steps, ct, taps, valid)
        twin = lambda nbr_=nbr, w_=None: sk.brick_wgrad_bf16_plain(  # noqa: E731
            x, nbr_, steps, ct, taps, valid)
    assert sk.bound_ratio(twin(), *bound) <= 1.0
    if control == "tap left out":
        if kernel == "gemm":
            wrong = twin(w_=torch.where(torch.arange(taps)[:, None, None] == taps // 2, 0, w))
        else:
            wrong = twin().clone()
            wrong[taps // 2] = 0
    elif control == "neighbour swapped":
        occ = (valid.reshape(-1, 8) > 0).any(1)
        live = occ[nbr.long()] & occ[None]  # [K3, NB] a live brick's live neighbours
        live[nbr.shape[0] // 2] = False
        b = int(torch.nonzero(live.sum(0) >= 2)[0])
        d1, d2 = (int(d) for d in torch.nonzero(live[:, b])[:2, 0])
        bad = nbr.clone()
        bad[d1, b], bad[d2, b] = nbr[d2, b], nbr[d1, b]
        wrong = twin(nbr_=bad)
    else:
        x64, w64 = x.double(), w.double()
        nb = nbr.shape[1]
        x3 = (x64 * (valid > 0)[:, None]).reshape(nb, 8, -1)
        table, centre = sk.brick_slot_table(steps, taps)
        out = torch.zeros(nb, 8, w.shape[2] if kernel == "gemm" else 1, dtype=torch.float64)
        dw = torch.zeros(taps, x.shape[1], ct.shape[1], dtype=torch.float64)
        ct3 = (ct.double() * (valid > 0)[:, None]).reshape(nb, 8, -1)
        for t in range(taps):
            for p in range(8):
                d, s = divmod(int(table[t, p]), 8)
                src = x3[:, s] if d == centre else x3[nbr[d].long(), s]
                src = src * (valid.reshape(nb, 8)[:, p] > 0)[:, None]
                if kernel == "gemm":
                    prod = (src[:, :, None] * w64[t][None]).to(BF).double()
                    out[:, p] += prod.sum(1)
                else:
                    dw[t] += (src[:, :, None] * ct3[:, p, None, :]).to(BF).double().sum(0)
        wrong = (out.reshape(nb * 8, -1) if kernel == "gemm" else dw).to(BF)
    assert sk.bound_ratio(wrong, *bound) > 1.0


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _hold_on_card(c, dev):
    """Both kernels on the card, with the slot order and without it: within
    their bounds, zeros at the empty slots, the forward the same bits
    whatever the order, each the same bits from two launches, one launch a
    call."""
    c = {n: v.to(dev) if torch.is_tensor(v) else v for n, v in _bf16(c).items()}
    plan = brick.build_plan(5 if c["taps"] == 125 else 3)
    wrev = c["w"][list(brick._tap_reversal(plan))].transpose(1, 2).contiguous()
    args = (c["nbr"], c["steps"])
    sk.reset_launches()
    for x, w in ((c["x"], c["w"]), (c["ct"], wrev)):
        got = sk.brick_gemm_bf16(x, *args, w, c["valid"], c["order"])
        torch.cuda.synchronize()
        assert sk.bound_ratio(got, *sk.brick_gemm_bf16_bound(x, *args, w, c["valid"])) <= 1.0
        assert not got[c["valid"] == 0].float().any()
        assert torch.equal(got, sk.brick_gemm_bf16(x, *args, w, c["valid"], c["order"]))
        assert torch.equal(got, sk.brick_gemm_bf16(x, *args, w, c["valid"]))
    bound = sk.brick_wgrad_bf16_bound(c["x"], *args, c["ct"], c["taps"], c["valid"])
    for order in ((c["order"],), ()):
        dw = sk.brick_wgrad_bf16(c["x"], *args, c["ct"], c["taps"], c["valid"], *order)
        torch.cuda.synchronize()
        assert dw.dtype == BF and sk.bound_ratio(dw, *bound) <= 1.0
        again = sk.brick_wgrad_bf16(c["x"], *args, c["ct"], c["taps"], c["valid"], *order)
        assert torch.equal(dw, again), "the same bits from two launches"
    assert sk.launch_counts()["brick_gemm_bf16"] == 6
    assert sk.launch_counts()["brick_wgrad_bf16"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("k,level,cin,cout", [(3, 0, 3, 32), (3, 0, 6, 20), (3, 0, 32, 32),
                                              (3, 1, 64, 64), (3, 0, 128, 96),
                                              (3, 1, 96, 128), (5, 0, 3, 32), (5, 1, 6, 5)])
def test_brick_blocks_on_card(pyramids, card, k, level, cin, cout):
    c = _operands(_levels(pyramids[(2, "tight")])[level], k, cin, cout, seed=cin + cout)
    _hold_on_card(c, card)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 32), (6, 20), (8, 5), (40, 9)])
def test_brick_wgrad_reads_empty_slots_as_zeros_on_card(pyramids, card, cin, cout):
    """x and ct with values at the empty slots: the dW (the brick form up
    to Cin 8, the pair form past it) within the bound of the twin, which
    masks them, and equal to the dW of the masked operands."""
    lv = _levels(pyramids[(2, "tight")])[0]
    c = {n: v.to(card) if torch.is_tensor(v) else v
         for n, v in _bf16(_operands(lv, 3, cin, cout, seed=cin, junk=True)).items()}
    args = (c["nbr"], c["steps"], c["ct"], c["taps"], c["valid"])
    dw = sk.brick_wgrad_bf16(c["x"], *args)
    assert sk.bound_ratio(dw, *sk.brick_wgrad_bf16_bound(c["x"], *args)) <= 1.0
    live = (c["valid"] != 0)[:, None]
    masked = sk.brick_wgrad_bf16(c["x"] * live, c["nbr"], c["steps"], c["ct"] * live,
                                 c["taps"], c["valid"])
    assert torch.equal(dw, masked)


@pytest.mark.cuda
@pytest.mark.parametrize("empty", [False, True], ids=["one brick", "no occupied slot"])
def test_brick_blocks_on_one_brick_or_none(card, empty):
    """A level whose only occupied brick holds 5 of its 8 slots, and the
    same level with no occupied slot (all zeros out)."""
    cell = np.array([[0, x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])[:5]
    pyr = brick.build_brick_pyramid(cell.astype(np.int32), num_levels=3, npads=[16, 8, 4, 2],
                                    num_batch=1, brick_levels=1)[0]
    lv = pyr.levels[0]
    if empty:
        lv.valid = np.zeros_like(lv.valid)
        lv.nbr.order = brick.slot_order(lv.valid)
    for cin in (7, 40):  # the brick form and the pair form
        c = _operands(lv, 3, cin, 9, seed=cin)
        _hold_on_card(c, card)
        if empty:
            x, ct = c["x"].to(card, BF), c["ct"].to(card, BF)
            assert not sk.brick_wgrad_bf16(x, c["nbr"].to(card), c["steps"], ct, 27,
                                           c["valid"].to(card)).float().any()
