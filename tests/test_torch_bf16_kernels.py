"""The bf16 forms of the sparse-conv kernels (``gather_gemm_bf16``,
``gather_wgrad_bf16``, ``parent_gemm_bf16``, ``scatter_parent_bf16``):
here, on the CPU, their twins' rounding points (bf16 rows, exact or f32
sums, one rounding; ``round_each_tap`` against a numpy reference), the
error bounds of the two tensor-core forms on the twins, and every
wrapper's dtype checks; on the card each form against its twin at the
stem's Cin = 3, Cin % 8 != 0, ragged and unaligned rows, tap splits and
large grids, with the same bits from two launches and exact +0 at rows
that gather nothing.

Tolerances on the card: a bf16 output is the kernel's f32 sum and the
twin's exact one, each rounded once (or, under ``round_each_tap``, each
tap rounded first); they differ by at most one bf16 ulp of the element
where a rounding boundary lies between them: |got - want| <= 2^-7
max|want| (BF16_RTOL).  dW (f32 out) and dy (exact) keep the f32 kernels'
checks.  ``gather_gemm_bf16``, ``parent_gemm_bf16`` and the (bf16, bf16)
``gather_wgrad_bf16`` run on the tensor cores, whose sums run in another
order than the f32 kernels': each output lies within its derived bound of
the exact sum (``kernels.gather_gemm_bf16_bound``,
``parent_gemm_bf16_bound``, ``gather_wgrad_bf16_bound``).  The other forms
run the f32 instances' tiles, splits and FMA order, so each equals its f32
kernel on the widened operands.

This file imports no JAX, so the card's machine runs its ``cuda`` tests:
    python -m pytest --noconftest -p no:cacheprovider -m cuda
    tests/test_torch_bf16_kernels.py"""
import numpy as np
import pytest
import torch

from pointcontrast_tpu_torch.sparse import kernels
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid

NPADS = [512, 512, 480, 96, 30]
BF = torch.bfloat16
BF16_RTOL = 2.0 ** -7  # one bf16 ulp at the largest magnitude
RTOL, ATOL = 1e-4, 1e-5  # f32 outputs (dW), as the f32 kernels' tests


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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _idx(a, dev="cpu"):
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)


def _masked(gen, shape, valid, dev):
    """Random bf16 rows, exact zeros at the pad rows (``valid`` [B*S])."""
    x = torch.randn(shape, device=dev, generator=gen)
    return (x * valid.to(dev).reshape(shape[0], shape[1], 1)).to(BF)


def _close_bf16(got, want, what):
    assert got.dtype == BF and want.dtype == BF, what
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    assert err <= BF16_RTOL * ref, f"{what}: {err:.3e} of {ref:.3e}"


def _close_f32(got, want, what):
    assert got.dtype == torch.float32, what
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    assert err <= ATOL + RTOL * ref, f"{what}: {err:.3e} of {ref:.3e}"


def _big_map(gen, k, b_, s, dev, live=0.5):
    m = torch.randint(0, s - 1, (k, b_, s), device=dev, generator=gen, dtype=torch.int32)
    dead = torch.rand((k, b_, s), device=dev, generator=gen) > live
    dead[:, :, int(0.7 * s):] = True
    return torch.where(dead, torch.full_like(m, s - 1), m)


# --------------------------------------------------------------------------
# CPU: the twins' rounding points and the wrappers' dtype checks


def test_twins_round_the_f32_sums_once(pyr):
    """Each bf16 twin is the f32 twin on the widened operands (bf16 -> f32
    is exact), rounded once to bf16 (dW and dy stay f32); gather_gemm's
    sums exact, on operands widened to f64."""
    rng = np.random.RandomState(3)
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, lv1.valid.shape[0] // b_
    x0 = torch.from_numpy(rng.randn(b_, s0, 5).astype(np.float32)).to(BF)
    x1 = torch.from_numpy(rng.randn(b_, s1, 5).astype(np.float32)).to(BF)
    w = torch.from_numpy(rng.randn(27, 5, 7).astype(np.float32)).to(BF)
    g0 = torch.from_numpy(rng.randn(b_, s0, 7).astype(np.float32)).to(BF)
    nbr, upp, upo = _idx(lv.nbr), _idx(lv.up_parent), _idx(lv.up_offset)
    taps = [i for i in range(27) if i != 13]
    f, d = torch.Tensor.float, torch.Tensor.double
    got = kernels.gather_gemm_bf16(x0, nbr, taps, 0, w[taps], w[13], s0, s0 - 1)
    want = kernels.gather_gemm_plain(d(x0), nbr, taps, 0, d(w[taps]), d(w[13]), s0,
                                     s0 - 1).to(BF)
    assert got.dtype == BF and torch.equal(got, want)
    got = kernels.parent_gemm_bf16(x1, upp, upo, w[:8], s1 - 1)
    want = kernels.parent_gemm_plain(f(x1), upp, upo, f(w[:8]), s1 - 1).to(BF)
    assert got.dtype == BF and torch.equal(got, want)
    for g in (g0, f(g0)):  # K1's dW: bf16 cotangent; an f32 G: K3's parent design's dy
        got = kernels.gather_wgrad_bf16(x0, None, None, 0, g, nbr, list(range(27)), 0,
                                        27, s0, skip_g=s0 - 1)
        want = kernels.gather_wgrad_plain(f(x0), None, None, 0, f(g), nbr,
                                          list(range(27)), 0, 27, s0, skip_g=s0 - 1)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    ct = torch.from_numpy(rng.randn(b_, s0, 7).astype(np.float32)).to(BF)
    got = kernels.scatter_parent_bf16(ct, upp, upo, 8, s1)
    assert got.dtype == torch.float32
    assert torch.equal(got, kernels.scatter_parent_plain(f(ct), upp, upo, 8, s1))


def _bf16_round(x):
    """float64 numpy values rounded to the nearest bf16, ties to even (8
    significant bits; no overflow or subnormals at these magnitudes)."""
    m, e = np.frexp(x)
    return np.ldexp(np.rint(np.ldexp(m, 8)), e - 8)


@pytest.mark.parametrize("centre", [False, True])
def test_round_each_tap_twin_matches_numpy(pyr, centre):
    """``round_each_tap``: each tap's product an f32 dot (the exact product
    rounded to f32, as JAX's ``preferred_element_type``) rounded to bf16,
    the rounded taps summed (list order, the centre last) and the sum
    rounded to f32 and bf16 again, the skipped row left out: the twin
    against numpy in f64, bit for bit, the centre tap given or not."""
    rng = np.random.RandomState(7)
    lv = pyr.levels[0]
    b_, cin, cout = 3, 12, 20
    s0 = lv.valid.shape[0] // b_
    x = rng.randn(b_, s0, cin).astype(np.float32) * lv.valid.reshape(b_, s0, 1)
    w = rng.randn(27, cin, cout).astype(np.float32)
    x, w = (torch.from_numpy(a).to(BF) for a in (x, w))
    taps = [i for i in range(27) if i != 13] if centre else list(range(27))
    wc = w[13] if centre else None
    got = kernels.gather_gemm_bf16(x, _idx(lv.nbr), taps, 0, w[taps], wc, s0, s0 - 1,
                                   round_each_tap=True)
    xs, ws = x.double().numpy(), w.double().numpy()
    nbr = np.asarray(lv.nbr)
    total = np.zeros((b_, s0, cout))
    for t in taps + ([13] if centre else []):
        rows = (np.arange(s0)[None].repeat(b_, 0) if centre and t == 13 else nbr[t])
        gathered = np.take_along_axis(xs, rows[..., None], 1) * (rows != s0 - 1)[..., None]
        total += _bf16_round((gathered @ ws[t]).astype(np.float32).astype(np.float64))
    want = _bf16_round(total.astype(np.float32).astype(np.float64))
    assert np.array_equal(got.double().numpy(), want)


@pytest.mark.parametrize("round_each_tap", [False, True])
def test_tensor_core_bounds_hold_for_the_twins(pyr, round_each_tap):
    """The twins are exact sums rounded once (per tap and once more under
    ``round_each_tap``), dW exact up to its f32 einsum: each output lies
    within the bound the card's tensor-core forms are held to, and the
    bound is not slack by orders of magnitude (the largest ratio > 1e-3)."""
    rng = np.random.RandomState(11)
    lv = pyr.levels[0]
    b_, s0 = 3, lv.valid.shape[0] // 3
    x = torch.from_numpy(rng.randn(b_, s0, 32).astype(np.float32)).to(BF)
    w = torch.from_numpy(rng.randn(27, 32, 64).astype(np.float32)).to(BF)
    g = torch.from_numpy(rng.randn(b_, s0, 64).astype(np.float32)).to(BF)
    nbr = _idx(lv.nbr)
    taps = [i for i in range(27) if i != 13]
    args = (x, nbr, taps, 0, w[taps], w[13], s0, s0 - 1, None, round_each_tap)
    ref, bound = kernels.gather_gemm_bf16_bound(*args)
    ratio = kernels.bound_ratio(kernels.gather_gemm_bf16(*args), ref, bound)
    assert 1e-3 < ratio <= 1.0, ratio
    args = (x, None, None, 0, g, nbr, list(range(27)), 0, 27, s0, -1, s0 - 1)
    assert kernels.bound_ratio(kernels.gather_wgrad_bf16(*args),
                               *kernels.gather_wgrad_bf16_bound(*args)) <= 1.0


@pytest.mark.parametrize("case", ["gemm f32 x3", "gemm f32 w", "gemm f32 wc",
                                  "f32 gemm bf16 x3", "wgrad f32 a3", "wgrad f16 g3",
                                  "f32 wgrad bf16 g3", "parent f32 w",
                                  "f32 parent bf16 x3", "scatter f32 ct",
                                  "f32 scatter bf16 ct"])
def test_wrappers_check_every_operand_dtype(pyr, case):
    """A bf16 form takes bf16 operands only (g3 of gather_wgrad_bf16 bf16
    or f32), an f32 kernel f32 only: TypeError on either device, no cast."""
    lv = pyr.levels[0]
    b_, s0 = 3, lv.valid.shape[0] // 3
    s1 = pyr.levels[1].valid.shape[0] // 3
    x = torch.zeros(b_, s0, 4, dtype=BF)
    x1 = torch.zeros(b_, s1, 4, dtype=BF)
    w = torch.zeros(27, 4, 4, dtype=BF)
    nbr, upp, upo = _idx(lv.nbr), _idx(lv.up_parent), _idx(lv.up_offset)
    t = list(range(27))
    f = torch.Tensor.float
    calls = {
        "gemm f32 x3": lambda: kernels.gather_gemm_bf16(f(x), nbr, t, 0, w, None, s0),
        "gemm f32 w": lambda: kernels.gather_gemm_bf16(x, nbr, t, 0, f(w), None, s0),
        "gemm f32 wc": lambda: kernels.gather_gemm_bf16(x, nbr, t[:26], 0, w[:26], f(w[26]),
                                                        s0),
        "f32 gemm bf16 x3": lambda: kernels.gather_gemm(x, nbr, t, 0, f(w), None, s0),
        "wgrad f32 a3": lambda: kernels.gather_wgrad_bf16(f(x), None, None, 0, x, nbr, t,
                                                          0, 27, s0),
        "wgrad f16 g3": lambda: kernels.gather_wgrad_bf16(x, None, None, 0, x.half(), nbr,
                                                          t, 0, 27, s0),
        "f32 wgrad bf16 g3": lambda: kernels.gather_wgrad(f(x), None, None, 0, x, nbr, t,
                                                          0, 27, s0),
        "parent f32 w": lambda: kernels.parent_gemm_bf16(x1, upp, upo, f(w[:8])),
        "f32 parent bf16 x3": lambda: kernels.parent_gemm(x1, upp, upo, f(w[:8])),
        "scatter f32 ct": lambda: kernels.scatter_parent_bf16(f(x), upp, upo, 8, s1),
        "f32 scatter bf16 ct": lambda: kernels.scatter_parent(x, upp, upo, 8, s1),
    }
    with pytest.raises(TypeError):
        calls[case]()


@pytest.mark.parametrize("kernel", ["scatter_gemm", "gather_sum", "scatter_sum",
                                    "brick_gemm", "brick_wgrad"])
def test_f32_only_kernels_refuse_bf16(kernel):
    """``scatter_gemm``, ``gather_sum``, ``scatter_sum``, ``brick_gemm`` and
    ``brick_wgrad``, which once took f32 only, route a bf16 operand to
    their bf16 forms: a bf16 result, the bf16 form's, never an f32 run in
    its place."""
    from pointcontrast_tpu_torch.sparse.brick import build_plan, slot_steps

    x = torch.arange(2 * 16 * 4, dtype=torch.float32).reshape(2, 16, 4).to(BF)
    m = torch.arange(2 * 16, dtype=torch.int32).reshape(1, 2, 16) % 16
    w = torch.ones(1, 4, 4, dtype=BF)
    # two bricks, every neighbour row the second
    steps, nbr = slot_steps(build_plan(3)), torch.ones(27, 2, dtype=torch.int32)
    w27 = torch.linspace(-1, 1, 27 * 16).reshape(27, 4, 4).to(BF)
    calls = {
        "scatter_gemm": (lambda: kernels.scatter_gemm(x, m, [0], w, 16, -1),
                         lambda: kernels.scatter_gemm_bf16(x, m, [0], w, 16, -1)),
        "gather_sum": (lambda: kernels.gather_sum(x, m, [0], 0, 16),
                       lambda: kernels.gather_sum_bf16(x, m, [0], 0, 16)),
        "scatter_sum": (lambda: kernels.scatter_sum(x, m, [0], 0, 16, -1),
                        lambda: kernels.scatter_sum_bf16(x, m, [0], 0, 16, -1)),
        "brick_gemm": (lambda: kernels.brick_gemm(x[0], nbr, steps, w27),
                       lambda: kernels.brick_gemm_bf16(x[0], nbr, steps, w27)),
        "brick_wgrad": (lambda: kernels.brick_wgrad(x[0], nbr, steps, x[1], 27),
                        lambda: kernels.brick_wgrad_bf16(x[0], nbr, steps, x[1], 27)),
    }
    call, form = calls[kernel]
    got = call()
    assert got.dtype == BF and torch.equal(got, form())


# --------------------------------------------------------------------------
# the card: each bf16 form against its twin


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 32), (6, 32), (12, 64), (32, 32), (64, 64),
                                      (96, 96), (128, 256), (20, 20), (37, 259)])
def test_gather_gemm_bf16_matches_twin_on_card(pyr, card, cin, cout):
    """K1's forward with its centre, K2's 8 taps and a stacked table, the
    pad row skipped and the live orders passed, on the small pyramid (tap
    splits: f32 partials, one rounding) and a large random map (no split):
    within one bf16 ulp of the twin, the same bits twice, and +0 at every
    row that gathers nothing (the pad rows)."""
    gen = torch.Generator(device=card).manual_seed(cin * 1000 + cout)
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, lv1.valid.shape[0] // b_
    nbr, down = _idx(lv.nbr, card), _idx(lv.down_nbr, card)
    x0 = _masked(gen, (b_, s0, cin), torch.from_numpy(lv.valid), card)
    w = torch.randn(27, cin, cout, device=card, generator=gen).to(BF)
    taps = [i for i in range(27) if i != 13]
    big = _big_map(gen, 27, 2, 20000, card)
    xb = torch.randn(2, 20000, cin, device=card, generator=gen).to(BF)
    xb[:, -1] = 0
    stacked = torch.randn(b_, 8 * s1, cin, device=card, generator=gen).to(BF)
    order0, down_order = _idx(lv.nbr_order, card), _idx(lv.down_order, card)
    calls = [
        (x0, nbr, taps, 0, w[taps].contiguous(), w[13], s0, s0 - 1, order0),
        (x0, down, list(range(8)), 0, w[:8].contiguous(), None, s1, s0 - 1, down_order),
        (stacked, None, None, s1, w[:8].contiguous(), None, s1, -1),
        (xb, big, taps, 0, w[taps].contiguous(), None, 20000, 19999),
        # round_each_tap (the voxel forwards): K1 with its centre gathered,
        # K2, and the large map
        (x0, nbr, list(range(27)), 0, w, None, s0, s0 - 1, order0, True),
        (x0, down, list(range(8)), 0, w[:8].contiguous(), None, s1, s0 - 1, down_order, True),
        (xb, big, taps, 0, w[taps].contiguous(), w[13], 20000, 19999, None, True),
    ]
    kernels.reset_launches()
    for args in calls:
        got = kernels.gather_gemm_bf16(*args)
        _close_bf16(got, kernels.gather_gemm_bf16_plain(*args), f"{cin}->{cout}")
        assert torch.equal(got, kernels.gather_gemm_bf16(*args)), "not the same twice"
        assert kernels.bound_ratio(got, *kernels.gather_gemm_bf16_bound(*args)) <= 1.0
    # K1's pad rows gather only the (skipped) pad row: +0, bit for bit
    got = kernels.gather_gemm_bf16(*calls[0])
    pad = torch.from_numpy(lv.valid).to(card).reshape(b_, s0) == 0
    assert not got[pad].view(torch.int16).any()
    assert kernels.gather_gemm_bf16.launches == 2 * len(calls) + 1
    assert kernels.gather_gemm.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [3, 32])
def test_gather_gemm_bf16_reads_unaligned_tables(pyr, card, cin):
    """A table starting 2 bytes off a 16-byte boundary takes the plain
    2-byte loads, as an odd-Cin row does."""
    gen = torch.Generator(device=card).manual_seed(5)
    lv = pyr.levels[0]
    b_, s0 = 3, lv.valid.shape[0] // 3
    nbr = _idx(lv.nbr, card)
    flat = torch.randn(b_ * s0 * cin + 1, device=card, generator=gen).to(BF)
    x0 = flat[1:].view(b_, s0, cin)
    w = torch.randn(27, cin, 64, device=card, generator=gen).to(BF)
    args = (x0, nbr, list(range(27)), 0, w, None, s0, s0 - 1)
    _close_bf16(kernels.gather_gemm_bf16(*args), kernels.gather_gemm_bf16_plain(*args),
                "unaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("ca,cg", [(3, 32), (12, 32), (32, 32), (64, 64), (96, 96),
                                   (256, 128), (37, 20)])
@pytest.mark.parametrize("g_dtype", ["bf16", "f32"])
def test_gather_wgrad_bf16_matches_twin_on_card(pyr, card, ca, cg, g_dtype):
    """K1's dW (the cotangent through the map), K2's (the features through
    the down map), K3's parent design's (a stacked dy) and a large random
    map, with a bf16 or an f32 (that design's scatter dy) G: f32 sums within the f32 kernels'
    tolerance of the twin, the same dW twice."""
    gen = torch.Generator(device=card).manual_seed(ca * 1000 + cg)
    gt = BF if g_dtype == "bf16" else torch.float32
    lv = pyr.levels[0]
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, pyr.levels[1].valid.shape[0] // b_
    nbr, down = _idx(lv.nbr, card), _idx(lv.down_nbr, card)
    a0 = torch.randn(b_, s0, ca, device=card, generator=gen).to(BF)
    g0 = torch.randn(b_, s0, cg, device=card, generator=gen).to(gt)
    g1 = torch.randn(b_, s1, cg, device=card, generator=gen).to(gt)
    dy = torch.randn(b_, 8 * s1, cg, device=card, generator=gen).to(gt)
    a1 = torch.randn(b_, s1, ca, device=card, generator=gen).to(BF)
    big = _big_map(gen, 27, 2, 30000, card)
    ab = torch.randn(2, 30000, ca, device=card, generator=gen).to(BF)
    gb = torch.randn(2, 30000, cg, device=card, generator=gen).to(gt)
    calls = [
        (a0, None, None, 0, g0, nbr, list(range(27)), 0, 27, s0, -1, s0 - 1),
        (a0, down, list(range(8)), 0, g1, None, None, 0, 8, s1, s0 - 1, -1),
        (a1, None, None, 0, dy, None, None, s1, 8, s1, -1, -1),
        (ab, None, None, 0, gb, big, list(range(27)), 0, 27, 30000, -1, 29999),
    ]
    kernels.reset_launches()
    for args in calls:
        got = kernels.gather_wgrad_bf16(*args)
        _close_f32(got, kernels.gather_wgrad_bf16_plain(*args), f"{ca}x{cg} {g_dtype}")
        assert torch.equal(got, kernels.gather_wgrad_bf16(*args)), "not the same twice"
    assert kernels.gather_wgrad_bf16.launches == 2 * len(calls)
    assert kernels.gather_wgrad.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(12, 32), (32, 32), (64, 96), (256, 128),
                                      (96, 20), (37, 64)])
def test_parent_gemm_bf16_matches_twin_on_card(pyr, card, cin, cout):
    """K3's forward (the coarse pad row skipped) and K2's dF (no skip), in
    the pyramid's up order and without one: on the tensor cores, within
    ``parent_gemm_bf16_bound`` of the exact sum, the same bits twice."""
    gen = torch.Generator(device=card).manual_seed(cin * 100 + cout)
    for level in (0, 2):
        lv, up = pyr.levels[level], pyr.levels[level + 1]
        b_ = 3
        s_c = up.valid.shape[0] // b_
        x = _masked(gen, (b_, s_c, cin), torch.from_numpy(up.valid), card)
        w = torch.randn(8, cin, cout, device=card, generator=gen).to(BF)
        upp, upo = _idx(lv.up_parent, card), _idx(lv.up_offset, card)
        order = _idx(lv.up_order, card)
        for skip, o in ((s_c - 1, order), (-1, order), (s_c - 1, None)):
            args = (x, upp, upo, w, skip, o)
            got = kernels.parent_gemm_bf16(*args)
            ratio = kernels.bound_ratio(got, *kernels.parent_gemm_bf16_bound(*args))
            assert ratio <= 1.0, f"level {level}: bound ratio {ratio:.3e}"
            assert torch.equal(got, kernels.parent_gemm_bf16(*args)), "not the same twice"


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 32, 96, 259])
def test_scatter_parent_bf16_is_exact_on_card(pyr, card, c):
    """Each kept bf16 cotangent row widened into dy, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(c)
    lv, up = pyr.levels[0], pyr.levels[1]
    b_ = 3
    s_f, s_c = lv.valid.shape[0] // b_, up.valid.shape[0] // b_
    ct = torch.randn(b_, s_f, c, device=card, generator=gen).to(BF)
    args = (ct, _idx(lv.up_parent, card), _idx(lv.up_offset, card), 8, s_c)
    kernels.reset_launches()
    got = kernels.scatter_parent_bf16(*args)
    assert got.dtype == torch.float32
    assert torch.equal(got, kernels.scatter_parent_bf16_plain(*args))
    assert kernels.scatter_parent_bf16.launches == 1 and kernels.scatter_parent.launches == 0


def _widened(args):
    return tuple(a.float() if torch.is_tensor(a) and a.dtype == BF else a for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 32), (12, 64), (32, 32), (37, 259), (96, 96)])
def test_bf16_forms_equal_the_f32_kernels_on_widened_operands(pyr, card, cin, cout):
    """scatter_parent_bf16 and the (bf16, f32) gather_wgrad_bf16 run the
    f32 instances' tiles, splits and FMA order on operands widened exactly,
    so each equals its f32 kernel on the widened operands, bit for bit.
    gather_gemm_bf16, parent_gemm_bf16 and the (bf16, bf16)
    gather_wgrad_bf16 run on the tensor cores, in another order: each
    output within one rounding of the exact sum of its products, plus the
    f32 sums' derived error (``bound_ratio`` <= 1), as a rounding of a
    split's partial or of a tap's sum would not be.  The small pyramid's
    calls split their taps and offsets (asserted), the large map's do not;
    the stem's Cin = 3 and a Cin % 8 != 0 among the widths."""
    gen = torch.Generator(device=card).manual_seed(cin * 7 + cout)
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, lv1.valid.shape[0] // b_
    nbr, down = _idx(lv.nbr, card), _idx(lv.down_nbr, card)
    upp, upo = _idx(lv.up_parent, card), _idx(lv.up_offset, card)
    x0 = _masked(gen, (b_, s0, cin), torch.from_numpy(lv.valid), card)
    x1 = _masked(gen, (b_, s1, cin), torch.from_numpy(lv1.valid), card)
    w = torch.randn(27, cin, cout, device=card, generator=gen).to(BF)
    taps = [i for i in range(27) if i != 13]
    big = _big_map(gen, 27, 2, 20000, card)
    xb = torch.randn(2, 20000, cin, device=card, generator=gen).to(BF)
    g0 = torch.randn(b_, s0, cout, device=card, generator=gen).to(BF)
    tile = kernels._gemm_tile_n_bf16(cout, False)
    assert kernels._gemm_splits(b_, s0, cout, 27, tile) > 1
    assert kernels._gemm_splits(2, 20000, cout, 26, tile) == 1
    assert kernels._parent_splits(b_, s0, cout, tile) > 1
    bounded = [
        (kernels.gather_gemm_bf16, kernels.gather_gemm_bf16_bound,
         (x0, nbr, taps, 0, w[taps].contiguous(), w[13], s0, s0 - 1,
          _idx(lv.nbr_order, card))),
        (kernels.gather_gemm_bf16, kernels.gather_gemm_bf16_bound,
         (x0, down, list(range(8)), 0, w[:8].contiguous(), None, s1, s0 - 1)),
        (kernels.gather_gemm_bf16, kernels.gather_gemm_bf16_bound,
         (xb, big, taps, 0, w[taps].contiguous(), None, 20000, 19999)),
        (kernels.gather_wgrad_bf16, kernels.gather_wgrad_bf16_bound,
         (x0, None, None, 0, g0, nbr, list(range(27)), 0, 27, s0, -1, s0 - 1)),
        (kernels.parent_gemm_bf16, kernels.parent_gemm_bf16_bound,
         (x1, upp, upo, w[:8].contiguous(), s1 - 1, _idx(lv.up_order, card))),
    ]
    for form, bound, args in bounded:
        assert kernels.bound_ratio(form(*args), *bound(*args)) <= 1.0, form.__name__
    checks = [
        (kernels.gather_wgrad_bf16, kernels.gather_wgrad,
         (x0, None, None, 0, g0.float(), nbr, list(range(27)), 0, 27, s0, -1, s0 - 1)),
        (kernels.scatter_parent_bf16, kernels.scatter_parent,
         (g0, upp, upo, 8, s1)),
    ]
    for bf16_form, f32_form, args in checks:
        got = bf16_form(*args)
        want = f32_form(*_widened(args))
        assert torch.equal(got, want.to(got.dtype)), bf16_form.__name__
