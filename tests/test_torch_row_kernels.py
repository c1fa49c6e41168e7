"""The row kernels ``detect.kernels.scatter_add_rows`` and
``sparse.kernels.gather_sum``.  On the CPU: ``scatter_add_rows`` (alone and
as the backward of ``detect.ops.group_points``) against JAX's transpose of
``group_points`` at the two collision patterns its kernel's run merge
targets, a ball query whose balls hold 1-3 hits (every slot past a ball's
hits repeats its first hit) and every row of a sample naming one index;
both wrappers refuse index spaces of 2^31 or more.  On a card
(``cuda``-marked): ``scatter_add_rows`` against its plain twin at those
patterns and at C = 3, 256 and 259, and ``gather_sum`` bit for bit against
its twin at K = 1, 8 and 27 and C = 1 to 128 with out-of-range rows in the
map.

Tolerances: against JAX, 1e-6 of the largest entry (the same adds in
another order); on the card, ``scatter_add_rows`` to 1e-5 of the largest
entry (f32 atomics in no fixed order, up to 512 adds on one row), and
``gather_sum`` exact (the kernel adds the rows in tap order from zero, as
the twin does).

JAX is imported inside a fixture, so the card's machine, which has none,
runs the ``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_row_kernels.py"""
import numpy as np
import pytest
import torch

from pointcontrast_tpu_torch.detect import kernels as dk
from pointcontrast_tpu_torch.detect import ops as dops
from pointcontrast_tpu_torch.sparse import kernels as sk

B, N, M, S = 2, 256, 32, 16  # samples, table rows, balls, slots a ball


@pytest.fixture(scope="module")
def jax_group_points():
    import jax

    from pointcontrast_tpu.detect import ops as j_ops

    def transpose(points, idx, ct):
        """JAX's cotangent of ``points`` [B, C, N] for ``ct`` [B, C, M, S]."""
        _, vjp = jax.vjp(lambda p: j_ops.group_points(p, idx), points)
        return np.asarray(vjp(ct)[0])

    return transpose


def _ball_tails(device="cpu"):
    """[B, M, S] int32: a ball query (r 0.08, seed 0) whose 64 balls hold
    1 to 3 hits each, so 13-15 of a ball's 16 slots repeat its first hit."""
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32)).to(device)
    group = dk.ball_query(xyz[:, :M].contiguous(), xyz, 0.08, S)
    hits = 1 + (group[..., 1:] != group[..., :1]).sum(-1)
    assert int(hits.min()) >= 1 and int(hits.max()) <= 3
    assert {1, 2, 3} <= set(hits.reshape(-1).tolist())
    return group


def _one_index(device="cpu"):
    """[B, M, S] int32: every row of sample b names row 7 + b."""
    return (torch.arange(B, dtype=torch.int32, device=device)[:, None, None] + 7
            ).expand(B, M, S).contiguous()


PATTERNS = {"ball tails": _ball_tails, "one index": _one_index}


@pytest.mark.parametrize("c", [3, 36])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_scatter_add_rows_matches_jax_group_points_transpose(jax_group_points,
                                                             pattern, c):
    idx = PATTERNS[pattern]()
    ct = np.random.RandomState(1).randn(B, M, S, c).astype(np.float32)
    points = np.random.RandomState(2).randn(B, c, N).astype(np.float32)
    want = jax_group_points(points, idx.numpy(), ct.transpose(0, 3, 1, 2))
    got = dk.scatter_add_rows(torch.from_numpy(ct), idx, N).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_group_points_backward_matches_jax(jax_group_points, pattern):
    """The port's ``group_points`` (whose backward is ``scatter_add_rows``)
    through autograd, against ``jax.vjp`` of JAX's."""
    idx = PATTERNS[pattern]()
    c = 5
    ct = np.random.RandomState(3).randn(B, c, M, S).astype(np.float32)
    points = np.random.RandomState(4).randn(B, c, N).astype(np.float32)
    want = jax_group_points(points, idx.numpy(), ct)
    p = torch.from_numpy(points).requires_grad_(True)
    dops.group_points(p, idx).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _expanded(*shape, dtype=torch.float32):
    """A tensor of ``shape`` that holds one element (no memory to speak of)."""
    return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)


@pytest.mark.parametrize("what", ["grad", "out"])
def test_scatter_add_rows_refuses_index_spaces_of_2_31(what):
    grad, idx, n = {
        # B M C = 2^31
        "grad": (_expanded(2, 2 ** 15, 2 ** 15), _expanded(2, 2 ** 15, dtype=torch.int32), 4),
        # B n C = 2^31
        "out": (torch.zeros(2, 4, 2 ** 15), torch.zeros(2, 4, dtype=torch.int32), 2 ** 15),
    }[what]
    with pytest.raises(ValueError, match=f"{what} spans"):
        dk.scatter_add_rows(grad, idx, n)


@pytest.mark.parametrize("what", ["x3", "out", "map"])
def test_gather_sum_refuses_index_spaces_of_2_31(what):
    x3, map_, s_out = {
        "x3": (_expanded(2, 2 ** 15, 2 ** 15), _expanded(1, 2, 4, dtype=torch.int32), 4),
        "out": (torch.zeros(2, 4, 2 ** 15), _expanded(1, 2, 2 ** 15, dtype=torch.int32), 2 ** 15),
        "map": (torch.zeros(1, 4, 1), _expanded(2 ** 16, 1, 2 ** 15, dtype=torch.int32), 2 ** 15),
    }[what]
    with pytest.raises(ValueError, match=f"{what} spans"):
        sk.gather_sum(x3, map_, [0], 0, s_out)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scatter_add_rows_matches_plain_twin_on_card():
    """Both collision patterns at C 3 (a lane a row), 256 (float4 lanes) and
    259 (scalar lanes), a float4-misaligned cotangent at C 256, and runs cut
    short by a row count that is not a multiple of 8; one launch each."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for make in PATTERNS.values():
        idx = make(dev)
        for c in (3, 256, 259):
            calls.append((torch.randn(B, M, S, c, device=dev, generator=gen), idx, N))
    shifted = torch.randn(B * M * S * 256 + 1, device=dev, generator=gen)[1:]
    calls.append((shifted.view(B, M, S, 256), calls[1][1], N))
    ragged = torch.randint(0, 40, (3, 2045), device=dev, generator=gen, dtype=torch.int32)
    calls.append((torch.randn(3, 2045, 259, device=dev, generator=gen), ragged, 40))
    dk.reset_launches()
    for grad, idx, n in calls:
        got = dk.scatter_add_rows(grad, idx, n)
        want = dk.scatter_add_rows_plain(grad, idx, n)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    assert dk.launch_counts()["scatter_add_rows"] == len(calls)


def _gather_case(dev, gen, k, c, s_in=500, s_out=300):
    """(x3, map with out-of-range rows, the same map with those sent to the
    table's zero last row): 1 in 8 entries of the map is -1, s_in or 2^20."""
    x3 = torch.randn(B, s_in, c, device=dev, generator=gen)
    x3[:, -1] = 0.0  # a pad row, as every chunk ends with
    map_ = torch.randint(0, s_in, (k, B, s_out), device=dev, generator=gen,
                         dtype=torch.int32)
    bad = torch.randint(0, 8, map_.shape, device=dev, generator=gen) == 0
    wild = torch.tensor([-1, s_in, 2 ** 20], device=dev, dtype=torch.int32)
    pick = torch.randint(0, 3, map_.shape, device=dev, generator=gen)
    out_of_range = torch.where(bad, wild[pick], map_)
    return x3, out_of_range, torch.where(bad, s_in - 1, map_).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 27])
def test_gather_sum_bit_exact_on_card(k):
    """At C 1, 3 (a lane a row), 16, 32, 64 (float4 lanes), 128 (a warp a
    row) and 36 from a float4-misaligned table, with out-of-range rows: the
    kernel leaves those out, the twin adds the zero pad row in their place,
    so the two agree bit for bit.  A stacked table (no map) at the end."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(k)
    calls = []
    for c in (1, 3, 16, 32, 64, 128):
        x3, wild, clean = _gather_case(dev, gen, k, c)
        calls.append(((x3, wild, list(range(k)), 0, 300), (x3, clean, list(range(k)), 0, 300)))
    x3, wild, clean = _gather_case(dev, gen, k, 36)
    shifted = torch.cat([x3.new_zeros(1), x3.reshape(-1)])[1:].view(x3.shape)
    calls.append(((shifted, wild, list(range(k)), 0, 300), (x3, clean, list(range(k)), 0, 300)))
    stacked = torch.randn(B, k * 120, 64, device=dev, generator=gen)
    calls.append(((stacked, None, list(range(k)), 120, 120),) * 2)
    sk.reset_launches()
    for args, twin_args in calls:
        got = sk.gather_sum(*args)
        want = sk.gather_sum_plain(*twin_args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (args[0].shape, k)
    assert sk.launch_counts()["gather_sum"] == len(calls)
