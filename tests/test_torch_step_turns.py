"""``tools.step_turns`` on the CPU: its verdict on made-up turns and its
timing of the kernel wrappers (its turns need a card; these do not)."""
import pytest
import torch

from pointcontrast_tpu_torch.tools import step_turns


@pytest.mark.parametrize("this, base, verdict", [
    # within the bound, the base's spread 2%: met
    ([101, 102, 103, 104, 105], [100, 101, 102, 103, 104], "met"),
    # 10% slower, the base's spread 2%: not met
    ([111, 112, 113, 114, 115], [100, 101, 102, 103, 104], "not met"),
    # the base spreads 20%, wider than the bound: unresolved either way
    ([101, 110, 120, 130, 140], [90, 100, 110, 120, 130], "unresolved"),
    ([95, 100, 105, 110, 115], [90, 100, 110, 120, 130], "unresolved"),
    # every turn faster than every base turn: met whatever the spread
    ([50, 60, 70, 80, 89], [90, 100, 110, 120, 130], "met"),
])
def test_verdict(this, base, verdict):
    assert step_turns._compare(this, base, 0.05)["verdict"] == verdict


def test_compare_counts_pairs_and_quartiles():
    c = step_turns._compare([1.0, 3.0, 2.0, 5.0], [2.0, 2.0, 2.0, 4.0], 0.05)
    assert c["this_wins"] == 1 and c["pairs"] == 4  # only 1.0 < 2.0; 2.0 ties
    assert c["this"]["median"] == 2.5 and c["base"]["median"] == 2.0
    assert c["base"]["q1"] == 2.0 and c["base"]["q3"] == 2.5


def test_needs_base():
    with pytest.raises(SystemExit):
        step_turns.main(["--app", "pretrain"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        step_turns.main(["--base", "."])


def test_timed_wrappers_tally_and_restore():
    """Every caller's reference to a kernel wrapper is timed, the launch
    counter still counts in the defining module, and restore puts the
    originals back."""
    from pointcontrast_tpu_torch.sparse import kernels as K
    from pointcontrast_tpu_torch.sparse import ops

    original = ops.parent_gemm
    tally, restore = step_turns._timed_wrappers()
    try:
        assert ops.parent_gemm is not original and K.parent_gemm is original
        x3 = torch.randn(1, 4, 3)
        parent = torch.tensor([[0, 1, 2, 3, 3]], dtype=torch.int32)
        off = torch.tensor([[0, 1, 7, 2, 0]], dtype=torch.int32)
        w = torch.randn(8, 3, 2)
        got = ops.parent_gemm(x3, parent, off, w)
        torch.testing.assert_close(got, K.parent_gemm_plain(x3, parent, off, w))
        assert tally["parent_gemm"][1] == 1 and tally["parent_gemm"][0] > 0
    finally:
        restore()
    assert ops.parent_gemm is original


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app", ["pretrain", "votenet", "semseg"])
def test_app_kwargs_carry_a_bf16_dtype_only(app, dtype):
    """``--dtype bfloat16`` reaches the app; float32 adds no keyword, so a
    base checkout whose apps take no dtype still runs."""
    import types

    args = types.SimpleNamespace(app=app, model=None, crf=False, layout="chunked",
                                 backbone="sparseconv", dtype=dtype)
    kw = step_turns._app_kwargs(args)
    assert kw.get("dtype") == (torch.bfloat16 if dtype == "bfloat16" else None)
    assert ("dtype" in kw) == (dtype == "bfloat16")
