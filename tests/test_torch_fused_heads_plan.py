"""The fused-heads kernel's vocab tiling and refusals, on the CPU.

``vocab_plan(Vp, SMs)`` says how the kernel (``csrc/fused_heads.cu``, bf16
and fp32) cuts the vocab into 128-lane tiles walked by persistent blocks, each block
carrying a per-row top-T over its contiguous range; the kernel refuses a
block count outside [1, tiles].  These tests need no card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_heads as fh  # noqa: E402

VPS = sorted({1, 2, 127, 128, 129, 1000, 1024, 49155, 49408, 65536}
             | set(np.random.default_rng(0).integers(1, 300_000, 40).tolist()))


@pytest.mark.parametrize("sms", [1, 7, 132, 264])
def test_every_lane_falls_in_exactly_one_block(sms):
    for vp in VPS:
        blocks, tiles = fh.vocab_plan(vp, sms)
        assert 1 <= blocks <= min(tiles, sms), (vp, sms)
        assert tiles * fh.VOCAB_TILE >= vp > (tiles - 1) * fh.VOCAB_TILE
        seen = np.zeros(vp, dtype=np.int64)
        for i in range(blocks):
            walked = fh.block_tiles(blocks, tiles, i)
            assert len(walked) >= 1, (vp, sms, i)      # no idle block
            for t in walked:
                seen[t * fh.VOCAB_TILE:(t + 1) * fh.VOCAB_TILE] += 1
        assert (seen == 1).all(), (vp, sms)


def test_vocab_plan_at_the_paths_shapes():
    """granite's 49408 lanes: 386 tiles, 2 or 3 a block on 132 SMs;
    rwkv6's 65536: 512 tiles, 3 or 4 a block."""
    assert fh.vocab_plan(49408, 132) == (132, 386)
    assert {len(fh.block_tiles(132, 386, i)) for i in range(132)} == {2, 3}
    assert fh.vocab_plan(65536, 132) == (132, 512)
    assert {len(fh.block_tiles(132, 512, i)) for i in range(132)} == {3, 4}
    assert fh.vocab_plan(1024, 132) == (8, 8)


def test_vocab_plan_refuses_empty_inputs():
    with pytest.raises(ValueError, match="Vp >= 1"):
        fh.vocab_plan(0, 132)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load a kernel."""
    def refuse(*_a, **_k):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


def _table(vp, d, dtype, pad=0):
    """A (Vp, d + pad) table; returns the tied (d, Vp) transpose view."""
    return torch.zeros((vp, d + pad), dtype=dtype)[:, :d].t()


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("top_t 9", "top_t=9"),
    ("top_t 0", "top_t=0"),
    ("vocab > Vp", "vocab=300"),
    ("bf16 stride", "multiple of 16 bytes"),
    ("bf16 no unit stride", "one must be 1"),
    ("bf16 d", "d=12"),
    ("dtype", "need one of f32/bf16"),
])
def test_wrapper_refuses_before_any_build(no_build, case, match):
    o = torch.zeros((56, 64), dtype=torch.bfloat16)
    w = _table(256, 64, torch.bfloat16)
    kw = dict(vocab=200, top_t=1)
    if case == "top_t 9":
        kw["top_t"] = 9
    elif case == "top_t 0":
        kw["top_t"] = 0
    elif case == "vocab > Vp":
        kw["vocab"] = 300
    elif case == "bf16 stride":             # rows of 65 elements: 130 bytes
        w = _table(256, 64, torch.bfloat16, pad=1)
    elif case == "bf16 no unit stride":
        w = torch.zeros((64, 2 * 256), dtype=torch.bfloat16)[:, ::2]
    elif case == "bf16 d":
        o = torch.zeros((56, 12), dtype=torch.bfloat16)
        w = _table(256, 12, torch.bfloat16, pad=4)
    elif case == "dtype":
        o = torch.zeros((56, 64), dtype=torch.float16)
        w = _table(256, 64, torch.float16)
    with pytest.raises(ValueError, match=match):
        fh.fused_heads_topk_cuda(o, w, **kw)


@pytest.mark.parametrize("layout", ["tied", "row-major"])
def test_both_layouts_pass_the_bf16_checks(no_build, layout):
    """The path's two layouts (granite's tied table view, rwkv6's row-major
    lm_head) pass every check the bf16 kernel makes; only the device is
    refused here."""
    o = torch.zeros((56, 64), dtype=torch.bfloat16)
    w = (_table(256, 64, torch.bfloat16) if layout == "tied"
         else torch.zeros((64, 256), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA device"):
        fh.fused_heads_topk_cuda(o, w, vocab=200, top_t=2)


@pytest.mark.parametrize("case,match", [
    ("fp32 pitch 13", "multiple of 16 bytes"),
    ("fp32 no unit stride", "one must be 1"),
    ("fp32 d", "d=6"),
    ("fp32 misaligned", "16-byte boundaries"),
])
def test_wrapper_refuses_fp32_layouts_before_any_build(no_build, case, match):
    """fp32 takes bf16's layout rule (its tiles come by TMA too): one
    stride 1 and the other a multiple of 16 bytes (4 elements), d a
    multiple of 4, both tensors on 16-byte boundaries."""
    o = torch.zeros((56, 64))
    w = _table(256, 64, torch.float32)
    if case == "fp32 pitch 13":             # rows of 13 elements: 52 bytes
        o = torch.zeros((56, 12))
        w = _table(256, 12, torch.float32, pad=1)
    elif case == "fp32 no unit stride":
        w = torch.zeros((64, 2 * 256))[:, ::2]
    elif case == "fp32 d":
        o = torch.zeros((56, 6))
        w = _table(256, 6, torch.float32, pad=2)
    elif case == "fp32 misaligned":         # a contiguous view 4 bytes in
        o = torch.zeros(56 * 64 + 1)[1:].view(56, 64)
    with pytest.raises(ValueError, match=match):
        fh.fused_heads_topk_cuda(o, w, vocab=200, top_t=2)


@pytest.mark.parametrize("layout", ["tied", "row-major"])
def test_both_layouts_pass_the_fp32_checks(no_build, layout):
    """The path's two fp32 layouts (a tied table view, a row-major
    lm_head) pass every check the kernel makes; only the device is
    refused here."""
    o = torch.zeros((56, 64))
    w = (_table(256, 64, torch.float32) if layout == "tied"
         else torch.zeros((64, 256)))
    with pytest.raises(ValueError, match="CUDA device"):
        fh.fused_heads_topk_cuda(o, w, vocab=200, top_t=2)
