"""The split-KV attention kernels' plan and refusals, on the CPU.

``split_plan(L)`` says how ``csrc/split_attention.cuh`` cuts a cache of L
keys into the ranges of one thread-block cluster; the kernel refuses a
launch whose plan differs.  The dense, tree and paged kernels share that
body.  These tests need no card.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_attention as ba  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

SAMPLE = sorted(set(range(1, 8193))
                | set(np.random.default_rng(0).integers(8193, 2 ** 22, 200).tolist())
                | {2 ** 20, 2 ** 22, 2 ** 31 - 1})


def _ranges(l):
    splits, keys = ba.split_plan(l)
    return splits, keys, [(i * keys, min(l, (i + 1) * keys)) for i in range(splits)]


@pytest.mark.parametrize("chunk", range(4))
def test_split_plan_ranges_cover_every_key_once(chunk):
    for l in SAMPLE[chunk::4]:
        splits, keys, ranges = _ranges(l)
        assert 1 <= splits <= ba.MAX_SPLITS, l
        assert keys % ba.SPLIT_ALIGN == 0 and keys >= ba.SPLIT_ALIGN, l
        assert ranges[0][0] == 0 and ranges[-1][1] == l, l
        for (_, end), (start, _) in zip(ranges, ranges[1:]):
            assert end == start, l                  # contiguous, no overlap
        for start, end in ranges:
            assert end > start or l < ba.SPLIT_ALIGN, (l, start, end)


def test_split_plan_at_the_paths_lengths():
    assert ba.split_plan(1) == (1, 16)
    assert ba.split_plan(256) == (4, 64)          # granite's serve cache
    assert ba.split_plan(4096) == (8, 512)
    assert ba.split_plan(65) == (2, 48)
    assert ba.split_plan(513) == (7, 80)          # no empty eighth range


def test_split_plan_depends_on_l_alone():
    """The plan takes L and nothing else, so a query's arithmetic cannot
    depend on kq or B; the wrappers pass it k.shape[1] alone."""
    params = list(inspect.signature(ba.split_plan).parameters)
    assert params == ["kv_len"]
    for name in ("verify_attention_cuda", "tree_verify_attention_cuda"):
        assert "split_plan(l)[0]" in inspect.getsource(getattr(ba, name))
    # the paged kernel: L = P·ps, the table's pages times the page size
    src = inspect.getsource(pa.paged_verify_attention_cuda)
    assert "l = n_pages_row * ps" in src
    assert "splits, keys = split_plan(l)" in src
    assert src.count("split_plan(") == 1
    assert src.rstrip().endswith("int(num_meta), splits))")


def test_split_plan_refuses_an_empty_cache():
    with pytest.raises(ValueError, match="L >= 1"):
        ba.split_plan(0)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load a kernel."""
    def refuse(*_a, **_k):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


def _inputs(b=1, kq=2, h=4, kvh=2, hd=64, l=16):
    q = torch.zeros((b, kq, h, hd))
    kv = torch.zeros((b, l, kvh, hd))
    return (q, kv, kv, torch.zeros((b, kq), dtype=torch.int32),
            torch.zeros((b, l), dtype=torch.int32))


def _head_dim_cases(first):
    """quickstart's 24 (computed at 32) and stablelm-12b's 160 are taken
    (a CPU tensor then fails the device check); 20 and 192 are refused.
    The ids are the cases' ids from before 160 was taken."""
    return [pytest.param(dict(hd=24), "CUDA device",
                         id=f"case{first}-CUDA device"),
            pytest.param(dict(hd=20), "head_dim 20",
                         id=f"case{first + 1}-head_dim 20"),
            pytest.param(dict(hd=160), "CUDA device",
                         id=f"case{first + 2}-head_dim 160"),
            pytest.param(dict(hd=192), "head_dim 192", id="hd192")]


# more than 64 query rows of a (row, KV head) are taken in row tiles (the
# first case keeps its id from when 64 was the limit): starcoder2-7b's G 9
# at kq 8 (72 rows) and under a 32-node tree (288)
ROW_CASES = [
    pytest.param(dict(kq=65, h=2, kvh=2), "CUDA device",
                 id="case2-65 query rows exceed 64"),
    pytest.param(dict(kq=8, h=9, kvh=1), "CUDA device", id="rows72"),
    pytest.param(dict(kq=32, h=9, kvh=1), "CUDA device", id="rows288"),
]


@pytest.mark.parametrize("kernel", ["verify", "tree"])
@pytest.mark.parametrize("case,match", [
    (dict(), "CUDA device"),                       # a CPU tensor
    (dict(hd=48), "head_dim 48"),
    *ROW_CASES,
    *_head_dim_cases(3),
])
def test_wrappers_refuse_before_any_build(no_build, kernel, case, match):
    q, k, v, q_pos, kv_pos = _inputs(**case)
    with pytest.raises(ValueError, match=match):
        if kernel == "verify":
            ba.verify_attention_cuda(q, k, v, q_pos, kv_pos)
        else:
            ba.tree_verify_attention_cuda(q, k, v, q_pos, kv_pos,
                                          torch.full_like(kv_pos, -1), q_pos)


def _paged_inputs(b=1, kq=2, h=4, kvh=2, hd=64, ps=8, P=2, pages=3):
    q = torch.zeros((b, kq, h, hd))
    pool = torch.zeros((pages, ps, kvh, hd))
    return (q, pool, pool, torch.ones((b, P), dtype=torch.int32),
            torch.zeros((b, kq), dtype=torch.int32),
            torch.zeros((b, P * ps), dtype=torch.int32))


@pytest.mark.parametrize("case,match", [
    (dict(), "CUDA device"),                       # a CPU tensor
    (dict(hd=48), "head_dim 48"),
    *ROW_CASES,
    pytest.param(dict(ps=12), "page_size 12 must be a multiple of 8",
                 id="case3-page_size 12 must be a multiple of 8"),
    *_head_dim_cases(4),
])
def test_paged_wrapper_refuses_before_any_build(no_build, case, match):
    with pytest.raises(ValueError, match=match):
        pa.paged_verify_attention_cuda(*_paged_inputs(**case))


def test_paged_staged_pages_bound_the_context():
    """A block stages its range's table entries in shared memory
    (PagedRows::kStaged); the longest cache it takes at ps 8 is 32,640
    keys, ranges of 4,080 keys."""
    def fits(l, ps):
        return ba.split_plan(l)[1] // ps + 2 <= pa.MAX_STAGED_PAGES
    assert fits(144, 16) and fits(4096, 8) and fits(32640, 8)
    assert not fits(32768, 8) and fits(65280, 16) and not fits(65536, 16)
