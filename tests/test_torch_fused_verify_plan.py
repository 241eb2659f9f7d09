"""The fused-verify kernel's vocab split, partial merge and refusals, on
the CPU.

``verify_plan(V, B, k, SMs)`` says how ``csrc/fused_verify.cu`` cuts the
(B, k, V) logits: each slot into ``ranges`` contiguous id ranges, a batch
row's k * ranges (slot, range) items over the ``cluster`` blocks of its
thread-block cluster (item i to block i % cluster).  Each block reduces an
item to a top-T partial; rank 0 merges a slot's partials in range order by
inserting them into a running top-T, then runs the criterion compare and
the prefix scan.  ``split_model`` repeats that in Python and is held
bit for bit against the plain version on tie-heavy logits.  These tests
need no card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import fused_verify as fv  # noqa: E402

RNG = np.random.default_rng(0)
VOCABS = sorted({1, 2, 7, 8, 2047, 2048, 4096, 49155, 49408, 65536, 256000}
                | set(RNG.integers(1, 300_000, 20).tolist()))
BKS = [(1, 1), (1, 8), (1, 32), (8, 8), (8, 1), (3, 5), (64, 8), (200, 32)]


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("b,k", BKS)
def test_every_id_of_every_row_is_read_once(b, k, sms):
    for vocab in VOCABS:
        cluster, ranges = fv.verify_plan(vocab, b, k, sms)
        assert 1 <= ranges <= min(fv.MAX_RANGES, vocab), (vocab, b, k)
        assert 1 <= cluster <= min(fv.MAX_CLUSTER, k * ranges), (vocab, b, k)
        per_block = np.zeros(cluster, np.int64)
        for slot in range(k):
            seen = np.zeros(vocab, np.int64)
            for rg in range(ranges):
                ids = fv.range_bounds(vocab, ranges, rg)
                assert len(ids) >= 1, (vocab, ranges, rg)       # none empty
                assert len(ids) >= min(fv.MIN_RANGE, vocab // ranges)
                seen[ids.start:ids.stop] += 1
                per_block[(slot * ranges + rg) % cluster] += len(ids)
            assert (seen == 1).all(), (vocab, b, k, slot)
        assert per_block.min() >= 1, (vocab, b, k)              # no idle block


def test_verify_plan_at_the_paths_shapes():
    """B 8, k 8: eight clusters of eight blocks, a whole slot a block; one
    slot (k 1) cut into eight ranges; k 32: four slots a block."""
    assert fv.verify_plan(49408, 8, 8, 132) == (8, 1)
    assert fv.verify_plan(49155, 8, 8, 132) == (8, 1)
    assert fv.verify_plan(49408, 8, 1, 132) == (8, 8)
    assert fv.verify_plan(49408, 1, 32, 132) == (8, 1)
    assert fv.verify_plan(65536, 8, 3, 132) == (8, 8)
    assert fv.verify_plan(1000, 8, 1, 132) == (1, 1)     # one range: V < MIN_RANGE
    assert fv.verify_plan(49408, 64, 8, 132) == (4, 1)   # 256 blocks: the card is full


@pytest.mark.parametrize("args", [(0, 8, 8, 132), (10, 0, 8, 132),
                                  (10, 8, 0, 132), (10, 8, 33, 132),
                                  (10, 8, 8, 0)])
def test_verify_plan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError, match="verify_plan"):
        fv.verify_plan(*args)


def _ranks_before(va, ia, vb, ib):
    return va > vb or (va == vb and ia < ib)


def _insert(top, val, idx):
    """common.cuh TopT::insert on a list of [value, id] pairs."""
    if not _ranks_before(val, idx, *top[-1]):
        return
    top[-1] = [val, idx]
    for j in range(len(top) - 1, 0, -1):
        if _ranks_before(*top[j], *top[j - 1]):
            top[j], top[j - 1] = top[j - 1], top[j]


def split_model(logits, props, *, criterion, top_k=1, epsilon=0.0,
                sms=132, plan=None):
    """The kernel's route: per-(slot, range) partials of TT entries (the
    block-wide top-TT of the range), merged per slot in range order into a
    running top-T, then the criterion compare and the prefix scan."""
    lg = logits.float()
    b, k, vocab = lg.shape
    top_t = max(1, int(top_k)) if criterion == "topk" else 1
    tt = 1 if top_t == 1 else fv.MAX_TOP_T
    cluster, ranges = plan or fv.verify_plan(vocab, b, k, sms)
    acc = torch.zeros((b, k), dtype=torch.bool)
    khat = torch.zeros((b,), dtype=torch.int32)
    toks = torch.zeros((b, k), dtype=torch.int32)
    nxt = torch.zeros((b,), dtype=torch.int32)
    empty = [float("-inf"), 2 ** 31 - 1]
    for bi in range(b):
        top_ids = []
        for slot in range(k):
            top = [list(empty) for _ in range(tt)]
            for rg in range(ranges):
                ids = fv.range_bounds(vocab, ranges, rg)
                part = lg[bi, slot, ids.start:ids.stop]
                order = torch.sort(part, descending=True, stable=True).indices[:tt]
                partial = [[float(part[o]), ids.start + int(o)] for o in order]
                partial += [list(empty)] * (tt - len(partial))
                for val, idx in partial[:top_t]:
                    _insert(top, val, idx)
            top_ids.append([idx for _, idx in top[:top_t]])
        ok = [True]
        for i in range(1, k):
            cand = int(props[bi, i])
            ids = top_ids[i - 1]
            if criterion == "exact":
                ok.append(cand == ids[0])
            elif criterion == "topk":
                ok.append(cand in ids)
            else:
                ok.append(abs(cand - ids[0]) <= epsilon)
        kh = next((i for i in range(1, k) if not ok[i]), k)
        acc[bi] = torch.tensor(ok)
        khat[bi] = kh
        toks[bi, :kh] = props[bi, :kh]
        nxt[bi] = top_ids[kh - 1][0]
    return acc, khat, toks, nxt


def _tie_case(b, k, vocab, vp, dtype, seed):
    """Logits quantised to four values (thousands of exact ties a row),
    lanes past ``vocab`` at -1e9 as project_vocab pads them; proposals
    that accept a prefix of greedy's ids."""
    rng = np.random.default_rng(seed)
    lg = rng.integers(0, 4, (b, k, vp)).astype(np.float32) * 0.5
    lg[..., vocab:] = -1e9
    logits = torch.from_numpy(lg).to(dtype)
    greedy = torch.argmax(logits.float(), -1).int()
    props = torch.from_numpy(rng.integers(0, vocab, (b, k)).astype(np.int32))
    props[:, 1:k // 2 + 1] = greedy[:, :k // 2]
    return logits, props


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_split_model_equals_the_plain_version(k, top_k, dtype):
    """Per-range partials merged in range order give the plain version's
    outputs bit for bit, for every criterion, on heavy ties and pad lanes,
    at the plan's split and at a forced eight-range split."""
    logits, props = _tie_case(2, k, 4099, 4352, dtype, seed=k * 10 + top_k)
    kw = dict(top_k=top_k, epsilon=2.0)
    for crit in ref.CRITERIA:
        want = ref.fused_verify(logits, props, criterion=crit, **kw)
        for plan in (None, (8, 8)):
            got = split_model(logits, props, criterion=crit, plan=plan, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (crit, plan)


def test_split_model_lowest_id_wins_across_ranges():
    """One value everywhere: every range's partial ties with every other,
    and the merge keeps the lowest ids, as the plain version does."""
    logits = torch.zeros((1, 2, 20000))
    props = torch.tensor([[0, 1]], dtype=torch.int32)
    got = split_model(logits, props, criterion="topk", top_k=8, plan=(2, 8))
    want = ref.fused_verify(logits, props, criterion="topk", top_k=8)
    assert fv.verify_plan(20000, 1, 2, 132) == (8, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].tolist() == [2] and got[3].tolist() == [0]


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load a kernel."""
    def refuse(*_a, **_k):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("criterion", "unknown criterion"),
    ("rank", r"\(B, k, V\)"),
    ("dtype", "not supported"),
    ("strided", "contiguous"),
    ("proposals", r"\(B, k\) int32"),
    ("empty vocab", "empty logits"),
    ("k 33", "block size 33"),
    ("top_k 9", "top_k=9"),
    ("top_k > V", "top_k=3"),
])
def test_wrapper_refuses_before_any_build(no_build, case, match):
    logits = torch.zeros((2, 8, 300))
    props = torch.zeros((2, 8), dtype=torch.int32)
    kw = dict(criterion="exact")
    if case == "criterion":
        kw["criterion"] = "greedy"
    elif case == "rank":
        logits = torch.zeros((2, 300))
    elif case == "dtype":
        logits = logits.half()
    elif case == "strided":
        logits = torch.zeros((2, 8, 600))[..., ::2]
    elif case == "proposals":
        props = props.long()
    elif case == "empty vocab":
        logits = torch.zeros((2, 8, 0))
    elif case == "k 33":
        logits = torch.zeros((2, 33, 300))
        props = torch.zeros((2, 33), dtype=torch.int32)
    elif case == "top_k 9":
        kw = dict(criterion="topk", top_k=9)
    elif case == "top_k > V":
        logits = torch.zeros((2, 8, 2))
        kw = dict(criterion="topk", top_k=3)
    with pytest.raises(ValueError, match=match):
        fv.fused_verify_cuda(logits, props, **kw)
