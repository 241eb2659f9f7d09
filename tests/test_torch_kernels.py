"""The port's kernels on the CPU: plain PyTorch versions against the JAX
Pallas kernels (interpret mode) and the jnp oracles, at the sweeps of
tests/test_kernels.py, plus the dispatch and the CUDA wrappers' input
checks.  The CUDA kernels themselves are tested on the card in
tests/test_torch_cuda_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.tree_mask import TreeTopology as JTreeTopology  # noqa: E402
from repro.kernels.tree_mask import default_tree as jdefault_tree  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.block_attention import (  # noqa: E402
    tree_verify_attention_cuda, verify_attention_cuda)
from repro_torch.kernels.fused_heads import fused_heads_topk_cuda  # noqa: E402
from repro_torch.kernels.fused_verify import fused_verify_cuda  # noqa: E402
from repro_torch.kernels.paged_attention import paged_verify_attention_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_scan_bwd_cuda, rwkv6_scan_cuda)
from repro_torch.kernels.tree_mask import TreeTopology, default_tree  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a torch tensor of ``dtype``
    (both round f32 -> bf16 to nearest even, so the bits agree)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


# ---------------------------------------------------------------------------
# verify attention (test_kernels.py:39, :57)
# ---------------------------------------------------------------------------


def _attn_case(seed, b, kq, h, kv, hd, l, meta):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, kq, h, hd), (b, l, kv, hd), (b, l, kv, hd)))
    base = rng.integers(max(meta, 1), l - kq, b)
    qpos = (base[:, None] + np.arange(kq)[None, :]).astype(np.int32)
    kvpos = np.tile(np.arange(l, dtype=np.int32)[None], (b, 1))
    kvpos[:, rng.integers(0, l, 5)] = -1          # stale speculative slots
    return q, k, v, qpos, kvpos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,kq,h,kv,hd,l,window,meta,block_kv",
    [
        (1, 2, 4, 4, 16, 64, 0, 0, 32),     # MHA
        (2, 4, 8, 2, 32, 100, 0, 0, 32),    # GQA, ragged L
        (1, 8, 6, 2, 64, 256, 64, 0, 128),  # sliding window
        (2, 4, 4, 1, 32, 96, 32, 4, 32),    # MQA + meta tokens
        (1, 1, 2, 2, 128, 33, 0, 0, 512),   # single query, one short block
    ])
def test_verify_attention_plain_matches_pallas(b, kq, h, kv, hd, l, window,
                                               meta, block_kv, dtype):
    q, k, v, qpos, kvpos = _attn_case(1, b, kq, h, kv, hd, l, meta)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    got = ref.verify_attention(tq, tk, tv, torch.from_numpy(qpos),
                               torch.from_numpy(kvpos), window=window,
                               num_meta=meta)
    assert got.dtype == TDT[dtype] and got.shape == (b, kq, h, hd)
    oracle = jref.verify_attention(jq, jk, jv, jnp.asarray(qpos),
                                   jnp.asarray(kvpos), window=window,
                                   num_meta=meta)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    if dtype == "float32":   # the Pallas kernel equals its oracle (test_kernels.py)
        pallas = jops.verify_attention(jq, jk, jv, jnp.asarray(qpos),
                                       jnp.asarray(kvpos), window=window,
                                       num_meta=meta, block_kv=block_kv)
        np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])


def test_verify_attention_masks_all_stale_rows():
    """A row whose only visible entries are its own block must not NaN."""
    b, kq, h, kv, hd, l = 1, 2, 2, 2, 16, 16
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, kq, h, hd), (b, l, kv, hd), (b, l, kv, hd)))
    qpos = np.asarray([[0, 1]], np.int32)
    kvpos = np.r_[0:2, [-1] * (l - 2)][None].astype(np.int32)
    got = ops.verify_attention(*(torch.from_numpy(x) for x in (q, k, v, qpos, kvpos)))
    assert not torch.isnan(got).any()
    want = jops.verify_attention(*(jnp.asarray(x) for x in (q, k, v, qpos, kvpos)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# tree verify attention (test_kernels.py:361, :373)
# ---------------------------------------------------------------------------


def _tree_inputs(b, kq, h, kvh, hd, l, topo, length, seed=11):
    """A cache whose slots [length, length+kq) hold the block's tree nodes
    at logical positions length + depth (as numpy, for both packages)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, l, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, l, kvh, hd)).astype(np.float32)
    length = np.asarray(length, np.int32)
    depths = np.asarray(topo.depths)
    q_pos = (length[:, None] + depths[None, :]).astype(np.int32)
    slot = np.arange(l)[None, :]
    node = slot - length[:, None]
    is_tree = (node >= 0) & (node < kq)
    kv_node = np.where(is_tree, node, -1).astype(np.int32)
    kv_pos = np.where(slot < length[:, None], slot,
                      np.where(is_tree,
                               length[:, None] + depths[np.clip(node, 0, kq - 1)],
                               -1)).astype(np.int32)
    anc = np.broadcast_to(np.asarray(topo.anc_bits)[None, :], (b, kq)).copy()
    return q, k, v, q_pos, kv_pos, kv_node, anc


def test_tree_topology_copy_matches_reference():
    for kq, fanout in ((1, 2), (4, 2), (8, 4), (8, 7), (32, 2)):
        got, want = default_tree(kq, fanout), jdefault_tree(kq, fanout)
        assert got == TreeTopology(want.parents)
        for name in ("depths", "ranks", "anc_matrix", "path_matrix", "anc_bits"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert int(default_tree(32, 2).anc_bits[31]) < 0      # bit 31 wraps


@pytest.mark.parametrize("b,kq,h,kvh,hd,l,fanout,window,block_kv", [
    (2, 8, 4, 2, 16, 48, 4, 0, 16),     # GQA
    (1, 4, 4, 4, 24, 33, 2, 12, 16),    # MHA + sliding window, ragged hd/L
    (3, 8, 8, 2, 32, 64, 7, 0, 32),     # full-fanout star
    (1, 2, 2, 1, 64, 40, 1, 0, 512),    # MQA chain-like tree, one block
])
def test_tree_verify_attention_plain_matches_pallas(b, kq, h, kvh, hd, l,
                                                    fanout, window, block_kv):
    rng = np.random.default_rng(11)
    length = rng.integers(kq, l - kq, size=(b,))
    args = _tree_inputs(b, kq, h, kvh, hd, l, default_tree(kq, fanout), length)
    got = ops.tree_verify_attention(*(torch.from_numpy(x) for x in args),
                                    window=window)
    want = jops.tree_verify_attention(*(jnp.asarray(x) for x in args),
                                      window=window, block_kv=block_kv)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    oracle = jref.tree_verify_attention(*(jnp.asarray(x) for x in args),
                                        window=window)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL["float32"])


def test_tree_verify_chain_degenerates_to_verify_attention():
    """A pure-chain topology's ancestor mask is the causal mask: the tree
    plain version equals the chain one and the Pallas tree kernel."""
    b, kq, h, kvh, hd, l = 2, 6, 4, 2, 32, 40
    topo = TreeTopology((-1,) + tuple(range(kq - 1)))
    q, k, v, q_pos, _, kv_node, anc = _tree_inputs(b, kq, h, kvh, hd, l, topo,
                                                   [10, 17], seed=5)
    slot = np.arange(l)[None, :]
    kv_pos = np.where(slot < q_pos[:, -1:] + 1, slot, -1).astype(np.int32)
    t = [torch.from_numpy(x) for x in (q, k, v, q_pos, kv_pos, kv_node, anc)]
    got = ops.tree_verify_attention(*t)
    chain = ops.verify_attention(*t[:5])
    np.testing.assert_allclose(_np(got), _np(chain), **TOL["float32"])
    want = jops.tree_verify_attention(*(jnp.asarray(x) for x in
                                        (q, k, v, q_pos, kv_pos, kv_node, anc)),
                                      block_kv=16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_tree_verify_attention_uses_bit_31():
    """A 32-node tree: node 31's ancestor bit is the int32 sign bit, and
    the plain version reads it as the reference's logical shift does."""
    b, kq, h, kvh, hd, l = 1, 32, 2, 2, 16, 80
    topo = JTreeTopology((-1,) + tuple(range(31)))             # one chain
    args = _tree_inputs(b, kq, h, kvh, hd, l, topo, [20], seed=3)
    assert args[-1][0, 31] < 0
    got = ops.tree_verify_attention(*(torch.from_numpy(x) for x in args))
    want = jref.tree_verify_attention(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# paged verify attention (test_kernels.py:110, :122, :136)
# ---------------------------------------------------------------------------


def _paged_inputs(b, kq, h, kv, hd, P, ps, num_pages, meta=0, share=False,
                  seed=0):
    """A paged cache with random mapped prefixes, the rest on trash page 0
    with pos -1, a few stale slots; numpy inputs for both packages."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kq, h, hd)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    tbl = np.zeros((b, P), np.int32)
    kvpos = np.full((b, P * ps), -1, np.int32)
    ctx = np.zeros(b, np.int64)
    pool = list(range(1, num_pages))
    for bi in range(b):
        n = int(rng.integers(1, P + 1))
        for i in range(n):
            tbl[bi, i] = tbl[0, 0] if (share and bi > 0 and i == 0) else pool.pop()
        ctx[bi] = n * ps
        kvpos[bi, :ctx[bi]] = np.arange(ctx[bi])
    for bi in range(b):
        kvpos[bi, rng.integers(0, ctx[bi], 2)] = -1
    base = np.maximum(ctx - kq, meta)
    qpos = (base[:, None] + np.arange(kq)[None, :]).astype(np.int32)
    return q, kp, vp, tbl, qpos, kvpos


@pytest.mark.parametrize("b,kq,h,kv,hd,P,ps,num_pages,window,meta", [
    (1, 2, 4, 4, 16, 4, 8, 8, 0, 0),      # MHA, small pool
    (2, 4, 8, 2, 32, 3, 16, 12, 0, 0),    # GQA
    (1, 8, 6, 2, 64, 6, 8, 16, 32, 0),    # sliding window
    (2, 4, 4, 1, 32, 4, 8, 16, 16, 4),    # MQA + meta tokens
])
def test_paged_attention_plain_matches_pallas(b, kq, h, kv, hd, P, ps,
                                              num_pages, window, meta):
    args = _paged_inputs(b, kq, h, kv, hd, P, ps, num_pages, meta=meta)
    got = ops.paged_verify_attention(*(torch.from_numpy(x) for x in args),
                                     window=window, num_meta=meta)
    for fn in (jops.paged_verify_attention, jref.paged_verify_attention):
        want = fn(*(jnp.asarray(x) for x in args), window=window, num_meta=meta)
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_paged_attention_matches_dense_gather():
    b, kq, h, kv, hd, P, ps = 2, 4, 4, 2, 32, 4, 8
    q, kp, vp, tbl, qpos, kvpos = _paged_inputs(b, kq, h, kv, hd, P, ps, 16,
                                                seed=1)
    got = ops.paged_verify_attention(*(torch.from_numpy(x) for x in
                                       (q, kp, vp, tbl, qpos, kvpos)))
    kd = kp[tbl].reshape(b, P * ps, kv, hd)
    vd = vp[tbl].reshape(b, P * ps, kv, hd)
    want = jops.verify_attention(*(jnp.asarray(x) for x in
                                   (q, kd, vd, qpos, kvpos)), block_kv=ps)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_paged_attention_cow_shared_page():
    """Two rows sharing one physical prefix page read identical bytes."""
    args = _paged_inputs(2, 2, 2, 2, 16, 3, 8, 8, share=True, seed=2)
    assert args[3][0, 0] == args[3][1, 0]
    got = ops.paged_verify_attention(*(torch.from_numpy(x) for x in args))
    want = jops.paged_verify_attention(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    assert not torch.isnan(got).any()


# ---------------------------------------------------------------------------
# fused heads (test_kernels.py:199, :212)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,vocab,vp,top_t,block_v", [
    (8, 32, 256, 256, 1, 128),
    (17, 32, 1000, 1024, 4, 256),     # ragged rows + vocab pad
    (64, 64, 504, 512, 2, 512),       # tiny vocab, 1 tile
    (5, 128, 2000, 2048, 4, 1024),
])
def test_heads_topk_plain_matches_pallas(n, d, vocab, vp, top_t, block_v,
                                         dtype):
    rng = np.random.default_rng(3)
    (jo, to), (jw, tw) = (_pair(rng.standard_normal(s), dtype)
                          for s in ((n, d), (d, vp)))
    vals, ids = ops.fused_heads_topk(to, tw, vocab=vocab, top_t=top_t)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    wants = [jref.heads_topk(jo, jw, vocab=vocab, top_t=top_t)]
    if dtype == "float32":   # the Pallas kernel equals its oracle (test_kernels.py)
        wants.append(jops.fused_heads_topk(jo, jw, vocab=vocab, top_t=top_t,
                                           block_v=block_v, block_rows=8))
    for want_v, want_i in wants:
        np.testing.assert_allclose(_np(vals), _np(want_v), **TOL["float32"])
        np.testing.assert_array_equal(_np(ids), _np(want_i))


def test_heads_topk_never_selects_vocab_pad():
    o = torch.ones((4, 16))
    w = torch.ones((16, 512)) * 10.0              # pad lanes equally huge
    _, ids = ops.fused_heads_topk(o, w, vocab=300, top_t=4)
    assert int(ids.max()) < 300
    np.testing.assert_array_equal(_np(ids), np.tile(np.arange(4), (4, 1)))


def test_heads_topk_reads_tied_table_view():
    """The tied table's transpose view (strides (1, d)) gives the same ids
    as a contiguous copy."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((512, 32)).astype(np.float32))
    o = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    got = ops.fused_heads_topk(o, table.t(), vocab=500, top_t=3)
    want = ops.fused_heads_topk(o, table.t().contiguous(), vocab=500, top_t=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


# ---------------------------------------------------------------------------
# fused verify (test_kernels.py:276, :281)
# ---------------------------------------------------------------------------

FV_CRITERIA = ("exact", "topk", "distance")
FV_KW = dict(top_k=3, epsilon=2.0)


def _check_fused_verify(seed, crit, b, k, vocab, dtype, block_v):
    rng = np.random.default_rng(seed)
    props = rng.integers(0, vocab, (b, k)).astype(np.int32)
    jl, tl = _pair(rng.normal(size=(b, k, vocab)), dtype)
    got = ops.fused_verify(tl, torch.from_numpy(props), criterion=crit, **FV_KW)
    assert [t.dtype for t in got] == [torch.bool] + [torch.int32] * 3
    wants = [jref.fused_verify(jl, jnp.asarray(props), criterion=crit, **FV_KW)]
    if dtype == "float32":   # the Pallas kernel equals its oracle (test_kernels.py)
        wants.append(jops.fused_verify(jl, jnp.asarray(props), criterion=crit,
                                       block_rows=8, block_v=block_v, **FV_KW))
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("crit", FV_CRITERIA)
@pytest.mark.parametrize("b,k,vocab,block_v", [
    (3, 4, 128, 128),        # single vocab tile
    (2, 8, 1000, 256),       # ragged vocab (pad lanes in the last tile)
    (5, 6, 333, 128),        # b*k not a sublane multiple
    (1, 2, 2048, 1024),
    (3, 1, 128, 128),        # 1-slot block: nothing to scan
])
def test_fused_verify_plain_matches_pallas(b, k, vocab, block_v, crit, dtype):
    _check_fused_verify(7, crit, b, k, vocab, dtype, block_v)


@pytest.mark.parametrize("crit", FV_CRITERIA)
def test_fused_verify_all_accept_and_all_reject(crit):
    b, k, vocab = 2, 5, 64
    rng = np.random.default_rng(3)
    logits_np = rng.normal(size=(b, k, vocab)).astype(np.float32)
    logits = torch.from_numpy(logits_np)
    greedy = logits_np.argmax(-1)
    props_acc = np.zeros((b, k), np.int32)
    props_acc[:, 1:] = greedy[:, :k - 1]                 # slot i <- greedy i-1
    acc, khat, _, _ = ops.fused_verify(logits, torch.from_numpy(props_acc),
                                       criterion=crit, **FV_KW)
    assert bool(acc.all()) and bool((khat == k).all())
    order = np.argsort(-logits_np, axis=-1)
    props_rej = np.zeros((b, k), np.int32)
    for i in range(b):
        for j in range(1, k):
            cand = [t for t in order[i, j - 1, vocab // 2:]
                    if abs(int(t) - int(greedy[i, j - 1])) > 2]
            props_rej[i, j] = cand[0]
    acc, khat, toks, nxt = ops.fused_verify(
        logits, torch.from_numpy(props_rej), criterion=crit, **FV_KW)
    want = jops.fused_verify(jnp.asarray(logits_np), jnp.asarray(props_rej),
                             criterion=crit, block_rows=8, block_v=64, **FV_KW)
    for g, w in zip((acc, khat, toks, nxt), want):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert bool((khat == 1).all())
    np.testing.assert_array_equal(_np(nxt), greedy[:, 0])


# ---------------------------------------------------------------------------
# dispatch and the kernels' input checks (no card needed)
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    _build.reset_launches()
    q = torch.zeros((1, 2, 2, 64))
    kv = torch.zeros((1, 8, 2, 64))
    pos = torch.zeros((1, 2), dtype=torch.int32)
    ops.verify_attention(q, kv, kv, pos, torch.zeros((1, 8), dtype=torch.int32))
    ops.fused_verify(torch.zeros((1, 3, 16)), torch.zeros((1, 3), dtype=torch.int32),
                     criterion="exact")
    ops.fused_heads_topk(torch.zeros((2, 8)), torch.zeros((8, 16)), vocab=10,
                         top_t=1)
    ops.tree_verify_attention(q, kv, kv, pos, torch.zeros((1, 8), dtype=torch.int32),
                              torch.full((1, 8), -1, dtype=torch.int32),
                              torch.ones((1, 2), dtype=torch.int32))
    ops.paged_verify_attention(q, torch.zeros((3, 8, 2, 64)),
                               torch.zeros((3, 8, 2, 64)),
                               torch.ones((1, 1), dtype=torch.int32), pos,
                               torch.zeros((1, 8), dtype=torch.int32))
    rkv = torch.zeros((1, 3, 2, 16))
    ops.rwkv6_scan(rkv, rkv, rkv, rkv, torch.zeros((2, 16)))
    assert _build.LAUNCHES == {name: 0 for name in _build.KERNELS}


def test_other_devices_raise():
    q = torch.zeros((1, 2, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.verify_attention(q, q, q, q, q)


@pytest.mark.parametrize("call", ["verify_attention", "fused_verify",
                                  "fused_heads", "tree_verify_attention",
                                  "paged_verify_attention", "rwkv6_scan",
                                  "rwkv6_scan_bwd"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers check their inputs before any launch: a CPU
    tensor is refused, never computed."""
    with pytest.raises(ValueError, match="CUDA device"):
        if call == "verify_attention":
            q = torch.zeros((1, 2, 2, 64))
            pos = torch.zeros((1, 2), dtype=torch.int32)
            verify_attention_cuda(q, q, q, pos, pos)
        elif call == "tree_verify_attention":
            q = torch.zeros((1, 2, 2, 64))
            pos = torch.zeros((1, 2), dtype=torch.int32)
            tree_verify_attention_cuda(q, q, q, pos, pos, pos, pos)
        elif call == "paged_verify_attention":
            q = torch.zeros((1, 2, 2, 64))
            pool = torch.zeros((3, 8, 2, 64))
            paged_verify_attention_cuda(q, pool, pool,
                                        torch.ones((1, 1), dtype=torch.int32),
                                        torch.zeros((1, 2), dtype=torch.int32),
                                        torch.zeros((1, 8), dtype=torch.int32))
        elif call == "rwkv6_scan":
            rkv = torch.zeros((1, 3, 2, 16))
            rwkv6_scan_cuda(rkv, rkv, rkv, rkv, torch.zeros((2, 16)))
        elif call == "rwkv6_scan_bwd":
            rkv = torch.zeros((1, 3, 2, 16))
            rwkv6_scan_bwd_cuda(rkv, rkv, rkv, rkv, torch.zeros((2, 16)),
                                torch.zeros((1, 2, 1, 16, 16)), rkv, None,
                                chunk=16)
        elif call == "fused_verify":
            fused_verify_cuda(torch.zeros((1, 3, 16)),
                              torch.zeros((1, 3), dtype=torch.int32),
                              criterion="exact")
        else:
            fused_heads_topk_cuda(torch.zeros((2, 8)), torch.zeros((8, 16)),
                                  vocab=10, top_t=1)


def test_kernel_builds_are_keyed_by_source_hash():
    paths = {name: _build.library_path(name) for name in _build.KERNELS}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").exists()
