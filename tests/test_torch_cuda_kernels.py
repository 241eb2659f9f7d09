"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device; on a
machine with one (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.block_attention import (  # noqa: E402
    tree_verify_attention_cuda, verify_attention_cuda)
from repro_torch.kernels.fused_heads import fused_heads_topk_cuda  # noqa: E402
from repro_torch.kernels.fused_verify import fused_verify_cuda  # noqa: E402
from repro_torch.kernels.paged_attention import paged_verify_attention_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    RWKV6Scan, rwkv6_scan_bwd_cuda, rwkv6_scan_cuda)
from repro_torch.kernels.tree_mask import TreeTopology, default_tree  # noqa: E402
from repro_torch.models import model  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
CRITERIA = ("exact", "topk", "distance")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kq,hd,window,meta", [(1, 128, 0, 0), (8, 128, 0, 0),
                                               (8, 128, 32, 4), (4, 64, 0, 0),
                                               (4, 32, 16, 2)])
def test_verify_attention_kernel_matches_plain(cuda, kq, hd, window, meta, dtype):
    gen = torch.Generator().manual_seed(kq * hd)
    b, h, kvh, l = 2, 32, 8, 300
    q = _randn(gen, (b, kq, h, hd), dtype, cuda)
    k = _randn(gen, (b, l, kvh, hd), dtype, cuda)
    v = _randn(gen, (b, l, kvh, hd), dtype, cuda)
    base = torch.tensor([l - kq, l // 2], dtype=torch.int32)
    q_pos = (base[:, None] + torch.arange(kq, dtype=torch.int32)).to(cuda)
    kv_pos = torch.arange(l, dtype=torch.int32).repeat(b, 1)
    kv_pos[:, ::37] = -1                                  # stale slots
    kv_pos = kv_pos.to(cuda)
    got = verify_attention_cuda(q, k, v, q_pos, kv_pos, window=window,
                                num_meta=meta)
    want = ref.verify_attention(q, k, v, q_pos, kv_pos, window=window,
                                num_meta=meta)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _chain_case(gen, dev, dtype, b, kq, h, kvh, hd, l):
    """A cache of ``l`` slots: row r's queries at l - kq - 3r .. (clamped to
    the cache, so at small l some queries precede every key), every 7th
    slot stale (-1)."""
    q = _randn(gen, (b, kq, h, hd), dtype, dev)
    k = _randn(gen, (b, l, kvh, hd), dtype, dev)
    v = _randn(gen, (b, l, kvh, hd), dtype, dev)
    base = torch.tensor([l - kq - 3 * r for r in range(b)], dtype=torch.int32)
    q_pos = base[:, None] + torch.arange(kq, dtype=torch.int32)
    kv_pos = torch.arange(l, dtype=torch.int32).repeat(b, 1)
    kv_pos[:, 3::7] = -1
    return q, k, v, q_pos.to(dev), kv_pos.to(dev)


def _assert_matches_plain(got, want, dtype):
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 15, 16, 17, 63, 64, 65, 300, 4096])
def test_verify_attention_kernel_split_edges(cuda, l, dtype):
    """Cache lengths at the split plan's edges: one ragged range, a range
    boundary on, before and after a tile, eight ranges."""
    gen = torch.Generator().manual_seed(l)
    args = _chain_case(gen, cuda, dtype, 3, 8, 32, 8, 128, l)
    _assert_matches_plain(verify_attention_cuda(*args),
                          ref.verify_attention(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_attention_kernel_masked_split_and_blind_row(cuda, dtype):
    """L 256 is four ranges of 64: the second range all masked (weight 0 in
    the combine), and query 0 of every row sees no key at all (the mean of
    V over the L keys, as the plain version gives)."""
    gen = torch.Generator().manual_seed(11)
    q, k, v, q_pos, kv_pos = _chain_case(gen, cuda, dtype, 3, 8, 32, 8, 128, 256)
    kv_pos[:, 64:128] = -1
    q_pos[:, 0] = -1
    got = verify_attention_cuda(q, k, v, q_pos, kv_pos)
    want = ref.verify_attention(q, k, v, q_pos, kv_pos)
    _assert_matches_plain(got, want, dtype)
    mean_v = v.float().mean(dim=1).repeat_interleave(4, dim=1)   # (B, H, hd)
    torch.testing.assert_close(got[:, 0].float(), mean_v, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kq,h,hd,l", [(8, 32, 32, 300), (8, 32, 64, 300),
                                       (16, 32, 128, 300),    # kq·G = 64
                                       (16, 32, 64, 4096)])
def test_verify_attention_kernel_head_dims_and_full_rows(cuda, kq, h, hd, l,
                                                         dtype):
    gen = torch.Generator().manual_seed(kq * hd + l)
    args = _chain_case(gen, cuda, dtype, 2, kq, h, 8, hd, l)
    _assert_matches_plain(verify_attention_cuda(*args, window=40, num_meta=3),
                          ref.verify_attention(*args, window=40, num_meta=3),
                          dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [256, 4096])
def test_verify_attention_kernel_is_batch_invariant(cuda, l, dtype):
    """A query's output does not depend on the block or batch around it,
    bit for bit: kq = 1 equals its row at kq = 8, B = 1 its row at B = 8."""
    gen = torch.Generator().manual_seed(l + 1)
    q, k, v, q_pos, kv_pos = _chain_case(gen, cuda, dtype, 8, 8, 32, 8, 128, l)
    full = verify_attention_cuda(q, k, v, q_pos, kv_pos)
    for i in range(8):
        one = verify_attention_cuda(q[:, i:i + 1].contiguous(), k, v,
                                    q_pos[:, i:i + 1].contiguous(), kv_pos)
        assert torch.equal(one, full[:, i:i + 1]), f"query {i}"
    for r in range(8):
        row = verify_attention_cuda(*(t[r:r + 1].contiguous()
                                      for t in (q, k, v, q_pos, kv_pos)))
        assert torch.equal(row, full[r:r + 1]), f"row {r}"


def _tree_case(gen, dev, dtype, b, h, kvh, hd, l, topo, window=0):
    kq = topo.num_nodes
    q = _randn(gen, (b, kq, h, hd), dtype, dev)
    k = _randn(gen, (b, l, kvh, hd), dtype, dev)
    v = _randn(gen, (b, l, kvh, hd), dtype, dev)
    length = torch.tensor([l - kq - 5 * i for i in range(b)], dtype=torch.int32)
    depth = torch.as_tensor(topo.depths, dtype=torch.int32)
    q_pos = length[:, None] + depth[None, :]
    slot = torch.arange(l, dtype=torch.int32)[None, :]
    node = slot - length[:, None]
    tree = (node >= 0) & (node < kq)
    kv_node = torch.where(tree, node, -1).int()
    kv_pos = torch.where(slot < length[:, None], slot,
                         torch.where(tree, length[:, None]
                                     + depth[node.clamp(0, kq - 1)], -1)).int()
    anc = torch.as_tensor(topo.anc_bits, dtype=torch.int32)[None].repeat(b, 1)
    return [t.to(dev) if t.device.type == "cpu" else t
            for t in (q, k, v, q_pos, kv_pos, kv_node, anc)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("topo,h,window", [
    (default_tree(8, 2), 32, 0), (default_tree(8, 4), 32, 0),
    (default_tree(8, 2), 32, 24),
    (TreeTopology((-1,) + tuple(range(31))), 16, 0)])   # bit 31, G = 2
def test_tree_verify_attention_kernel_matches_plain(cuda, topo, h, window, dtype):
    gen = torch.Generator().manual_seed(topo.num_nodes + h)
    args = _tree_case(gen, cuda, dtype, 2, h, 8, 128, 300, topo)
    got = tree_verify_attention_cuda(*args, window=window)
    want = ref.tree_verify_attention(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_tree_kernel_on_a_chain_equals_verify_kernel(cuda):
    """On a chain the ancestor bits pass exactly the causal keys, so the
    tree kernel gives verify_attention's output bit for bit."""
    topo = TreeTopology((-1,) + tuple(range(7)))
    for dtype in (torch.float32, torch.bfloat16):
        for l in (256, 300, 4096):
            gen = torch.Generator().manual_seed(5 + l)
            q, k, v, q_pos, kv_pos, kv_node, anc = _tree_case(
                gen, cuda, dtype, 2, 32, 8, 128, l, topo)
            got = tree_verify_attention_cuda(q, k, v, q_pos, kv_pos, kv_node, anc)
            want = verify_attention_cuda(q, k, v, q_pos, kv_pos)
            assert torch.equal(got, want), (dtype, l)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,hd", [(17, 128), (65, 128), (300, 64),
                                  (4096, 128), (300, 32)])
def test_tree_verify_attention_kernel_split_edges(cuda, l, hd, dtype):
    topo = default_tree(8, 2)
    gen = torch.Generator().manual_seed(l * hd)
    args = _tree_case(gen, cuda, dtype, 3, 32, 8, hd, max(l, 8), topo)
    _assert_matches_plain(tree_verify_attention_cuda(*args),
                          ref.tree_verify_attention(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_verify_attention_kernel_is_batch_invariant(cuda, dtype):
    """A batch row's output does not depend on the rows beside it."""
    gen = torch.Generator().manual_seed(21)
    args = _tree_case(gen, cuda, dtype, 8, 32, 8, 128, 256, default_tree(8, 4))
    full = tree_verify_attention_cuda(*args)
    for r in range(8):
        row = tree_verify_attention_cuda(*(t[r:r + 1].contiguous() for t in args))
        assert torch.equal(row, full[r:r + 1]), f"row {r}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,kq,window", [(8, 8, 0), (16, 8, 0), (16, 1, 0),
                                          (16, 8, 40)])
def test_paged_verify_attention_kernel_matches_plain(cuda, ps, kq, window, dtype):
    gen = torch.Generator().manual_seed(ps * kq)
    b, h, kvh, hd, P = 3, 32, 8, 128, 9
    num_pages = 1 + b * P
    q = _randn(gen, (b, kq, h, hd), dtype, cuda)
    kp = _randn(gen, (num_pages, ps, kvh, hd), dtype, cuda)
    vp = _randn(gen, (num_pages, ps, kvh, hd), dtype, cuda)
    tbl = 1 + torch.randperm(b * P, generator=gen).int().reshape(b, P)
    tbl[1, 0] = tbl[0, 0]                         # two rows share a page
    ctx = torch.tensor([P * ps - 3, 5 * ps, 2 * ps + 1])
    slot = torch.arange(P * ps)[None, :]
    kv_pos = torch.where(slot < ctx[:, None], slot, -1).int()
    tbl[2, 3:] = 0                                # unmapped: trash page, pos -1
    q_pos = (ctx[:, None] - kq + torch.arange(kq)[None, :]).int()
    args = [q, kp, vp, tbl.to(cuda), q_pos.to(cuda), kv_pos.to(cuda)]
    got = paged_verify_attention_cuda(*args, window=window)
    want = ref.paged_verify_attention(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _paged_case(gen, dev, dtype, b, kq, P, ps, *, h=32, kvh=8, hd=128,
                unmapped=0):
    """A pool of 1 + B·P pages under a shuffled table; row 1 shares row 0's
    pages at even page indices (the split plan's edges included); the last
    ``unmapped`` pages of the last row point at trash page 0 with pos -1;
    row r holds positions 0 .. P·ps - 3r - 1."""
    num_pages = 1 + b * P
    q = _randn(gen, (b, kq, h, hd), dtype, dev)
    kp = _randn(gen, (num_pages, ps, kvh, hd), dtype, dev)
    vp = _randn(gen, (num_pages, ps, kvh, hd), dtype, dev)
    tbl = 1 + torch.randperm(b * P, generator=gen).int().reshape(b, P)
    if b > 1:
        tbl[1, ::2] = tbl[0, ::2]
    ctx = torch.tensor([max(kq, P * ps - 3 * r) for r in range(b)])
    slot = torch.arange(P * ps)[None, :]
    kv_pos = torch.where(slot < ctx[:, None], slot, -1).int()
    if unmapped:
        tbl[-1, P - unmapped:] = 0
        kv_pos[-1, (P - unmapped) * ps:] = -1
    q_pos = (ctx[:, None] - kq + torch.arange(kq)[None, :]).int()
    return [q, kp, vp] + [t.contiguous().to(dev) for t in (tbl, q_pos, kv_pos)]


def _gathered(q, kp, vp, tbl, q_pos, kv_pos):
    """The dense view kp[tbl] the paged kernel reads through its table."""
    b, P = tbl.shape
    _, ps, kvh, hd = kp.shape
    k = kp[tbl.long()].reshape(b, P * ps, kvh, hd).contiguous()
    v = vp[tbl.long()].reshape(b, P * ps, kvh, hd).contiguous()
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,ps", [(9, 16), (256, 16), (18, 8)])
def test_paged_kernel_equals_verify_kernel_on_the_gathered_view(cuda, P, ps,
                                                                dtype):
    """L 144 (the path's) and 4096: the paged kernel gives
    verify_attention's output on kp[tbl] bit for bit, shared and unmapped
    pages included."""
    gen = torch.Generator().manual_seed(P * ps)
    args = _paged_case(gen, cuda, dtype, 8, 8, P, ps, unmapped=3)
    got = paged_verify_attention_cuda(*args)
    assert torch.equal(got, verify_attention_cuda(*_gathered(*args)))
    _assert_matches_plain(got, ref.paged_verify_attention(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_verify_attention_kernel_is_batch_invariant(cuda, dtype):
    """kq 1 equals its row at kq 8 and B 1 its row at B 8, bit for bit."""
    gen = torch.Generator().manual_seed(31)
    q, kp, vp, tbl, q_pos, kv_pos = _paged_case(gen, cuda, dtype, 8, 8, 9, 16,
                                                unmapped=2)
    full = paged_verify_attention_cuda(q, kp, vp, tbl, q_pos, kv_pos)
    for i in range(8):
        one = paged_verify_attention_cuda(q[:, i:i + 1].contiguous(), kp, vp,
                                          tbl, q_pos[:, i:i + 1].contiguous(),
                                          kv_pos)
        assert torch.equal(one, full[:, i:i + 1]), f"query {i}"
    for r in range(8):
        row = paged_verify_attention_cuda(
            q[r:r + 1].contiguous(), kp, vp, tbl[r:r + 1].contiguous(),
            q_pos[r:r + 1].contiguous(), kv_pos[r:r + 1].contiguous())
        assert torch.equal(row, full[r:r + 1]), f"row {r}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,ps", [(16, 16), (64, 16), (80, 16), (144, 16),
                                  (528, 16), (144, 8), (544, 32)])
def test_paged_verify_attention_kernel_split_edges(cuda, l, ps, dtype):
    """Cache lengths at the split plan's edges (one range; a range of 64;
    two ragged ranges; three of 48; seven of 80; at ps 32 ranges of 80 that
    start inside pages), with shared and unmapped pages."""
    gen = torch.Generator().manual_seed(l + 3)
    args = _paged_case(gen, cuda, dtype, 3, 8, l // ps, ps,
                       unmapped=1 if l > ps else 0)
    got = paged_verify_attention_cuda(*args, window=40, num_meta=3)
    _assert_matches_plain(got, ref.paged_verify_attention(*args, window=40,
                                                          num_meta=3), dtype)
    assert torch.equal(got, verify_attention_cuda(*_gathered(*args), window=40,
                                                  num_meta=3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4)])   # quickstart, superres
@pytest.mark.parametrize("l", [60, 200])
def test_split_attention_kernels_head_dim_24(cuda, l, h, kvh, dtype):
    """head_dim 24 (computed at 32 with lanes 24-31 zero, scale 1/√24): the
    three split-KV kernels equal their plain versions, a query's output is
    the same bit for bit at kq 1 and B 1, and the paged kernel equals
    verify_attention on the gathered view."""
    gen = torch.Generator().manual_seed(24 * l + h * kvh)
    args = _chain_case(gen, cuda, dtype, 8, 4, h, kvh, 24, l)
    full = verify_attention_cuda(*args, window=40, num_meta=3)
    _assert_matches_plain(full, ref.verify_attention(*args, window=40,
                                                     num_meta=3), dtype)
    q, k, v, q_pos, kv_pos = args
    for i in range(4):
        one = verify_attention_cuda(q[:, i:i + 1].contiguous(), k, v,
                                    q_pos[:, i:i + 1].contiguous(), kv_pos,
                                    window=40, num_meta=3)
        assert torch.equal(one, full[:, i:i + 1]), f"query {i}"
    for r in range(8):
        row = verify_attention_cuda(*(t[r:r + 1].contiguous() for t in args),
                                    window=40, num_meta=3)
        assert torch.equal(row, full[r:r + 1]), f"row {r}"
    targs = _tree_case(gen, cuda, dtype, 8, h, kvh, 24, l, default_tree(4, 2))
    tree = tree_verify_attention_cuda(*targs)
    _assert_matches_plain(tree, ref.tree_verify_attention(*targs), dtype)
    for r in range(8):
        row = tree_verify_attention_cuda(*(t[r:r + 1].contiguous() for t in targs))
        assert torch.equal(row, tree[r:r + 1]), f"tree row {r}"
    pargs = _paged_case(gen, cuda, dtype, 8, 4, -(-l // 16), 16, h=h, kvh=kvh,
                        hd=24, unmapped=1)
    paged = paged_verify_attention_cuda(*pargs)
    _assert_matches_plain(paged, ref.paged_verify_attention(*pargs), dtype)
    assert torch.equal(paged, verify_attention_cuda(*_gathered(*pargs)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd,kq,nodes", [
    (32, 8, 160, 8, 32),     # stablelm-12b: head_dim 160; the tree 128 rows
    (36, 4, 128, 8, 8),      # starcoder2-7b: G 9, 72 rows (two row tiles)
    (36, 4, 128, 32, 32),    # 288 rows (five row tiles)
    (36, 4, 128, 7, 8),      # 63 rows (one tile)
])
def test_split_attention_kernels_family_heads(cuda, h, kvh, hd, kq, nodes,
                                              dtype):
    """The dense text families' heads: the three split-KV kernels equal
    their plain versions, a query's output is the same bit for bit at kq 1
    and B 1 whichever row tile holds it, and the paged kernel equals
    verify_attention on the gathered view."""
    gen = torch.Generator().manual_seed(h * hd + kq)
    b, l = 4, 300
    args = _chain_case(gen, cuda, dtype, b, kq, h, kvh, hd, l)
    full = verify_attention_cuda(*args, window=40, num_meta=3)
    _assert_matches_plain(full, ref.verify_attention(*args, window=40,
                                                     num_meta=3), dtype)
    q, k, v, q_pos, kv_pos = args
    for i in range(kq):
        one = verify_attention_cuda(q[:, i:i + 1].contiguous(), k, v,
                                    q_pos[:, i:i + 1].contiguous(), kv_pos,
                                    window=40, num_meta=3)
        assert torch.equal(one, full[:, i:i + 1]), f"query {i}"
    for r in range(b):
        row = verify_attention_cuda(*(t[r:r + 1].contiguous() for t in args),
                                    window=40, num_meta=3)
        assert torch.equal(row, full[r:r + 1]), f"row {r}"
    targs = _tree_case(gen, cuda, dtype, b, h, kvh, hd, l,
                       default_tree(nodes, 4))
    tree = tree_verify_attention_cuda(*targs)
    _assert_matches_plain(tree, ref.tree_verify_attention(*targs), dtype)
    for r in range(b):
        row = tree_verify_attention_cuda(*(t[r:r + 1].contiguous() for t in targs))
        assert torch.equal(row, tree[r:r + 1]), f"tree row {r}"
    pargs = _paged_case(gen, cuda, dtype, b, kq, -(-l // 16), 16, h=h, kvh=kvh,
                        hd=hd, unmapped=1)
    paged = paged_verify_attention_cuda(*pargs)
    _assert_matches_plain(paged, ref.paged_verify_attention(*pargs), dtype)
    assert torch.equal(paged, verify_attention_cuda(*_gathered(*pargs)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("crit", CRITERIA)
@pytest.mark.parametrize("k", [8, 1])
def test_fused_verify_kernel_matches_plain(cuda, k, crit, dtype):
    rng = np.random.default_rng(6)
    lg = torch.from_numpy(rng.normal(size=(8, k, 4000)).astype(np.float32))
    lg = lg.to(cuda, dtype)
    props = torch.from_numpy(rng.integers(0, 4000, (8, k)).astype(np.int32)).to(cuda)
    props[:, 1:4] = torch.argmax(lg[:, :3].float(), -1).int()[:, :k - 1]
    got = fused_verify_cuda(lg, props, criterion=crit, top_k=3, epsilon=2.0)
    want = ref.fused_verify(lg, props, criterion=crit, top_k=3, epsilon=2.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ties", "ties T8", "unaligned V",
                                  "B 1 k 32 T 8", "k 3 split"])
def test_fused_verify_kernel_ties_and_splits(cuda, case, dtype):
    """Bit for bit equal to the plain version on logits quantised to four
    values (thousands of exact ties a row, -1e9 pad lanes), on rows that
    start off 16-byte boundaries (V 4099 unpadded), at the largest block
    and T, and where verify_plan cuts each slot into eight ranges."""
    rng = np.random.default_rng(8)
    b, k, vp, kw = 8, 8, 4352, dict(top_k=3, epsilon=2.0)
    if case == "B 1 k 32 T 8":
        b, k, kw = 1, 32, dict(top_k=8)
    elif case == "k 3 split":
        k, vp = 3, 20000
    lg = rng.normal(size=(b, k, vp)).astype(np.float32)
    if case.startswith("ties"):
        lg = rng.integers(0, 4, (b, k, vp)).astype(np.float32) * 0.5
        lg[..., 4099:] = -1e9
    if case == "ties T8":
        kw = dict(top_k=8)
    if case == "unaligned V":
        lg = lg[..., :4099]
    lg = torch.from_numpy(np.ascontiguousarray(lg)).to(cuda, dtype)
    props = torch.from_numpy(rng.integers(0, lg.shape[-1], (b, k)).astype(np.int32)).to(cuda)
    props[:, 1:] = torch.argmax(lg.float(), -1).int()[:, :k - 1]
    props[:, k // 2] += 1                          # reject half-way
    for crit in CRITERIA:
        got = fused_verify_cuda(lg, props, criterion=crit, **kw)
        want = ref.fused_verify(lg, props, criterion=crit, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), crit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab", [16, 32])
@pytest.mark.parametrize("k", [4, 1])
def test_fused_verify_kernel_small_vocab(cuda, k, vocab, dtype):
    """The quickstart and superres models' logits: vocab 16 or 32 padded to
    256 lanes that hold -1e9; bit for bit the plain version."""
    rng = np.random.default_rng(vocab + k)
    lg = rng.normal(size=(8, k, 256)).astype(np.float32)
    lg[..., vocab:] = -1e9
    lg = torch.from_numpy(lg).to(cuda, dtype)
    props = torch.from_numpy(rng.integers(0, vocab, (8, k)).astype(np.int32)).to(cuda)
    props[:, 1:] = torch.argmax(lg.float(), -1).int()[:, :k - 1]
    if k > 2:
        props[::2, 2] = (props[::2, 2] + 1) % vocab        # reject some rows
    for crit in CRITERIA:
        got = fused_verify_cuda(lg, props, criterion=crit, top_k=2, epsilon=2.0)
        want = ref.fused_verify(lg, props, criterion=crit, top_k=2, epsilon=2.0)
        for g, w in zip(got, want):
            assert torch.equal(g, w), crit


HEADS_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: TOL[torch.bfloat16]}
HEADS_TIE_MARGIN = 1e-3        # of max|logit|, as chip_smoke.py's near-ties


def _heads_case(rng, dev, dtype, n, d, vp, layout):
    """o (N, d) and w (d, Vp) from a seeded numpy generator: the tied
    table's transpose view, or a row-major (d, Vp) lm_head."""
    o = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((vp, d)).astype(np.float32))
    o, table = o.to(dev, dtype), table.to(dev, dtype)
    w = table.t() if layout == "tied" else table.t().contiguous()
    return o, w


def _assert_heads_match(o, w, vocab, top_t, dtype):
    """Values at the tolerance; fp32 ids equal; bf16 ids equal, except where
    the plain version's logit at the kernel's id is within HEADS_TIE_MARGIN
    of max|logit| of the plain value at that rank (a near-tie that the
    tensor cores sum in another order)."""
    vals, ids = fused_heads_topk_cuda(o, w, vocab=vocab, top_t=top_t)
    wv, wi = ref.heads_topk(o, w, vocab=vocab, top_t=top_t)
    torch.testing.assert_close(vals, wv, **HEADS_TOL[dtype])
    assert int(ids.max()) < vocab and int(ids.min()) >= 0
    if dtype == torch.float32:
        assert torch.equal(ids, wi)
    elif not torch.equal(ids, wi):
        logits = o.float() @ w.float()
        margin = HEADS_TIE_MARGIN * logits[:, :vocab].abs().max()
        at_kernel = torch.gather(logits, 1, ids.long())
        assert bool(((at_kernel - wv).abs() <= margin)[ids != wi].all())
    return ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["tied", "row-major"])
@pytest.mark.parametrize("top_t", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 56, 64, 65, 200])
def test_fused_heads_kernel_matches_plain(cuda, n, top_t, layout, dtype):
    """Rows 1 .. 200 (one row tile of 64 and past it), T 1 .. 8, both
    layouts; Vp 1000 is not a multiple of the 128-lane tile."""
    rng = np.random.default_rng(7 + n + top_t)
    o, w = _heads_case(rng, cuda, dtype, n, 256, 1000, layout)
    _assert_heads_match(o, w, 990, top_t, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["tied", "row-major"])
@pytest.mark.parametrize("d,vp,vocab", [(200, 1000, 1000),    # d % 64 != 0
                                        (64, 128, 5),         # one tile
                                        (2048, 65536, 65536),  # rwkv6's head
                                        (4096, 8192, 8000),
                                        (6144, 4096, 4000),   # nemotron's d
                                        (7168, 4096, 4096),   # llava's d
                                        (96, 256, 32),        # quickstart
                                        (64, 256, 16)])       # superres grid
def test_fused_heads_kernel_shapes(cuda, d, vp, vocab, layout, dtype):
    rng = np.random.default_rng(d + vp)
    o, w = _heads_case(rng, cuda, dtype, 56, d, vp, layout)
    _assert_heads_match(o, w, vocab, 4, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["tied", "row-major"])
def test_fused_heads_kernel_pad_lanes_never_win(cuda, layout, dtype):
    """vocab < Vp and the pad lanes hold the largest logits: none is ever
    selected, and the lanes below vocab are ranked as the plain version
    ranks them."""
    rng = np.random.default_rng(3)
    o, w = _heads_case(rng, cuda, dtype, 56, 256, 1024, layout)
    o = o.abs()
    w = w.clone() if layout == "row-major" else w.t().clone().t()
    w[:, 900:] = 4.0
    ids = _assert_heads_match(o, w, 900, 8, dtype)
    assert int(ids.max()) < 900


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_heads_kernel_ties_take_the_lowest_id(cuda, dtype):
    """Equal logits rank by id, as lax.top_k: a table of repeated columns."""
    o = torch.ones((8, 64), device=cuda, dtype=dtype)
    table = torch.zeros((640, 64), device=cuda, dtype=dtype)
    table[300:310] = 1.0
    table[500:505] = 1.0
    vals, ids = fused_heads_topk_cuda(o, table.t(), vocab=640, top_t=8)
    assert ids[0].tolist() == list(range(300, 308))
    assert torch.equal(ids, ids[:1].expand(8, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,strong", [
    (1, 16, 1, 16, False),
    (2, 37, 3, 16, False),       # ragged: S % 16 != 0
    (1, 128, 2, 64, False),
    (2, 64, 2, 32, False),
    (2, 40, 2, 128, False),
    (1, 48, 1, 16, True),        # strong decay, w = e^-8
    (8, 512, 32, 64, False),     # the serve path's prefill
])
def test_rwkv6_scan_kernel_matches_plain(cuda, b, s, h, d, strong, dtype):
    """fp32 sums in another order than the plain version's: 1e-4 relative,
    and 1e-4 of the largest output absolute."""
    gen = torch.Generator().manual_seed(b * 1000 + s + d)
    r, k, v = (_randn(gen, (b, s, h, d), dtype, cuda) for _ in range(3))
    if strong:
        logw = torch.full((b, s, h, d), -8.0, device=cuda)
    else:
        logw = -torch.exp(_randn(gen, (b, s, h, d), torch.float32, cuda) * 0.5 - 1.0)
    u = _randn(gen, (h, d), torch.float32, cuda) * 0.1
    y, state = rwkv6_scan_cuda(r, k, v, logw, u)
    wy, ws = ref.rwkv6_scan(r, k, v, logw, u)
    torch.cuda.synchronize()
    for got, want in ((y, wy), (state, ws)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["logw -20", "mixed"])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_rwkv6_scan_kernel_extreme_decay(cuda, d, kind, dtype):
    """Decay past the reference's chunk range (logw -20 everywhere, or w =
    1 beside w = e^-20 channel by channel): within the same tolerance."""
    gen = torch.Generator().manual_seed(d)
    b, s, h = 2, 41, 2
    r, k, v = (_randn(gen, (b, s, h, d), dtype, cuda) for _ in range(3))
    logw = torch.full((b, s, h, d), -20.0, device=cuda)
    if kind == "mixed":
        logw[..., ::2] = 0.0
    u = _randn(gen, (h, d), torch.float32, cuda) * 0.1
    y, state = rwkv6_scan_cuda(r, k, v, logw, u)
    wy, ws = ref.rwkv6_scan(r, k, v, logw, u)
    torch.cuda.synchronize()
    for got, want in ((y, wy), (state, ws)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_rwkv6_scan_checkpoints_leave_the_forward_bit_for_bit(cuda, chunk, dtype):
    """With checkpoints the kernel's y and final state are bit for bit those
    without, and each checkpoint is the plain recurrence's state at its
    chunk's start."""
    gen = torch.Generator().manual_seed(chunk)
    b, s, h, d = 2, 77, 3, 64
    r, k, v = (_randn(gen, (b, s, h, d), dtype, cuda) for _ in range(3))
    logw = -torch.exp(_randn(gen, (b, s, h, d), torch.float32, cuda) * 0.5 - 1.0)
    u = _randn(gen, (h, d), torch.float32, cuda) * 0.1
    y0, s0 = rwkv6_scan_cuda(r, k, v, logw, u)
    y1, s1, ck = rwkv6_scan_cuda(r, k, v, logw, u, chunk=chunk)
    _, _, want = ref.rwkv6_scan(r, k, v, logw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    assert ck.shape == want.shape == (b, h, -(-s // chunk), d, d)
    torch.testing.assert_close(ck, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,chunk,logw_kind,with_dstate", [
    (1, 1, 2, 16, 16, "mild", False),
    (2, 17, 3, 32, 16, "mild", True),
    (2, 37, 2, 64, 32, "-8", True),
    (1, 40, 2, 128, 16, "-20", False),
    (2, 33, 2, 64, 16, "mixed", True),
    (1, 77, 2, 128, 64, "mild", True),      # three tiles replayed a chunk
    (4, 512, 32, 64, 16, "mild", False),    # rwkv6-1.6b's training shape
])
def test_rwkv6_scan_bwd_kernel_matches_plain(cuda, b, s, h, d, chunk,
                                             logw_kind, with_dstate, dtype):
    """The reverse scan against its plain version from the same
    checkpoints: each output within 1e-4 of its own max |value|."""
    gen = torch.Generator().manual_seed(s * 10 + d)
    r, k, v = (_randn(gen, (b, s, h, d), dtype, cuda) for _ in range(3))
    if logw_kind == "mild":
        logw = -torch.exp(_randn(gen, (b, s, h, d), torch.float32, cuda) * 0.5 - 1.0)
    else:
        logw = torch.full((b, s, h, d), -20.0 if logw_kind != "-8" else -8.0,
                          device=cuda)
        if logw_kind == "mixed":
            logw[..., ::2] = 0.0
    u = _randn(gen, (h, d), torch.float32, cuda) * 0.1
    dy = _randn(gen, (b, s, h, d), torch.float32, cuda)
    ds = _randn(gen, (b, h, d, d), torch.float32, cuda) if with_dstate else None
    _, _, ck = ref.rwkv6_scan(r, k, v, logw, u, chunk=chunk)
    got = rwkv6_scan_bwd_cuda(r, k, v, logw, u, ck, dy, ds, chunk=chunk)
    want = ref.rwkv6_scan_bwd(r, k, v, logw, u, ck, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_rwkv6_scan_autograd_on_the_card(cuda):
    """``RWKV6Scan`` on CUDA tensors launches the forward with checkpoints
    and the backward once each, and its gradients equal the CPU's."""
    gen = torch.Generator().manual_seed(5)
    b, s, h, d = 2, 45, 2, 32
    cpu = [torch.randn((b, s, h, d), generator=gen) for _ in range(3)]
    cpu.append(-torch.exp(torch.randn((b, s, h, d), generator=gen) * 0.5 - 1.0))
    cpu.append(torch.randn((h, d), generator=gen) * 0.1)
    w_y = torch.randn((b, s, h, d), generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        xs = [x.detach().to(dev).requires_grad_(True) for x in cpu]
        _build.reset_launches()
        y, state = RWKV6Scan.apply(*xs, 16)
        (y * w_y.to(dev)).sum().backward()
        grads.append([x.grad.cpu() for x in xs])
    assert _build.LAUNCHES["rwkv6_scan"] == _build.LAUNCHES["rwkv6_scan_bwd"] == 1
    assert _build.CHECKPOINTED_SCANS == 1
    for g, w in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_rwkv6_scan_kernel_refuses_other_head_dims(cuda):
    x = torch.zeros((1, 4, 1, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        rwkv6_scan_cuda(x, x, x, x, torch.zeros((1, 48), device=cuda))


def test_rwkv6_scan_kernel_refuses_misaligned_inputs(cuda):
    """cp.async copies 16 bytes at a time: a view that starts off a 16-byte
    boundary is refused before any launch."""
    x = torch.zeros((1 * 4 * 1 * 16 + 1,), device=cuda)[1:].view(1, 4, 1, 16)
    ok = torch.zeros((1, 4, 1, 16), device=cuda)
    with pytest.raises(ValueError, match="16-byte boundaries"):
        rwkv6_scan_cuda(x, ok, ok, ok, torch.zeros((1, 16), device=cuda))


def test_every_launch_is_counted(cuda):
    _build.reset_launches()
    q = torch.zeros((1, 2, 4, 64), device=cuda)
    kv = torch.zeros((1, 16, 2, 64), device=cuda)
    pos = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    verify_attention_cuda(q, kv, kv, pos, torch.zeros((1, 16), dtype=torch.int32,
                                                      device=cuda))
    fused_verify_cuda(torch.zeros((1, 3, 16), device=cuda),
                      torch.zeros((1, 3), dtype=torch.int32, device=cuda),
                      criterion="exact")
    fused_heads_topk_cuda(torch.zeros((2, 8), device=cuda),
                          torch.zeros((8, 16), device=cuda), vocab=10, top_t=1)
    node = torch.full((1, 16), -1, dtype=torch.int32, device=cuda)
    tree_verify_attention_cuda(q, kv, kv, pos, node + 1, node,
                               torch.ones((1, 2), dtype=torch.int32, device=cuda))
    pool = torch.zeros((3, 8, 2, 64), device=cuda)
    paged_verify_attention_cuda(q, pool, pool,
                                torch.ones((1, 2), dtype=torch.int32, device=cuda),
                                pos, node + 1)
    rkv = torch.zeros((1, 3, 2, 16), device=cuda)
    u = torch.zeros((2, 16), device=cuda)
    rwkv6_scan_cuda(rkv, rkv, rkv, rkv, u)
    rwkv6_scan_bwd_cuda(rkv, rkv, rkv, rkv, u,
                        torch.zeros((1, 2, 1, 16, 16), device=cuda), rkv, None,
                        chunk=16)
    assert _build.LAUNCHES == {name: 1 for name in _build.KERNELS}


def test_one_slot_block_goes_through_the_kernel(cuda):
    """k = 1 on a CUDA tensor launches the kernel, as any other k does."""
    from repro_torch.kernels import ops

    lg = torch.randn((4, 1, 300), generator=torch.Generator().manual_seed(3))
    props = torch.zeros((4, 1), dtype=torch.int32)
    _build.reset_launches()
    got = ops.fused_verify(lg.to(cuda), props.to(cuda), criterion="exact")
    assert _build.LAUNCHES["fused_verify"] == 1
    for g, w in zip(got, ref.fused_verify(lg, props, criterion="exact")):
        assert torch.equal(g.cpu(), w)


def test_decode_on_the_card_goes_through_the_kernels(cuda):
    """A small model decoded on the card: BPD emits greedy's tokens, and
    every forward ran the kernels."""
    cfg = ModelConfig(name="t", num_layers=2, d_model=256, num_heads=8,
                      num_kv_heads=2, d_ff=512, vocab_size=1000, bpd_k=4,
                      dtype="float32")
    params = model.init(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, 1000, (4, 8), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    dec = DecodeConfig(max_new_tokens=16, block_k=4)
    _build.reset_launches()
    bt, bs = decode.bpd_decode(params, cfg, dec, {"tokens": prompt})
    assert _build.LAUNCHES["verify_attention"] == 2 * bs["iterations"]
    assert _build.LAUNCHES["fused_verify"] == bs["iterations"]
    assert _build.LAUNCHES["fused_heads"] == bs["iterations"] + 1
    gt, _ = decode.greedy_decode(params, cfg, dec, {"tokens": prompt})
    assert torch.equal(bt[:, :24], gt[:, :24])


@pytest.mark.parametrize("policy,backend", [("exact", "paged"),
                                            ("topk_tree", "dense"),
                                            ("topk_tree", "paged")])
def test_tree_and_paged_decode_on_the_card(cuda, policy, backend):
    """Tree verification and the paged cache on the card: greedy's tokens,
    and the forwards ran the tree or paged kernel in every layer."""
    cfg = ModelConfig(name="t", num_layers=2, d_model=256, num_heads=8,
                      num_kv_heads=2, d_ff=512, vocab_size=1000, bpd_k=8,
                      dtype="float32")
    params = model.init(cfg, seed=1, device=cuda)
    prompt = torch.randint(0, 1000, (4, 8), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2)).to(cuda)
    dec = DecodeConfig(max_new_tokens=16, block_k=8, policy=policy,
                       cache_backend=backend)
    _build.reset_launches()
    bt, bs = decode.bpd_decode(params, cfg, dec, {"tokens": prompt})
    kernel = "tree_verify_attention" if policy == "topk_tree" else "paged_verify_attention"
    assert _build.LAUNCHES[kernel] == 2 * bs["iterations"]
    assert _build.LAUNCHES["verify_attention"] == 0
    gt, _ = decode.greedy_decode(params, cfg, dec, {"tokens": prompt})
    assert torch.equal(bt[:, :24], gt[:, :24])


@pytest.mark.parametrize("backend,spd", [("paged", 1), ("dense", 3)])
def test_two_group_engine_on_the_card(cuda, backend, spd):
    """The continuous-batching engine on the card: an exact and a
    topk_tree slot group, 8 requests through 4 slots (eviction and
    re-admission), on the managed page pool or the dense slab; each
    request's tokens are greedy's, every group step launched its group's
    kernels in every layer, and each function was built once."""
    from repro_torch import serving

    cfg = ModelConfig(name="t", num_layers=2, d_model=256, num_heads=8,
                      num_kv_heads=2, d_ff=512, vocab_size=1000, bpd_k=8,
                      dtype="float32")
    params = model.init(cfg, seed=3, device=cuda)
    dec = DecodeConfig(max_new_tokens=16, block_k=8, top_k=2,
                       cache_backend=backend)
    eng = serving.ContinuousBatchingEngine(
        params, cfg, dec, serving.EngineConfig(num_slots=4, max_prompt_len=8,
                                               max_new_cap=16,
                                               steps_per_sync=spd),
        policies={"exact": 2, "topk_tree": 2})
    sched = serving.Scheduler(eng)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, 1000, (8, 8), dtype=torch.int32, generator=gen)
    for i in range(8):
        sched.submit(serving.Request(rid=i, prompt=prompts[i].numpy(),
                                     max_new=8 + i, arrival=0.0,
                                     policy=("exact", "topk_tree")[i % 2]))
    _build.reset_launches()
    now, done = 0.0, []
    while not sched.drained():
        done += sched.step(now=now)
        now += 1.0
    assert len(done) == 8
    fwd = {g.name: g.num_forwards for g in eng.groups}
    pre = {g.name: g.num_prefills for g in eng.groups}
    attn = "paged_verify_attention" if backend == "paged" else "verify_attention"
    assert _build.LAUNCHES[attn] == 2 * fwd["exact"]
    assert _build.LAUNCHES["tree_verify_attention"] == 2 * fwd["topk_tree"]
    assert _build.LAUNCHES["fused_verify"] == sum(fwd.values())
    assert _build.LAUNCHES["fused_heads"] == sum(fwd.values()) + sum(pre.values())
    assert all(v == 1 for v in eng.compile_counts().values())
    gt, _ = decode.greedy_decode(params, cfg, dec,
                                 {"tokens": prompts.to(cuda)})
    for f in done:
        assert f.tokens.tolist() == gt[f.rid, 8:8 + 8 + f.rid].tolist(), f.rid


def test_rwkv6_decode_on_the_card(cuda):
    """A small RWKV-6 model decoded on the card: BPD emits greedy's tokens,
    each prefill scans through the kernel once per layer, and decode
    iterations launch no scan."""
    cfg = ModelConfig(name="t", num_layers=2, d_model=128, d_ff=256,
                      vocab_size=1000, block_type="rwkv6",
                      mlp_type="rwkv_channel_mix", rwkv_head_dim=32,
                      num_heads=0, num_kv_heads=0, bpd_k=4, dtype="float32")
    params = model.init(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, 1000, (4, 37), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    dec = DecodeConfig(max_new_tokens=16, block_k=4)
    _build.reset_launches()
    bt, bs = decode.bpd_decode(params, cfg, dec, {"tokens": prompt})
    assert _build.LAUNCHES["rwkv6_scan"] == 2
    assert _build.LAUNCHES["fused_verify"] == bs["iterations"]
    assert _build.LAUNCHES["fused_heads"] == bs["iterations"] + 1
    gt, _ = decode.greedy_decode(params, cfg, dec, {"tokens": prompt})
    assert torch.equal(bt[:, :53], gt[:, :53])


# ---------------------------------------------------------------------------
# head_dim 16 (the trained policy-sweep model) and cross attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["verify", "tree", "paged"])
def test_attention_kernels_at_head_dim_16(cuda, kernel, dtype):
    """The three split-KV kernels at head_dim 16: equal to their plain
    versions, and a batch row alone equal to its row at B = 4 bit for
    bit."""
    gen = torch.Generator().manual_seed(16)
    if kernel == "verify":
        fn, plain = verify_attention_cuda, ref.verify_attention
        args = _chain_case(gen, cuda, dtype, 4, 8, 4, 4, 16, 300)
    elif kernel == "tree":
        fn, plain = tree_verify_attention_cuda, ref.tree_verify_attention
        args = _tree_case(gen, cuda, dtype, 4, 4, 4, 16, 300, default_tree(8, 2))
    else:
        fn, plain = paged_verify_attention_cuda, ref.paged_verify_attention
        args = _paged_case(gen, cuda, dtype, 4, 8, 9, 16, h=4, kvh=4, hd=16)
    full = fn(*args)
    _assert_matches_plain(full, plain(*args), dtype)
    if kernel == "paged":
        q, kp, vp, tbl, q_pos, kv_pos = args
        rows = [fn(q[r:r + 1].contiguous(), kp, vp, tbl[r:r + 1].contiguous(),
                   q_pos[r:r + 1].contiguous(), kv_pos[r:r + 1].contiguous())
                for r in range(4)]
    else:
        rows = [fn(*(t[r:r + 1].contiguous() for t in args)) for r in range(4)]
    for r, row in enumerate(rows):
        assert torch.equal(row, full[r:r + 1]), f"row {r}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kq,se,hd", [(1, 24, 16), (8, 24, 16), (8, 64, 64)])
def test_cross_attention_call_matches_plain(cuda, kq, se, hd, dtype):
    """verify_attention as the decoder's cross attention calls it: every
    query at position 0, source keys at 0, a masked tail at -1."""
    gen = torch.Generator().manual_seed(kq + se)
    b, h = 3, 8
    q = _randn(gen, (b, kq, h, hd), dtype, cuda)
    k = _randn(gen, (b, se, h, hd), dtype, cuda)
    v = _randn(gen, (b, se, h, hd), dtype, cuda)
    q_pos = torch.zeros((b, kq), dtype=torch.int32, device=cuda)
    kv_pos = torch.zeros((b, se), dtype=torch.int32)
    kv_pos[1, se - 5:] = -1
    kv_pos = kv_pos.to(cuda)
    got = verify_attention_cuda(q, k, v, q_pos, kv_pos)
    _assert_matches_plain(got, ref.verify_attention(q, k, v, q_pos, kv_pos),
                          dtype)
    short = verify_attention_cuda(q[1:2].contiguous(), k[1:2, :se - 5].contiguous(),
                                  v[1:2, :se - 5].contiguous(), q_pos[1:2].contiguous(),
                                  kv_pos[1:2, :se - 5].contiguous())
    torch.testing.assert_close(got[1:2].float(), short.float(), **TOL[dtype])


def test_seq2seq_decode_on_the_card(cuda):
    """A small encoder-decoder at head_dim 16 decoded on the card: BPD under
    exact, input_copy and topk_tree emits greedy's tokens, and each forward
    ran self and cross attention through the kernels in every layer."""
    from repro_torch.models import seq2seq

    cfg = ModelConfig(name="t", family="seq2seq", is_encoder_decoder=True,
                      num_encoder_layers=1, num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=48,
                      bpd_k=8, dtype="float32")
    params = seq2seq.init(cfg, seed=0, device=cuda)
    src = torch.randint(1, 48, (4, 24), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(5)).to(cuda)
    dec = DecodeConfig(max_new_tokens=24, block_k=8)
    gt, _ = decode.greedy_decode_seq2seq(params, cfg, dec, {"src": src})
    for policy in ("exact", "input_copy", "topk_tree"):
        _build.reset_launches()
        bt, bs = decode.bpd_decode_seq2seq(params, cfg,
                                           dec.replace(policy=policy),
                                           {"src": src})
        layers, iters = cfg.num_layers, bs["iterations"]
        if policy == "topk_tree":
            assert _build.LAUNCHES["tree_verify_attention"] == layers * iters
            assert _build.LAUNCHES["verify_attention"] == layers * iters
        else:
            assert _build.LAUNCHES["verify_attention"] == 2 * layers * iters
        assert _build.LAUNCHES["fused_verify"] == iters
        assert torch.equal(bt[:, :24], gt[:, :24]), policy
