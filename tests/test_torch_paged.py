"""The port's paged KV cache and tree-verification attention against the JAX
reference, in fp32 on the CPU (``conftest.tiny_dense`` geometry): the cache
layouts, the paged cache write for prefill and decode, chain and tree
``attn_cached`` on dense and paged caches, and ``tree_commit_attn``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.kernels.tree_mask import default_tree as jdefault_tree  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.kernels.tree_mask import default_tree  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
B, K, PS = 3, 4, 8


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _setup(window=0, meta=0, seed=4):
    jcfg = tiny_dense(sliding_window=window, num_meta_tokens=meta)
    p = jattn.attn_init(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), p, tp


def _backends(backend: str):
    if backend == "paged":
        return jcache.PagedBackend(PS), tcache.PagedBackend(PS)
    return jcache.DenseBackend(), tcache.DenseBackend()


def _check_cache(tc, jc):
    assert sorted(tc) == sorted(jc)
    for name in jc:
        want = np.asarray(jc[name])
        got = tc[name].numpy()
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def _prefilled(backend, jcfg, tcfg, jp, prompt, context=24, layer=0, k=K):
    """The same cache of one layer, prefilled with ``prompt`` positions, in
    both packages."""
    jbe, tbe = _backends(backend)
    jc = jbe.layer_attn_init(jcfg, layer, B, context, k, jnp.float32)
    tc = tbe.layer_attn_init(tcfg, layer, B, context, k, torch.float32)
    _check_cache(tc, jc)
    x = _x((B, prompt, 64), 5)
    pos = np.arange(prompt, dtype=np.int32)
    _, (kk, vv) = jattn.attn_full(jp, jcfg, jnp.asarray(x), layer_idx=layer,
                                  positions=jnp.asarray(pos), return_kv=True)
    jc = jattn.cache_write(jc, jcfg, layer, kk, vv, jnp.asarray(pos))
    tc = tattn.cache_write(tc, tcfg, layer, torch.tensor(np.asarray(kk)),
                           torch.tensor(np.asarray(vv)), torch.tensor(pos))
    _check_cache(tc, jc)
    return jc, tc


# ---------------------------------------------------------------------------
# layouts and the paged write
# ---------------------------------------------------------------------------


def jax_dec(backend):
    return JDecodeConfig(cache_backend=backend, page_size=PS)


def port_dec(backend):
    return DecodeConfig(cache_backend=backend, page_size=PS)


def test_paged_cache_init_matches_reference():
    jc = jcache.paged_attn_cache_init(2, 3, 8, 7, 2, 16, jnp.float32,
                                      identity_tbl=True)
    tc = tcache.paged_attn_cache_init(2, 3, 8, 7, 2, 16, torch.float32)
    _check_cache(tc, jc)
    assert tcache.pages_per_row(21, 4, 8) == jcache.pages_per_row(21, 4, 8) == 4


@pytest.mark.parametrize("window", [0, 16])
def test_backend_layouts_match_reference(window):
    """Full-attention layers get the identity-mapped pool of 1 + B·P pages;
    windowed layers stay dense rings under the paged backend."""
    jcfg, tcfg, _, _ = _setup(window=window)
    for name in ("dense", "paged"):
        jbe = jcache.get_backend(jax_dec(name))
        tbe = tcache.get_backend(port_dec(name))
        assert tbe.name == jbe.name == name
        for layer in range(jcfg.num_layers):
            jc = jbe.layer_attn_init(jcfg, layer, B, 30, K, jnp.float32)
            tc = tbe.layer_attn_init(tcfg, layer, B, 30, K, torch.float32)
            _check_cache(tc, jc)
            assert tcache.is_paged({"attn": tc}) == (name == "paged" and not window)
    with pytest.raises(ValueError, match="cache_backend"):
        tcache.get_backend(port_dec("sparse"))


def test_paged_cache_write_prefill_and_decode():
    """1-D prefill positions, then (B, S) per-row decode positions (rows at
    different lengths, one rolled back), land where the reference puts
    them: slot tbl[b, p // ps] * ps + p % ps, pos indexed by position."""
    jcfg, tcfg, jp, tp = _setup()
    jc, tc = _prefilled("paged", jcfg, tcfg, jp, prompt=11)
    for step, base in enumerate(([11, 9, 4], [15, 12, 6])):
        pos = np.asarray(base, np.int32)[:, None] + np.arange(K, dtype=np.int32)
        k, v = _x((B, K, 2, 16), 10 + step), _x((B, K, 2, 16), 20 + step)
        jc = jattn.cache_write(jc, jcfg, 0, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos))
        got = tattn.cache_write(tc, tcfg, 0, torch.tensor(k), torch.tensor(v),
                                torch.tensor(pos))
        assert got is tc                              # written in place
        _check_cache(tc, jc)
    kv = tattn.cache_kv_view(tc)
    for g, w in zip(kv, jattn.cache_kv_view(jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# attn_cached: chain and tree, dense and paged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_attn_cached_chain(backend):
    jcfg, tcfg, jp, tp = _setup()
    jc, tc = _prefilled(backend, jcfg, tcfg, jp, prompt=10)
    xb = _x((B, K, 64), 6)
    ln = np.asarray([10, 7, 9], np.int32)
    want, jc = jattn.attn_cached(jp, jcfg, jnp.asarray(xb), jc, jnp.asarray(ln))
    got, tc = tattn.attn_cached(tp, tcfg, torch.tensor(xb), tc, torch.tensor(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(tc, jc)


# (backend, window, meta, block k, fanout); k = 8 with fanout 2 has a
# chain of 6 below node 1, where a source slot of one depth is the
# destination of the next
TREE_CASES = [("dense", 0, 0, 4, 2), ("dense", 16, 4, 4, 2),
              ("paged", 0, 0, 4, 2), ("dense", 0, 0, 4, 3),
              ("paged", 0, 0, 8, 2), ("dense", 0, 0, 8, 2)]


def _tree_step(backend, window, meta, k, fanout, prompt=20):
    """Prefill, then one tree block on both sides; returns everything the
    tree tests compare."""
    jcfg, tcfg, jp, tp = _setup(window=window, meta=meta)
    jc, tc = _prefilled(backend, jcfg, tcfg, jp, prompt=prompt, k=k)
    xb = _x((B, k, 64), 7)
    ln = np.asarray([prompt, prompt - 3, prompt - 1], np.int32)
    want, jc = jattn.attn_cached(jp, jcfg, jnp.asarray(xb), jc, jnp.asarray(ln),
                                 tree=jdefault_tree(k, fanout))
    got, tc = tattn.attn_cached(tp, tcfg, torch.tensor(xb), tc, torch.tensor(ln),
                                tree=default_tree(k, fanout))
    return jcfg, tcfg, jc, tc, want, got, ln


@pytest.mark.parametrize("backend,window,meta,k,fanout", TREE_CASES)
def test_attn_cached_tree(backend, window, meta, k, fanout):
    """RoPE at length + depth, K/V written at length + n, each node sees
    its ancestors and the committed cache: the reference's overridden mask
    columns, here as logical kv_pos and node ids for the tree kernel."""
    _, _, jc, tc, want, got, _ = _tree_step(backend, window, meta, k, fanout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(tc, jc)


def test_tree_attention_differs_from_chain_attention():
    """The tree mask is really applied: sibling nodes do not see each other,
    so the outputs differ from a chain block's at the same inputs."""
    jcfg, tcfg, jp, tp = _setup()
    _, tc = _prefilled("dense", jcfg, tcfg, jp, prompt=12)
    _, tc2 = _prefilled("dense", jcfg, tcfg, jp, prompt=12)
    xb = torch.tensor(_x((B, K, 64), 8))
    ln = torch.tensor([12, 12, 12], dtype=torch.int32)
    tree, _ = tattn.attn_cached(tp, tcfg, xb, tc, ln, tree=default_tree(K, 2))
    chain, _ = tattn.attn_cached(tp, tcfg, xb, tc2, ln)
    torch.testing.assert_close(tree[:, :2], chain[:, :2], **TOL)  # root, node 1
    assert not torch.allclose(tree[:, 2:], chain[:, 2:], **TOL)


@pytest.mark.parametrize("backend,window,meta,k,fanout", TREE_CASES)
def test_tree_commit_attn(backend, window, meta, k, fanout):
    """Compact per-row paths into chain slots: row 0 takes node 2 (a
    sibling of node 1, k̂ = 2), row 1 the chain below node 1, row 2 is
    frozen (k̂ = 0, no writes)."""
    jcfg, tcfg, jc, tc, _, _, ln = _tree_step(backend, window, meta, k, fanout)
    topo = default_tree(k, fanout)
    deep = int(np.argmax(topo.depths))
    rows = [topo.path_matrix[2], topo.path_matrix[deep], topo.path_matrix[1]]
    path = np.full((B, k), -1, np.int32)
    for r, p in enumerate(rows):
        path[r, :len(p)] = p
    khat = np.asarray([2, topo.max_depth + 1, 0], np.int32)
    jc = jattn.tree_commit_attn(jc, jcfg, 0, jnp.asarray(path),
                                jnp.asarray(khat), jnp.asarray(ln), k)
    got = tattn.tree_commit_attn(tc, tcfg, 0, torch.tensor(path),
                                 torch.tensor(khat), torch.tensor(ln), k)
    assert got is tc                                  # written in place
    _check_cache(tc, jc)
