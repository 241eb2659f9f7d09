"""The serving engine's slot-lifecycle cache primitives against the
reference's (tests/test_cache_rows.py and the engine's paged admission):
``reset_rows``, ``scatter_row`` and ``scatter_row_paged`` on dense, paged
and RWKV-6 caches, with and without copy-on-write masks, and the
``KVCacheBackend`` surface (managed tables, ``row_init``).  The port writes
in place; the reference returns new caches; the results must be equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense, tiny_rwkv  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.blocks import block_cache_init as jblock_cache_init  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models.blocks import block_cache_init as tblock_cache_init  # noqa: E402

PS = 8


def _fill(tree, seed):
    """The same random values (as numpy) for every leaf of ``tree``."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return rng.integers(-1, 40, x.shape).astype(x.dtype)
        return rng.standard_normal(x.shape).astype(x.dtype)

    return jax.tree_util.tree_map(leaf, tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _assert_equal(jtree, ttree):
    jl, jdef = jax.tree_util.tree_flatten(jtree)
    tl, tdef = jax.tree_util.tree_flatten(ttree)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _cfgs(**kw):
    jcfg = tiny_dense(**kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _layer(family, batch, *, paged, pool=0):
    """One layer's cache of ``batch`` rows, random, as (jax, torch)."""
    jcfg = (tiny_rwkv if family == "rwkv6" else tiny_dense)()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jbe = jcache.PagedBackend(PS, num_pages=pool, managed=True) if paged else None
    tbe = tcache.PagedBackend(PS, num_pages=pool, managed=True) if paged else None
    jc = jblock_cache_init(jcfg, 0, batch, 40, 4, jnp.float32, backend=jbe)
    tc = tblock_cache_init(tcfg, 0, batch, 40, 4, torch.float32, backend=tbe)
    _assert_equal(jc, tc)                  # same structure and initial values
    vals = _fill(jc, seed=batch)
    return _jax(vals), _torch(vals)


@pytest.mark.parametrize("family,paged", [("dense", False), ("dense", True),
                                          ("rwkv6", False)])
def test_reset_rows_equals_reference(family, paged):
    jc, tc = _layer(family, 4, paged=paged, pool=9)
    mask = np.array([True, False, True, False])
    want = jcache.reset_rows(jc, jnp.asarray(mask))
    got = tcache.reset_rows(tc, torch.tensor(mask))
    _assert_equal(want, got)
    if paged:                              # evicted rows drop to the trash page
        assert (got["attn"]["tbl"][mask] == 0).all()


@pytest.mark.parametrize("family", ["dense", "rwkv6"])
def test_scatter_row_equals_reference(family):
    jc, tc = _layer(family, 4, paged=False)
    jrow, trow = _layer(family, 1, paged=False)
    want = jcache.scatter_row(jc, jrow, jnp.asarray(2, jnp.int32))
    got = tcache.scatter_row(tc, trow, 2)
    _assert_equal(want, got)


def test_scatter_row_batched_lanes_equal_one_by_one():
    """(n,) index tensors install n rows at once, as n single calls do."""
    _, tc = _layer("dense", 4, paged=False)
    _, trows = _layer("dense", 3, paged=False)
    one = jax.tree_util.tree_map(lambda x: x.clone(), tc)
    for row, slot in ((2, 0), (0, 3)):
        tcache.scatter_row(one, trows, slot, row=row)
    tcache.scatter_row(tc, trows, torch.tensor([0, 3]), row=torch.tensor([2, 0]))
    _assert_equal(jax.tree_util.tree_map(lambda x: x.numpy(), one), tc)


def _paged_row_pair(n):
    """Layer 0 of dense row workspaces sized for paged admission (P * ps
    keys), random, as (jax, torch)."""
    jcfg, tcfg = _cfgs()
    jrows = jcache.PagedBackend(PS).row_init(jcfg, 40, 4, batch=n)[0]
    trows = tcache.PagedBackend(PS).row_init(tcfg, 40, 4, batch=n)[0]
    _assert_equal(jrows, trows)
    vals = _fill(jrows, seed=100 + n)
    return _jax(vals), _torch(vals)


def _assert_paged_equal(want, got):
    """Equal caches, except the trash page 0, which takes every redirected
    write in an unspecified order."""
    for name in ("tbl", "pos"):
        np.testing.assert_array_equal(np.asarray(want["attn"][name]),
                                      np.asarray(got["attn"][name]))
    for name in ("kp", "vp"):
        np.testing.assert_array_equal(np.asarray(want["attn"][name])[1:],
                                      np.asarray(got["attn"][name])[1:])


@pytest.mark.parametrize("cow", [False, True])
def test_scatter_row_paged_equals_reference(cow):
    """A paged admission through the allocator's mapping: pages with
    ``write_mask`` False (CoW prefix hits, unmapped tail) keep their bytes;
    only the trash page 0 takes the redirected writes."""
    jc, tc = _layer("dense", 3, paged=True, pool=20)
    jrow, trow = _paged_row_pair(1)
    n_pages = tc["attn"]["tbl"].shape[1]
    tbl = np.zeros((n_pages,), np.int32)
    tbl[:4] = [5, 9, 2, 17]
    mask = tbl > 0
    if cow:
        mask[:2] = False                   # two shared prefix pages
    want = jcache.scatter_row_paged(jc, jrow, jnp.asarray(1, jnp.int32),
                                    jnp.asarray(tbl), jnp.asarray(mask))
    before = tc["attn"]["kp"].clone()
    got = tcache.scatter_row_paged(tc, trow, 1, torch.tensor(tbl),
                                   torch.tensor(mask))
    _assert_paged_equal(want, {"attn": {k: v.numpy()
                                        for k, v in got["attn"].items()}})
    untouched = [p for p in range(1, 20) if p not in tbl[mask]]
    torch.testing.assert_close(got["attn"]["kp"][untouched],
                               before[untouched], rtol=0, atol=0)


def test_scatter_row_paged_batched_lanes_equal_one_by_one():
    _, tc = _layer("dense", 3, paged=True, pool=20)
    _, trows = _paged_row_pair(2)
    n_pages = tc["attn"]["tbl"].shape[1]
    tbls = np.zeros((2, n_pages), np.int32)
    tbls[0, :3], tbls[1, :3] = [4, 6, 8], [4, 11, 12]
    masks = tbls > 0
    masks[1, 0] = False                    # lane 1 shares lane 0's page 4
    one = jax.tree_util.tree_map(lambda x: x.clone(), tc)
    for lane, slot in ((0, 2), (1, 0)):
        tcache.scatter_row_paged(one, trows, slot, torch.tensor(tbls[lane]),
                                 torch.tensor(masks[lane]), row=lane)
    tcache.scatter_row_paged(tc, trows, torch.tensor([2, 0]),
                             torch.tensor(tbls), torch.tensor(masks),
                             row=torch.tensor([0, 1]))
    _assert_paged_equal(one, tc)


def test_managed_backend_and_row_init_equal_reference():
    """``get_backend(dec, num_pages=, managed=True)``: the engine's slot
    slab starts with every table at the trash page 0; ``row_init`` gives
    the page-aligned dense workspace; ``reset_rows`` / ``scatter_or_alloc``
    are the model-level twins."""
    jcfg, tcfg = _cfgs()
    jdec = JDecodeConfig(cache_backend="paged", page_size=PS)
    tdec = DecodeConfig(cache_backend="paged", page_size=PS)
    jbe = jcache.get_backend(jdec, num_pages=13, managed=True)
    tbe = tcache.get_backend(tdec, num_pages=13, managed=True)
    assert tbe.managed and tbe.num_pages == 13
    jc = jbe.init(jcfg, 3, 40, 4)
    tc = tbe.init(tcfg, 3, 40, 4)
    _assert_equal(jc, tc)
    assert all((c["attn"]["tbl"] == 0).all() for c in tc)
    _assert_equal(jbe.row_init(jcfg, 40, 4, batch=2),
                  tbe.row_init(tcfg, 40, 4, batch=2))
    assert isinstance(tcache.get_backend(DecodeConfig()), tcache.DenseBackend)
    # model-level twins, through the backend surface
    vals = _fill(jc, seed=7)
    jc, tc = _jax(vals), _torch(vals)
    rows = _fill(jbe.row_init(jcfg, 40, 4), seed=8)
    tbl = np.array([3, 4, 0, 0, 0, 0], np.int32)[:tc[0]["attn"]["tbl"].shape[1]]
    mask = tbl > 0
    want = jbe.scatter_or_alloc(jc, _jax(rows), jnp.asarray(2, jnp.int32),
                                tbl_row=jnp.asarray(tbl),
                                write_mask=jnp.asarray(mask))
    got = tbe.scatter_or_alloc(tc, _torch(rows), 2, tbl_row=torch.tensor(tbl),
                               write_mask=torch.tensor(mask))
    for w, g in zip(want, got):
        _assert_paged_equal(w, g)
    m = np.array([False, False, True])
    _assert_equal(jmodel.reset_cache_rows(want, jnp.asarray(m)),
                  tbe.reset_rows(got, torch.tensor(m)))
