"""The port's page allocator (``repro_torch.serving.pages``) against the
reference's: every pin of tests/test_pages.py run on the port's copy, and
seeded random admit/release traffic (also through the ``tests/_hyp.py``
shim) that must give the same tables, write masks, exceptions and pool
state from both allocators.  numpy only, seconds."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.serving import pages as jpages  # noqa: E402
from repro.serving.types import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.config import DecodeConfig  # noqa: E402
from repro_torch.serving.pages import PageAllocator, PagePoolExhausted  # noqa: E402
from repro_torch.serving.types import EngineConfig  # noqa: E402

PS = 8  # page size for every case here


def _mk(num_pages=12, P=4, prefix_len=0):
    return PageAllocator(num_pages, PS, P, prefix_len=prefix_len)


def _prompt(rng, n):
    return rng.integers(1, 97, n)


# ---------------------------------------------------------------------------
# the pins of tests/test_pages.py, on the port's allocator
# ---------------------------------------------------------------------------


def test_trash_page_never_allocated():
    a = _mk()
    rng = np.random.default_rng(0)
    for slot in range(3):
        tbl, _ = a.plan_admit(slot, _prompt(rng, 5), 5, 8)
        assert 0 not in a.slot_pages[slot]
        n = a.pages_needed(5, 8)
        assert (tbl[:n] > 0).all() and (tbl[n:] == 0).all()
    a.check_invariants()


def test_release_returns_all_pages():
    a = _mk()
    rng = np.random.default_rng(1)
    for slot in range(3):
        a.plan_admit(slot, _prompt(rng, 6), 6, 10)
    assert a.available_pages() < a.num_pages - 1
    for slot in range(3):
        a.release(slot)
        a.check_invariants()
    assert a.live_pages() == 0
    assert a.available_pages() == a.num_pages - 1


def test_release_unknown_slot_is_noop():
    a = _mk()
    assert a.release(7) == 0
    a.check_invariants()


def test_double_admit_same_slot_rejected():
    a = _mk()
    a.plan_admit(0, _prompt(np.random.default_rng(2), 4), 4, 4)
    with pytest.raises(RuntimeError, match="already holds"):
        a.plan_admit(0, _prompt(np.random.default_rng(3), 4), 4, 4)


def test_cow_fork_shares_and_preserves_prefix_page():
    a = _mk()
    rng = np.random.default_rng(4)
    prompt = _prompt(rng, PS)
    t0, w0 = a.plan_admit(0, prompt, PS, 4)
    t1, w1 = a.plan_admit(1, prompt, PS, 4)
    assert t0[0] == t1[0]
    assert w0[0] and not w1[0]
    assert a.refcount[t0[0]] == 2
    assert a.cow_hits == 1
    t2, w2 = a.plan_admit(2, _prompt(rng, PS), PS, 4)
    assert t2[0] != t0[0] and w2[0]
    assert a.cow_hits == 1
    a.check_invariants()


def test_prefix_cache_survives_release_until_reclaimed():
    a = _mk(num_pages=4, P=2)
    rng = np.random.default_rng(5)
    prompt = _prompt(rng, PS)
    t0, _ = a.plan_admit(0, prompt, PS, 4)
    a.release(0)
    assert a.live_pages() == 0
    t1, w1 = a.plan_admit(1, prompt, PS, 4)
    assert t1[0] == t0[0] and not w1[0]
    a.release(1)
    a.plan_admit(2, _prompt(rng, 3), 3, PS)
    t3, w3 = a.plan_admit(3, _prompt(rng, 3), 3, 2)
    assert t3[0] == t0[0] and w3[0]
    assert not a.prefix_map
    a.check_invariants()


def test_exhaustion_rolls_back_and_raises():
    a = _mk(num_pages=4, P=3)
    rng = np.random.default_rng(6)
    a.plan_admit(0, _prompt(rng, 4), 4, 8)
    before = dict(a.refcount)
    with pytest.raises(PagePoolExhausted):
        a.plan_admit(1, _prompt(rng, 4), 4, 12)
    assert a.refcount == before
    assert 1 not in a.slot_pages
    a.check_invariants()
    a.release(0)
    a.plan_admit(1, _prompt(rng, 4), 4, 12)
    a.check_invariants()


def test_failed_plan_unregisters_its_prefix_cache():
    a = _mk(num_pages=5, P=4)
    rng = np.random.default_rng(8)
    a.plan_admit(0, _prompt(rng, 4), 4, 16)
    prompt = _prompt(rng, PS)
    with pytest.raises(PagePoolExhausted):
        a.plan_admit(1, prompt, PS, 8)
    assert not a.prefix_map and not a.page_key and not a.reclaimable
    a.check_invariants()
    a.release(0)
    tbl, wm = a.plan_admit(1, prompt, PS, 8)
    n = a.pages_needed(PS, 8)
    assert wm[:n].all()
    a.check_invariants()


def test_never_satisfiable_is_config_error_not_backpressure():
    a = _mk(num_pages=4, P=8)
    rng = np.random.default_rng(7)
    with pytest.raises(ValueError, match="page_pool_pages"):
        a.plan_admit(0, _prompt(rng, 8), 8, 32)
    with pytest.raises(ValueError, match="rows address only"):
        _mk(num_pages=64, P=2).plan_admit(0, _prompt(rng, 8), 8, 32)


def test_prefix_len_offsets_sharing():
    a = _mk(prefix_len=4)
    rng = np.random.default_rng(8)
    p1, p2 = _prompt(rng, 4), _prompt(rng, 4)
    t0, _ = a.plan_admit(0, p1, 4, 4)
    t1, _ = a.plan_admit(1, p1, 4, 4)
    t2, _ = a.plan_admit(2, p2, 4, 4)
    assert t0[0] == t1[0] != t2[0]
    a.check_invariants()


def test_engine_config_rejects_bad_page_geometry():
    dec = DecodeConfig(max_new_tokens=16, block_k=4, cache_backend="paged",
                       page_size=6)
    ecfg = EngineConfig(num_slots=2, max_prompt_len=8, max_new_cap=16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ecfg.validate(dec)
    dec = dec.replace(page_size=8)
    ecfg.validate(dec)
    tiny = EngineConfig(num_slots=2, max_prompt_len=8, max_new_cap=16,
                        page_pool_pages=3)
    with pytest.raises(ValueError, match="page_pool_pages to at least 4"):
        tiny.validate(dec)
    EngineConfig(num_slots=2, max_prompt_len=8, max_new_cap=16,
                 page_pool_pages=4).validate(dec)


@pytest.mark.parametrize("kw,match", [
    (dict(num_slots=0), "num_slots"), (dict(max_prompt_len=0), "max_prompt_len"),
    (dict(max_new_cap=0), "max_new_cap"), (dict(prefill_slots=-1), "prefill_slots"),
    (dict(handoff_cap=-1), "handoff_cap"), (dict(steps_per_sync=0), "steps_per_sync"),
    (dict(prefill_slots=4, handoff_cap=2), "handoff_cap=2"),
    (dict(max_new_cap=32), "max_new_tokens"),
])
def test_engine_config_errors_equal_reference(kw, match):
    """The port's EngineConfig refuses what the reference refuses, with the
    same message."""
    base = dict(num_slots=2, max_prompt_len=8, max_new_cap=16)
    errs = []
    for cls, dcls in ((JEngineConfig, JDecodeConfig),
                      (EngineConfig, DecodeConfig)):
        with pytest.raises(ValueError, match=match) as e:
            cls(**{**base, **kw}).validate(dcls(max_new_tokens=16))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_engine_config_refuses_a_mesh():
    """Under a mesh the slot count must shard over the batch axes
    (pod×data, falling back to data): the port refuses what the
    reference's validate refuses, with the same message."""
    from repro_torch.launch.mesh import Mesh

    for shape, slots in (((1, 2, 1), 3), ((2, 1, 1), 1), ((2, 2, 1), 1),
                         ((1, 2, 2), 4), ((2, 2, 1), 2), ((2, 1, 2), 4)):
        pod, data, model = shape
        mesh = Mesh(data, model, pod=pod)
        errs = []
        for cls in (EngineConfig, JEngineConfig):
            try:
                cls(num_slots=slots).validate(mesh=mesh)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], shape
        assert (errs[0] is None) == (slots % data == 0), (shape, slots)
        if errs[0] is not None:
            assert "divisible" in errs[0]


# ---------------------------------------------------------------------------
# differential traffic: the port's allocator == the reference's
# ---------------------------------------------------------------------------


def _state(a):
    return (sorted(a.free), dict(a.refcount), dict(a.prefix_map),
            list(a.reclaimable), {s: list(p) for s, p in a.slot_pages.items()})


def _differential(seed, num_pages, steps, P=4, prefix_len=0):
    """Random admit (shared prompts: CoW hits) / release / exhaustion /
    never-satisfiable traffic through both allocators; every outcome and
    the whole pool state must agree after every operation."""
    rng = np.random.default_rng(seed)
    ja = jpages.PageAllocator(num_pages, PS, P, prefix_len=prefix_len)
    ta = PageAllocator(num_pages, PS, P, prefix_len=prefix_len)
    prompts = [_prompt(rng, int(rng.integers(1, 3 * PS))) for _ in range(4)]
    live, next_slot, hits = [], 0, 0
    for _ in range(steps):
        if live and rng.random() < 0.4:
            slot = live.pop(int(rng.integers(len(live))))
            assert ja.release(slot) == ta.release(slot)
        else:
            pr = prompts[int(rng.integers(len(prompts)))]
            n = int(rng.integers(1, len(pr) + 1))
            mn = int(rng.integers(1, 2 * PS))
            outs = []
            for a in (ja, ta):
                try:
                    outs.append(a.plan_admit(next_slot, pr, n, mn, 2))
                except (PagePoolExhausted, jpages.PagePoolExhausted,
                        ValueError) as e:
                    outs.append((type(e).__name__, str(e)))
            if isinstance(outs[0][0], str):
                assert outs[0] == outs[1]
            else:
                for x, y in zip(*outs):
                    np.testing.assert_array_equal(x, y)
                hits += int((~outs[1][1][:ta.pages_needed(n, mn, 2)]).sum())
                live.append(next_slot)
                next_slot += 1
        assert _state(ja) == _state(ta)
        ta.check_invariants()
    assert ta.cow_hits == hits
    return hits


@pytest.mark.parametrize("seed", range(6))
def test_seeded_traffic_equals_reference(seed):
    _differential(seed, num_pages=4 + 3 * seed, steps=60,
                  prefix_len=seed % 3)


def test_seeded_traffic_reaches_cow_hits():
    assert sum(_differential(s, 24, 60) for s in range(4)) > 0


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), num_pages=st.integers(4, 24),
       steps=st.integers(5, 60), prefix_len=st.integers(0, 6))
def test_random_traffic_equals_reference(seed, num_pages, steps, prefix_len):
    _differential(seed, num_pages, steps, prefix_len=prefix_len)
