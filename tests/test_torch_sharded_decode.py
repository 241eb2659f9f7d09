"""The sharded decode path on ("data", "model") meshes of CPU ranks
against the reference's single-device decode, in fp32 on bridged weights
(``conftest.tiny_dense`` and granite-3-8b's smoke config), as
``tests/test_sharded.py`` holds the reference's own mesh.

The ranks (gloo processes, ``launch.mesh.spawn``) are spawned once for the
whole module, on a (2, 2) mesh of 4 ranks that also makes (1, 2), (2, 1)
and (1, 4) meshes over its first ranks (``_torch_mesh_ranks.run``); the
reference decodes in this process meanwhile.  At (1, 4) granite's smoke
config has 2 KV heads under 8 query heads: each rank keeps the one KV head
its 2 query heads read, unsharded.

  * forward logits within 1e-5 of the reference's ``forward_hidden`` +
    ``base_logits``;
  * ``bpd_decode`` (exact on the dense and the paged cache, topk k 2,
    distance eps 2, adaptive, topk_tree dense, per-row budgets) and
    ``greedy_decode``: tokens, ``generated``, ``text_len`` and
    ``iterations`` equal to the reference's, on every rank;
  * ``head_topk``'s merged ids equal to a whole-vocab launch's, and at an
    exact tie planted across two shards;
  * ``comm.row_sum`` in bf16 rounds once: within half a bf16 ulp (plus the
    fp32 sum's slack) of the exact product, as one device's product is;
  * a rank that raises, or outlives the time limit, fails the spawn (with
    the rank's traceback) and leaves no rank running.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from conftest import tiny_dense  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

B, PROMPT = 4, 6
SPAWN_TIMEOUT = 400.0
CONFIGS = {"tiny_dense": lambda: tiny_dense(),
           "granite_smoke": lambda: jget_config(
               "granite-3-8b", smoke=True).replace(dtype="float32")}


def _reference(jcfg, jp, prompts):
    """The reference's single-device results of every case."""
    batch = {"tokens": jnp.asarray(prompts)}
    h = jmodel.embed_inputs(jp, jcfg, batch)
    hidden = jmodel.forward_hidden(jp, jcfg, h)[0]
    out = {"forward": np.asarray(jmodel.base_logits(jp, jcfg, hidden))}
    for case in ranks.CASES:
        rows = (jnp.asarray(ranks.BUDGETS, jnp.int32) if case == "budgets"
                else None)
        toks, st = jdecode.bpd_decode(jp, jcfg, JDecodeConfig(**ranks.dec(case)),
                                      batch, max_new_rows=rows)
        out[case] = (np.asarray(toks), np.asarray(st["generated"]),
                     np.asarray(st["text_len"]), int(st["iterations"]))
    toks, st = jdecode.greedy_decode(jp, jcfg, JDecodeConfig(**ranks.dec("")),
                                     batch)
    out["greedy"] = (np.asarray(toks), np.asarray(st["generated"]),
                     np.asarray(st["text_len"]), int(st["iterations"]))
    return out


@pytest.fixture(scope="module")
def runs():
    """(reference results {config: {case: ...}} and the row_sum inputs,
    per-rank sharded results [{mesh: {(config, case): ...}}])."""
    rng = np.random.default_rng(4)
    payload = {"configs": {}, "hidden": {}, "o": {}}
    jcfgs, jparams = {}, {}
    for name, make in CONFIGS.items():
        jcfg = make()
        jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
        jcfgs[name], jparams[name] = jcfg, jp
        payload["configs"][name] = (dataclasses.asdict(jcfg),
                                    jax.tree_util.tree_map(np.asarray, jp))
        payload["hidden"][name] = rng.normal(size=(B, jcfg.d_model)).astype(
            np.float32)
        payload["o"][name] = rng.integers(1, 3, (5, jcfg.d_model)).astype(
            np.float32)
    payload["prompts"] = rng.integers(0, 97, (B, PROMPT)).astype(np.int32)
    payload["row_sum"] = {      # bf16-representable x, w: (N, n), (n, d)
        form: tuple(np.asarray(torch.as_tensor(rng.normal(size=s).astype(
            np.float32)).bfloat16().float()) for s in shapes)
        for form, shapes in ROW_SUM_SHAPES.items()}

    sharded = {}

    def run_ranks():
        try:
            sharded["ranks"] = spawn(ranks.run, 2, 2, args=(payload,),
                                     device="cpu", timeout=SPAWN_TIMEOUT)
        except BaseException as exc:            # raised in the test thread
            sharded["error"] = exc

    worker = threading.Thread(target=run_ranks, name="mesh-ranks")
    worker.start()
    try:
        ref = {name: _reference(jcfgs[name], jparams[name], payload["prompts"])
               for name in CONFIGS}
    finally:
        worker.join(timeout=SPAWN_TIMEOUT + 30)
    assert not worker.is_alive(), "the spawned ranks outlived their time limit"
    if "error" in sharded:
        raise sharded["error"]
    ref["row_sum"] = payload["row_sum"]
    return ref, sharded["ranks"]


def _rank_results(runs, mesh):
    """The results of every rank of ``mesh``, rank 0 first."""
    _, per_rank = runs
    return [r[mesh] for r in per_rank if mesh in r]


def _rows(toks, text_len):
    return [toks[r, :text_len[r]].tolist() for r in range(len(text_len))]


MESH_IDS = [f"{d}x{m}" for d, m in ranks.MESHES]
ROW_SUM_SHAPES = {"2d": ((16, 128), (128, 64)),
                  "batched": ((3, 16, 128), (3, 128, 64))}
DECODES = list(ranks.CASES) + ["greedy"]


@pytest.mark.parametrize("mesh", ranks.MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_reference(runs, name, mesh):
    ref, _ = runs
    for res in _rank_results(runs, mesh):
        np.testing.assert_allclose(res[(name, "forward")], ref[name]["forward"],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("mesh", ranks.MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", DECODES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_reference(runs, name, case, mesh):
    ref, _ = runs
    jt, jg, jl, ji = ref[name][case]
    results = _rank_results(runs, mesh)
    assert len(results) == mesh[0] * mesh[1]
    for tt, tg, tl, ti in (res[(name, case)] for res in results):
        assert _rows(tt, tl) == _rows(jt, jl)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)
        assert ti == ji
    if case == "budgets":
        np.testing.assert_array_equal(jg, ranks.BUDGETS)


@pytest.mark.parametrize("mesh", ranks.MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_head_topk_merge_matches_a_whole_vocab_launch(runs, name, mesh):
    vocab = CONFIGS[name]().vocab_size
    for res in _rank_results(runs, mesh):
        merged, whole = res[(name, "head_topk")]
        np.testing.assert_array_equal(merged, whole)
        merged, whole = res[(name, "planted_tie")]
        np.testing.assert_array_equal(merged, whole)
        # the tie of lanes 3 and vocab - 2 goes to the lower id
        assert (merged[:, :2] == [3, vocab - 2]).all()


@pytest.mark.parametrize("mesh", ranks.MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("form", list(ROW_SUM_SHAPES))
def test_bf16_row_sum_rounds_once(runs, form, mesh):
    """Each rank's partial product stays in fp32 through the sum, so the
    bf16 result is the exact product rounded once: within half a bf16 ulp
    of it, give or take the fp32 sum's error.  Partials rounded to bf16
    before the sum miss this at model 2 and 4."""
    x, w = (v.astype(np.float64) for v in runs[0]["row_sum"][form])
    exact = x @ w
    half_ulp = 2.0 ** (np.floor(np.log2(np.abs(exact))) - 8)
    slack = 1e-5 * (np.abs(x) @ np.abs(w))
    for res in _rank_results(runs, mesh):
        y = res[("row_sum", form)].astype(np.float64)
        assert y.shape == exact.shape
        assert (np.abs(y - exact) <= half_ulp + slack).all()


def test_a_failing_rank_fails_the_spawn_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        spawn(ranks.fail_or_hang, 1, 2, args=("raise",), device="cpu",
              timeout=120)
    assert "rank 1 was told to fail" in str(err.value)


def test_a_rank_past_the_time_limit_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 6s"):
        spawn(ranks.fail_or_hang, 1, 2, args=("hang",), device="cpu",
              timeout=6)
    assert time.monotonic() - t0 < 30
