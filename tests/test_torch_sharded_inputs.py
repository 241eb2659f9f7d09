"""The encoder-decoder, llava's patch prefix and the input_copy, locality
and draft_model policies on ("data", "model") meshes of CPU ranks against
the reference's single-device decodes and engines, in fp32 on bridged
reference weights:

  * paper-mt-base's smoke config (2 + 2 layers, 4 heads of 32, BPD heads
    that copy p_1) under greedy, exact, topk, topk_tree and input_copy:
    both stacks' heads and the cross attention over ``model``, the sources
    over the batch axes;
  * llava-next-34b's smoke config (8 / 2 heads, 16 stub patches) under
    exact on the dense and the paged cache, and under draft_model with a
    plain text draft behind the patch prefix;
  * granite-3-8b's smoke config under draft_model, a self-draft (the
    bundle is the primary's sharded tree) and a small draft (cut by the
    same rules, its cache at the draft's local KV heads);
  * the pinned locality fixture (``tests/data/locality``), its 8 fields
    decoded as one batch from their coarse prompts;

each at (1, 2), (2, 1), (2, 2) and (1, 4): tokens, ``generated``,
``text_len``, iterations, invocations and k̂ equal to the reference's on
every rank (locality's MAE and iterations per token too, and its tokens
equal to ``reference.json``'s row-alone decodes).  The engine: a
draft_model group beside an exact group (self and small drafts), unified
over (1, 2) and disaggregated over the pod mesh (2, 1, 2), and a locality
group beside an exact group over (1, 2) and (2, 1), and an input_copy
group beside an exact group over (1, 2), its requests carrying their own
``src``: every rank's finish records and counters equal the reference's
single-device engine's.

The ranks (gloo processes, ``launch.mesh.spawn``) are spawned once for the
module (``_torch_input_ranks.run``); the reference runs in this process
meanwhile.  Without a spawn: the bridged seq2seq and draft trees' blocks,
and ``seq2seq.init(mesh=)``'s, put back equal to the whole leaves.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_engine_ranks as engine_ranks  # noqa: E402
import _torch_input_ranks as ranks  # noqa: E402
from conftest import tiny_dense  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.core.bundle import ModelBundle as JModelBundle  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data.synthetic import OrdinalField  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import seq2seq as jseq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.sharding import policy as tshard  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

B = 4
SPAWN_TIMEOUT = 500.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCALITY = os.path.join(ROOT, "tests", "data", "locality")
STATIC = [m[1:] for m in ranks.STATIC_MESHES]
MESH_IDS = [f"{d}x{m}" for d, m in STATIC]


def _smoke(arch):
    return jget_config(arch, smoke=True).replace(dtype="float32")


def _copy_heads(jp):
    """``jp`` with the BPD heads' ``w2`` zeroed: heads that copy p_1, so
    blocks of more than one token are accepted where the model repeats."""
    heads = dict(jp["bpd_heads"], w2=jnp.zeros_like(jp["bpd_heads"]["w2"]))
    return dict(jp, bpd_heads=heads)


def _locality_model():
    with open(os.path.join(LOCALITY, "locality", "config.json")) as f:
        fields = json.load(f)
    fields["global_attn_layers"] = tuple(fields["global_attn_layers"])
    jcfg = JModelConfig(**fields)
    template = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jp = jckpt.restore(os.path.join(LOCALITY, "locality", "checkpoint"),
                       template)[0]
    return jcfg, jp


def _models():
    """{name: (reference config, reference params)} of the module."""
    mt = _smoke("paper-mt-base")
    llava = _smoke("llava-next-34b")
    granite = _smoke("granite-3-8b")
    small = tiny_dense(vocab_size=granite.vocab_size, bpd_enabled=False)
    text = tiny_dense(vocab_size=llava.vocab_size, bpd_enabled=False)
    return {
        "mt": (mt, _copy_heads(jseq.init(jax.random.PRNGKey(5), mt))),
        "llava": (llava, _copy_heads(jmodel.init(jax.random.PRNGKey(3),
                                                 llava))),
        "llava_draft": (text, jmodel.init(jax.random.PRNGKey(7), text)),
        "granite": (granite, _copy_heads(jmodel.init(jax.random.PRNGKey(1),
                                                     granite))),
        "granite_draft": (small, jmodel.init(jax.random.PRNGKey(9), small)),
        "locality": _locality_model(),
    }


# sources the smoke encoder-decoder of key 5 partly copies (its greedy
# output equals the source at 2 to 4 of the first 8 positions), so that
# input_copy's drafts are accepted in blocks of 2 and more: picked from 512
# sources drawn over the tokens its outputs repeat
MT_SRC = np.array([[3, 45, 7, 46, 20, 45, 45, 1], [3, 45, 3, 7, 45, 20, 30, 3],
                   [3, 7, 46, 20, 45, 7, 45, 52],
                   [20, 52, 46, 12, 46, 52, 52, 7]], np.int32)


def _batches(models):
    rng = np.random.default_rng(8)
    grids = np.load(os.path.join(LOCALITY, "grids.npy"))
    field = OrdinalField(levels=models["locality"][0].vocab_size,
                         height=grids.shape[1], width=grids.shape[2],
                         n_waves=2, stride=2, order="locality", bilinear=True)
    streams = field.serialize(grids)
    llava = jpipeline.stub_frontend_inputs(models["llava"][0],
                                           np.random.default_rng(4), B, 8)
    return ({"mt": {"src": MT_SRC},
             "llava": {k: np.asarray(v) for k, v in llava.items()},
             "granite": {"tokens": rng.integers(0, 97, (B, 6)).astype(
                 np.int32)},
             "locality": {"tokens": np.ascontiguousarray(
                 streams[:, :ranks.LOC_PROMPT]).astype(np.int32)}},
            streams, field, grids)


def _jbundles(models, name, case):
    draft = ranks.DRAFTS.get((name, case))
    if draft is None:
        return None
    return {"draft": JModelBundle(models[draft][1], models[draft][0])}


def _reference_static(models, batches, name, case):
    jcfg, jp = models[name]
    batch = {k: jnp.asarray(v) for k, v in batches[name].items()}
    dec = JDecodeConfig(**ranks.dec(name, case))
    if jcfg.is_encoder_decoder:
        toks, st = jdecode.bpd_decode_seq2seq(jp, jcfg, dec, batch)
    else:
        toks, st = jdecode.bpd_decode(jp, jcfg, dec, batch,
                                      bundles=_jbundles(models, name, case))
    return (np.asarray(toks), np.asarray(st["generated"]),
            np.asarray(st["text_len"]), int(st["iterations"]),
            int(st["invocations"]), float(st["mean_accepted"]))


def _copy_sources(models):
    """{engine case: {rid: src}} for the input_copy engine's requests: the
    prompt and the reference's greedy continuation of it, cut to
    ``SRC_CAP`` (one greedy decode a prompt length)."""
    jcfg, jp = models["granite"]
    out = {}
    for case, (name, _, groups, *_) in ranks.ENGINES.items():
        if "input_copy" not in groups:
            continue
        reqs = [r for r in ranks.workload(case) if r[4] == "input_copy"]
        srcs = {}
        for n in sorted({len(r[1]) for r in reqs}):
            rows = [r for r in reqs if len(r[1]) == n]
            prompts = np.stack([r[1] for r in rows])
            dec = JDecodeConfig(max_new_tokens=ranks.SRC_CAP - n, block_k=1)
            toks, _ = jdecode.greedy_decode(jp, jcfg, dec,
                                            {"tokens": jnp.asarray(prompts)})
            for r, row in zip(rows, np.asarray(toks)):
                srcs[r[0]] = row[:ranks.SRC_CAP].astype(np.int32)
        out[case] = srcs
    return out


def _reference_engine(models, case, streams, srcs):
    name, draft, groups, *_ = ranks.ENGINES[case]
    jcfg, jp = models[name]
    dec_kw, ecfg_kw = ranks.engine_configs(case)
    bundles = (None if draft is None else
               {"draft": JModelBundle(models[draft][1], models[draft][0])})
    engine = jserving.ContinuousBatchingEngine(
        jp, jcfg, JDecodeConfig(**dec_kw), jserving.EngineConfig(**ecfg_kw),
        bundles=bundles, policies=groups)
    done = engine_ranks.drive(jserving.Scheduler(engine),
                              ranks.workload(case, streams),
                              ranks.with_src(jserving.Request,
                                             srcs.get(case, {})))
    return ([engine_ranks.record(f) for f in done],
            {"steps": engine.num_steps, "admits": engine.num_admits,
             "prefill_batches": engine.num_prefill_batches,
             "host_syncs": engine.num_host_syncs})


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """(reference results, per-rank sharded results [{(mesh, config,
    case): ...}], the fixture's field, grids and streams)."""
    models = _models()
    batches, streams, field, grids = _batches(models)
    srcs = _copy_sources(models)
    payload = {"configs": {n: (dataclasses.asdict(c), _numpy(p))
                           for n, (c, p) in models.items()},
               "batches": batches, "streams": streams, "srcs": srcs}
    sharded = {}

    def run_ranks():
        try:
            sharded["ranks"] = spawn(ranks.run, 2, 2, args=(payload,),
                                     device="cpu", timeout=SPAWN_TIMEOUT)
        except BaseException as exc:            # raised in the test thread
            sharded["error"] = exc

    worker = threading.Thread(target=run_ranks, name="input-ranks")
    worker.start()
    try:
        ref = {(name, case): _reference_static(models, batches, name, case)
               for name, cases in ranks.STATIC.items() for case in cases}
        ref.update({case: _reference_engine(models, case, streams, srcs)
                    for case in ranks.ENGINES})
    finally:
        worker.join(timeout=SPAWN_TIMEOUT + 30)
    assert not worker.is_alive(), "the spawned ranks outlived their time limit"
    if "error" in sharded:
        raise sharded["error"]
    return ref, sharded["ranks"], (field, grids, streams)


def _results(runs, mesh, name, case):
    """The results of every rank of ``mesh`` (pod, data, model), rank 0
    first."""
    _, per_rank, _ = runs
    key = (tuple(mesh), name, case)
    got = [r[key] for r in per_rank if key in r]
    assert len(got) == int(np.prod(mesh))
    return got


def _rows(toks, ends, start=0):
    return [list(toks[r, start:ends[r]]) for r in range(len(ends))]


def _check_decode(runs, mesh, name, case):
    ref, _, _ = runs
    jt, jg, jl, ji, jinv, jk = ref[(name, case)]
    for got in _results(runs, (1,) + tuple(mesh), name, case):
        tt, tg, tl, ti, tinv, tk = got["decode"]
        tt, tg, tl = np.asarray(tt), np.asarray(tg), np.asarray(tl)
        assert _rows(tt, tl) == _rows(jt, jl)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)
        assert (ti, tinv) == (ji, jinv)
        assert tk == pytest.approx(jk, rel=1e-6)      # the reference's fp32
    return jg, ji


MT_CASES = list(ranks.STATIC["mt"])


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
@pytest.mark.parametrize("case", MT_CASES)
def test_seq2seq_decode_matches_reference(runs, case, mesh):
    """paper-mt-base's decode over the mesh equals the reference's
    single-device ``bpd_decode_seq2seq`` (greedy: at block size 1)."""
    _check_decode(runs, mesh, "mt", case)


def test_seq2seq_blocks_accept_more_than_one_token(runs):
    """The copy heads and input_copy's source drafts accept blocks longer
    than one token, so the sharded verify and rollback are exercised."""
    ref, _, _ = runs
    for case in ("exact", "topk", "topk_tree", "input_copy"):
        _, generated, _, iters, _, _ = ref[("mt", case)]
        assert iters < generated.max(), case


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
@pytest.mark.parametrize("case", list(ranks.STATIC["llava"]))
def test_llava_decode_matches_reference(runs, case, mesh):
    """llava's backbone behind 16 patches: each rank embeds its rows'
    patches, and the decodes equal the reference's."""
    _check_decode(runs, mesh, "llava", case)


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
@pytest.mark.parametrize("case", list(ranks.STATIC["granite"]))
def test_draft_model_decode_matches_reference(runs, case, mesh):
    """granite's smoke config drafted by itself and by a small draft: the
    decodes equal the reference's with the same bundle."""
    _check_decode(runs, mesh, "granite", case)


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
def test_locality_fixture_matches_reference(runs, mesh):
    """The fixture's 8 fields as one batch: the reference's batch decode
    (tokens, counts, iterations, k̂), each row's tokens those of
    ``reference.json``'s row-alone decode, and the MAE and iterations per
    token of the reference's batch."""
    ref, _, (field, grids, _) = runs
    generated, iters = _check_decode(runs, mesh, "locality", "locality")
    with open(os.path.join(LOCALITY, "reference.json")) as f:
        alone = json.load(f)["locality"]["rows"]
    n = grids.shape[1] * grids.shape[2]
    jt = ref[("locality", "locality")][0]
    assert [list(r[:n]) for r in jt] == [r["tokens"] for r in alone]
    for got in _results(runs, (1,) + tuple(mesh), "locality", "locality"):
        toks, gen, _, it, _, _ = got["decode"]
        mae = float(np.abs(field.to_grid(np.asarray(toks)[:, :n]).astype(int)
                           - grids.astype(int)).mean())
        want = float(np.abs(field.to_grid(jt[:, :n]).astype(int)
                            - grids.astype(int)).mean())
        assert mae == want
        assert it / int(np.sum(gen)) == iters / int(generated.sum())


@pytest.mark.parametrize("case", list(ranks.ENGINES))
def test_engine_matches_reference(runs, case):
    """Every rank's finish records (tokens, counts, invocations, policy,
    admit and finish times) and counters equal the reference's
    single-device engine's; the pod mesh hands its prefills over."""
    ref, _, _ = runs
    want_records, want_counters = ref[case]
    name, _, _, mesh, _, _ = ranks.ENGINES[case]
    got = _results(runs, mesh, name, case)
    for g in got:
        assert g["records"] == want_records
        for key, value in want_counters.items():
            assert g["counters"][key] == value, key
    assert len({r[4] for r in want_records}) == 2       # both groups served
    if mesh[0] > 1:
        assert all(g["handoff"][0] > 0 for g in got)


def test_engine_input_copy_drafts_from_each_request_src(runs):
    """The input_copy group's requests carry a ``src`` longer than their
    prompt: drafts copied from it are accepted in blocks, so the records
    the ranks match depend on the ``src`` that rank 0's plans carried."""
    ref, _, _ = runs
    records, _ = ref["input_copy (1, 2)"]
    copied = [r for r in records if r[4] == "input_copy"]
    assert copied and any(r[2] > r[3] for r in copied)


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
def test_each_rank_keeps_its_heads(runs, mesh):
    """A rank's caches hold its KV heads: the seq2seq decoder's and its
    cross K/V (of its rows), llava's, and a draft's under the draft's own
    config; a self-draft's bundle is the primary's sharded tree, a small
    draft's is cut for the mesh."""
    d, m = mesh
    for got in _results(runs, (1, d, m), "mt", "exact"):
        local = got["local"]
        assert local["kv_heads"] == 4 // m
        assert local["cross_kv"] == (B // d, 8, 4 // m, 32)
    for got in _results(runs, (1, d, m), "llava", "draft_model"):
        local = got["local"]
        assert local["kv_heads"] == (1 if m > 2 else 2 // m)
        assert local["draft_kv_heads"] == (1 if m > 2 else 2 // m)
        assert local["draft_sharded"] and not local["self_draft"]
    for got in _results(runs, (1, d, m), "granite", "draft_self"):
        assert got["local"]["self_draft"]
        assert got["local"]["draft_kv_heads"] == got["local"]["kv_heads"]


# ---------------------------------------------------------------------------
# blocks, without a spawn
# ---------------------------------------------------------------------------


def _put_back(trees, meshes, full):
    """Every leaf of ``full`` against the ranks' blocks concatenated along
    its spec's ``model`` dim."""
    specs = tshard.param_specs(full, meshes[0])
    blocks = [dict(flatten_with_names(t)) for t in trees]
    m = meshes[0].shape["model"]
    for name, leaf in flatten_with_names(full):
        s = specs[name]
        if "model" not in s:
            for b in blocks:
                assert torch.equal(b[name], leaf), name
            continue
        parts = [blocks[i][name] for i in range(m)]
        assert torch.equal(torch.cat(parts, s.index("model")), leaf), name


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("name", ["mt", "granite_draft"])
def test_bridged_blocks_put_back_equal_the_whole_leaves(name, mesh):
    """``bridge.from_jax_params(mesh=)`` of the seq2seq tree (both stacks,
    cross attention, ``src_embed``, ``enc_pos``) and of a draft, and
    ``seq2seq.init(mesh=)`` against its whole draw."""
    jcfg = (_smoke("paper-mt-base") if name == "mt" else
            tiny_dense(vocab_size=256, bpd_enabled=False))
    init = jseq.init if jcfg.is_encoder_decoder else jmodel.init
    np_params = _numpy(init(jax.random.PRNGKey(2), jcfg))
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    meshes = [Mesh(*mesh, index=i) for i in range(mesh[0] * mesh[1])]
    full = bridge.from_jax_params(np_params, tcfg, device="cpu")
    _put_back([bridge.from_jax_params(np_params, tcfg, device="cpu", mesh=m)
               for m in meshes], meshes, full)
    drawn = tmodel.init(tcfg, seed=4, device="cpu")
    _put_back([tmodel.init(tcfg, seed=4, device="cpu", mesh=m)
               for m in meshes], meshes, drawn)
