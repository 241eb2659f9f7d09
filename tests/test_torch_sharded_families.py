"""The MoE, RWKV-6 and Hymba families on ("data", "model") meshes of CPU
ranks against the reference's single-device decode, in fp32 on bridged
reference weights of the smoke configs of olmoe-1b-7b, qwen2-moe-a2.7b,
rwkv6-1.6b and hymba-1.5b, plus qwen2-moe's smoke config with 6 experts
padded to 8 (so that at (1, 4) the last rank holds pad experts only, and
at (1, 2) two pads beside two real ones, as the full config's last rank
holds 4 pads).  Every config's BPD heads copy p_1 (``w2`` zeroed), and
the distance policy accepts their proposals within 48 ids: rows accept 1
to 4 tokens an iteration, so the recurrent families roll their per-step
states back at every k̂.

The ranks (gloo processes, ``launch.mesh.spawn``) are spawned once for the
module, on (1, 2), (2, 1), (2, 2), (1, 4) and the pod mesh (2, 1, 2)
(``_torch_family_ranks.run``); the reference runs in this process
meanwhile.

  * forward logits within 1e-5 of the reference's ``forward_hidden`` +
    ``base_logits`` and of the single-device port's (rwkv6, whose fp32
    logits carry noise of 2e-5 to 7e-5 on these weights, within 1e-4);
  * ``greedy_decode`` and ``bpd_decode`` (exact on the dense and the paged
    cache, topk k 2, distance 48, and for the MoE models topk_tree
    dense): tokens,
    ``generated``, ``text_len`` and ``iterations`` equal to the
    reference's, on every rank;
  * the MoE models' routed expert ids, every layer and token, equal to the
    reference's and to each other on every rank;
  * each rank's local heads, channels and experts;
  * olmoe through the sharded engine, unified over (1, 2) and
    disaggregated over (2, 1, 2) (experts split, prefills handed over
    ``pod``): finish records and counters equal to the reference's
    single-device engine's;

and without a spawn: Mamba's ``in_proj`` cut in each half, every family's
blocks put back equal to the whole leaves, and what stays out (llava,
paper-mt-base and hubert under a mesh; draft_model, input_copy and
locality under one; rwkv6 and hymba in the engine) still raising.
"""
import dataclasses
import functools
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_engine_ranks as engine_ranks  # noqa: E402
import _torch_family_ranks as ranks  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig, get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh, spawn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.sharding import policy as tshard  # noqa: E402

B, PROMPT = 4, 6
SPAWN_TIMEOUT = 400.0


def _smoke(arch, **kw):
    return lambda: jget_config(arch, smoke=True).replace(dtype="float32", **kw)


CONFIGS = {"olmoe": _smoke("olmoe-1b-7b"),
           "qwen2_moe": _smoke("qwen2-moe-a2.7b"),
           "qwen2_moe_padded": _smoke("qwen2-moe-a2.7b", num_experts=6,
                                      expert_pad_multiple=8),
           "rwkv6": _smoke("rwkv6-1.6b"),
           "hymba": _smoke("hymba-1.5b")}
STATIC = [m[1:] for m in ranks.STATIC_MESHES]
MESH_IDS = [f"{d}x{m}" for d, m in STATIC]


def _weights(jcfg):
    """The reference's weights from one key, with the BPD heads' ``w2``
    zeroed (heads that copy p_1)."""
    jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
    heads = dict(jp["bpd_heads"], w2=jnp.zeros_like(jp["bpd_heads"]["w2"]))
    return dict(jp, bpd_heads=heads)


def _reference_routes(jp, jcfg, h):
    """{layer: (B, S, K) expert ids} of the reference's full-capacity
    forward: its router logits, read inside its ``moe_apply``, top K by
    (probability desc, id asc) as ``lax.top_k`` orders them."""
    logits, real = {}, jblocks.moe_apply

    def moe_apply(p, cfg, x, *, full_capacity=False):
        layer = len(logits)
        logits[layer] = None
        lg = x.astype(jnp.float32) @ p["router"]["w"].astype(jnp.float32)
        jax.debug.callback(lambda v: logits.__setitem__(layer, np.asarray(v)),
                           lg)
        return real(p, cfg, x, full_capacity=full_capacity)

    jblocks.moe_apply = moe_apply
    try:
        out = jmodel.forward_hidden(jp, jcfg, h, moe_full_capacity=True)[0]
        jax.effects_barrier()
    finally:
        jblocks.moe_apply = real
    ids = {}
    for layer, lg in logits.items():
        probs = np.asarray(jax.nn.softmax(jnp.asarray(lg), -1))
        ids[layer] = np.argsort(-probs, axis=-1, kind="stable")[
            ..., :jcfg.num_experts_per_tok]
    return out, ids


def _reference(name, jcfg, jp, prompts):
    """The reference's single-device results of every case of ``name``."""
    batch = {"tokens": jnp.asarray(prompts)}
    h = jmodel.embed_inputs(jp, jcfg, batch)
    if name in ranks.MOE:
        hidden, routes = _reference_routes(jp, jcfg, h)
    else:
        hidden, routes = jmodel.forward_hidden(jp, jcfg, h)[0], None
    out = {"forward": np.asarray(jmodel.base_logits(jp, jcfg, hidden)),
           "routes": routes}
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    with torch.no_grad():
        th = tmodel.embed_inputs(tp, tcfg, {"tokens": torch.as_tensor(prompts)})
        out["port forward"] = tmodel.base_logits(tp, tcfg, tmodel.forward_hidden(
            tp, tcfg, th, moe_full_capacity=True)[0]).numpy()
    for case in ranks.cases(name):
        run = jdecode.greedy_decode if case == "greedy" else jdecode.bpd_decode
        toks, st = run(jp, jcfg, JDecodeConfig(**ranks.dec(
            "" if case == "greedy" else case)), batch)
        out[case] = (np.asarray(toks), np.asarray(st["generated"]),
                     np.asarray(st["text_len"]), int(st["iterations"]))
    return out


def _reference_engine(jp, jcfg, case):
    """The reference's single-device engine on ``case``'s configs:
    (records, counters)."""
    dec_kw, ecfg_kw = ranks.engine_configs(case)
    engine = jserving.ContinuousBatchingEngine(
        jp, jcfg, JDecodeConfig(**dec_kw), jserving.EngineConfig(**ecfg_kw),
        policies=engine_ranks.GROUPS)
    done = engine_ranks.drive(jserving.Scheduler(engine),
                              engine_ranks.workload(), jserving.Request)
    return ([engine_ranks.record(f) for f in done],
            {"steps": engine.num_steps, "admits": engine.num_admits,
             "prefill_batches": engine.num_prefill_batches,
             "host_syncs": engine.num_host_syncs})


@pytest.fixture(scope="module")
def runs():
    """(reference results {config: {case: ...}, "engine": {case: ...}},
    per-rank sharded results [{(mesh, config, case): ...}])."""
    rng = np.random.default_rng(4)
    payload = {"configs": {}}
    jcfgs, jparams = {}, {}
    for name, make in CONFIGS.items():
        jcfg = make()
        jp = _weights(jcfg)
        jcfgs[name], jparams[name] = jcfg, jp
        payload["configs"][name] = (dataclasses.asdict(jcfg),
                                    jax.tree_util.tree_map(np.asarray, jp))
    payload["prompts"] = rng.integers(0, 97, (B, PROMPT)).astype(np.int32)

    sharded = {}

    def run_ranks():
        try:
            sharded["ranks"] = spawn(ranks.run, 2, 2, args=(payload,),
                                     device="cpu", timeout=SPAWN_TIMEOUT)
        except BaseException as exc:            # raised in the test thread
            sharded["error"] = exc

    worker = threading.Thread(target=run_ranks, name="family-ranks")
    worker.start()
    try:
        ref = {name: _reference(name, jcfgs[name], jparams[name],
                                payload["prompts"]) for name in CONFIGS}
        ref["engine"] = {case: _reference_engine(jparams["olmoe"],
                                                 jcfgs["olmoe"], case)
                         for case in ranks.ENGINE_CASES}
    finally:
        worker.join(timeout=SPAWN_TIMEOUT + 30)
    assert not worker.is_alive(), "the spawned ranks outlived their time limit"
    if "error" in sharded:
        raise sharded["error"]
    return ref, sharded["ranks"]


def _results(runs, mesh, name, case):
    """The results of every rank of ``mesh`` (data, model), rank 0 first."""
    _, per_rank = runs
    key = ((1,) + tuple(mesh), name, case)
    got = [r[key] for r in per_rank if key in r]
    assert len(got) == mesh[0] * mesh[1]
    return got


def _rows(toks, text_len):
    return [toks[r, :text_len[r]].tolist() for r in range(len(text_len))]


# the reference's tolerance, 1e-5; rwkv6's logits carry fp32 noise of 2e-5
# on one device (the port's fp32 forward against its fp64 one), 6e-5 from
# the reference (its scan sums in another order) and up to 7e-5 between
# summation orders of the ranks' products, so rwkv6 is held within 1e-4
FORWARD_TOL = {"rwkv6": 1e-4}


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_reference(runs, name, mesh):
    ref, _ = runs
    tol = FORWARD_TOL.get(name, 1e-5)
    for got in _results(runs, mesh, name, "forward"):
        np.testing.assert_allclose(got, ref[name]["forward"], atol=tol, rtol=0)
        np.testing.assert_allclose(got, ref[name]["port forward"], atol=tol,
                                   rtol=0)


DECODES = [(name, case) for name in CONFIGS for case in ranks.cases(name)]


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
@pytest.mark.parametrize("name,case", DECODES,
                         ids=[f"{n}-{c}" for n, c in DECODES])
def test_decode_matches_reference(runs, name, case, mesh):
    ref, _ = runs
    jt, jg, jl, ji = ref[name][case]
    for tt, tg, tl, ti in _results(runs, mesh, name, case):
        assert _rows(tt, tl) == _rows(jt, jl)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)
        assert ti == ji


def test_blocks_accept_more_than_one_token(runs):
    """Under the distance policy every family's rows accept blocks of 1 to
    4 tokens: the decode takes fewer iterations than tokens, so the
    recurrent families' per-step states are rolled back to at k̂ between 1
    and k, and the sharded decodes above equal the reference's there."""
    ref, _ = runs
    for name in ranks.DECODED:
        _, generated, _, iters = ref[name]["distance"]
        assert (generated == ranks.MAX_NEW).all() and iters < ranks.MAX_NEW


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
@pytest.mark.parametrize("name", list(ranks.MOE))
def test_routed_experts_match_reference_on_every_rank(runs, name, mesh):
    ref, _ = runs
    want = ref[name]["routes"]
    assert sorted(want) == list(range(CONFIGS[name]().num_layers))
    for got in _results(runs, mesh, name, "routes"):
        assert sorted(got) == sorted(want)
        for layer in want:
            np.testing.assert_array_equal(got[layer], want[layer])


@pytest.mark.parametrize("mesh", STATIC, ids=MESH_IDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_keeps_its_heads_channels_and_experts(runs, name, mesh):
    cfg = CONFIGS[name]()
    m = mesh[1]
    results = _results(runs, mesh, name, "local")
    for i, (kv, wkv, channels, experts) in enumerate(results):
        if cfg.block_type == "rwkv6":
            assert (kv, wkv) == (0, cfg.d_model // cfg.rwkv_head_dim // m)
        else:                       # hymba's 5 heads stay whole
            assert kv == (cfg.num_kv_heads if cfg.num_heads % m
                          else cfg.num_kv_heads // m)
        if cfg.block_type == "hymba":
            assert channels == cfg.ssm_expand * cfg.d_model // m
        if name in ranks.MOE:
            per = cfg.padded_num_experts // m
            lo = (i % m) * per
            assert tuple(experts) == (lo, max(0, min(per, cfg.num_experts - lo)))
    if name == "qwen2_moe_padded" and m == 4:
        # the last rank holds pad experts 6 and 7 only: it computes none
        assert tuple(results[-1][3]) == (6, 0)


@pytest.mark.parametrize("case", list(ranks.ENGINE_CASES))
def test_engine_records_equal_the_reference_engine(runs, case):
    """olmoe's requests through the sharded engine, unified over (1, 2) and
    disaggregated over (2, 1, 2): every rank's finish records equal the
    reference's single-device engine's, and so do the iterations,
    admissions, host reads and prefill batches; on the pod mesh every
    prefill batch is handed over ``pod``."""
    ref, per_rank = runs
    want, counts = ref["engine"][case]
    mesh = ranks.ENGINE_CASES[case][0]
    key = (mesh, "olmoe", f"engine {case}")
    got = [r[key] for r in per_rank if key in r]
    assert len(got) == math.prod(mesh)
    assert len(want) == len(engine_ranks.workload())
    for res in got:
        assert res["records"] == want
        c = res["counters"]
        assert {k: c[k] for k in counts} == counts
        handoffs, nbytes = res["handoff"]
        if mesh[0] > 1:
            assert handoffs == c["prefill_batches"] > 0 and nbytes > 0
        else:
            assert handoffs == 0


# ---------------------------------------------------------------------------
# without a spawn
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hymba_weights():
    """The reference's hymba-1.5b smoke weights, as numpy."""
    return jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), _smoke("hymba-1.5b")()))


@pytest.mark.parametrize("m", [2, 4])
def test_mamba_in_proj_keeps_each_ranks_channels_of_both_halves(m):
    """Rank r's ``in_proj`` block is its channels [r·di/m, (r+1)·di/m) of u
    and the same channels of z, side by side, from ``model.init(mesh=)``
    and from the reference's weights through the bridge alike; the blocks
    put back by halves give the whole leaf."""
    jcfg = _smoke("hymba-1.5b")()
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    di = cfg.ssm_expand * cfg.d_model
    n = di // m
    np_params = _hymba_weights()
    for tree_of in (lambda mesh: tmodel.init(cfg, seed=1, device="cpu",
                                             mesh=mesh),
                    lambda mesh: bridge.from_jax_params(
                        np_params, cfg, device="cpu", mesh=mesh)):
        leaf = tree_of(None)["blocks"][1]["mamba"]["in_proj"]["w"]
        blocks = []
        for r in range(m):
            node = tree_of(Mesh(1, m, index=r))["blocks"][1]["mamba"][
                "in_proj"]
            assert node.shard_dims == {"w": 1}
            assert torch.equal(node["w"], torch.cat(
                [leaf[:, r * n:(r + 1) * n],
                 leaf[:, di + r * n:di + (r + 1) * n]], 1))
            blocks.append(node["w"])
        assert torch.equal(torch.cat([b[:, :n] for b in blocks]
                                     + [b[:, n:] for b in blocks], 1), leaf)


FAMILIES = ("olmoe-1b-7b", "qwen2-moe-a2.7b", "rwkv6-1.6b", "hymba-1.5b")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_blocks_put_back_equal_the_single_device_leaves(arch, mesh):
    """Every leaf's blocks over the ``model`` ranks, put back along the dim
    each rank's tree records (by halves for ``SPLIT_LEAVES``), equal the
    single-device draw's leaf; leaves no rule cuts are whole on every
    rank."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    full = tmodel.init(cfg, seed=5, device="cpu")
    m = mesh[1]
    trees = [tmodel.init(cfg, seed=5, device="cpu", mesh=Mesh(*mesh, index=i))
             for i in range(mesh[0] * m)]
    cut = {}
    for tree in trees:
        for mod_name, mod in tree.named_modules():
            for leaf, dim in getattr(mod, "shard_dims", {}).items():
                cut[f"{mod_name}.{leaf}".lstrip(".")] = dim
    assert cut, "nothing was cut"
    states = [t.state_dict() for t in trees]
    for key, whole in full.state_dict().items():
        if key not in cut:
            for s in states:
                assert torch.equal(s[key], whole), key
            continue
        dim = cut[key]
        for d in range(mesh[0]):
            parts = [states[d * m + i][key] for i in range(m)]
            halves = tshard._parts(key.replace(".", "/"))
            if halves > 1:
                parts = [p.chunk(halves, dim) for p in parts]
                parts = [p[h] for h in range(halves) for p in parts]
            assert torch.equal(torch.cat(parts, dim), whole), key


@pytest.mark.parametrize("arch", ["llava-next-34b", "paper-mt-base",
                                  "hubert-xlarge"])
def test_families_left_to_8c_ii_are_refused_under_a_mesh(arch):
    """Of the configs item 8c(ii) left, the encoder-decoder and llava's
    backbone now take a mesh (``test_torch_sharded_inputs.py`` decodes
    them); the encoder-only stack is refused, naming sharded training
    (item 8d)."""
    cfg = get_config(arch, smoke=True)
    params = tmodel.init(cfg, device="meta")
    if not cfg.is_encoder_only:
        tserving.DecodeSession(params, cfg, DecodeConfig(),
                               mesh=make_mesh(1, 1, device="cpu"))
        tmodel.init(cfg, device="meta", mesh=Mesh(1, 2))
        return
    with pytest.raises(NotImplementedError, match=r"item 8d"):
        tserving.DecodeSession(params, cfg, DecodeConfig(),
                               mesh=make_mesh(1, 1, device="cpu"))
    with pytest.raises(NotImplementedError, match=r"item 8d"):
        tmodel.init(cfg, device="meta", mesh=Mesh(1, 2))


@pytest.mark.parametrize("kw", [dict(policy="draft_model"),
                                dict(policy="input_copy"),
                                dict(policy="locality", image_height=4,
                                     image_width=4)],
                         ids=lambda kw: kw["policy"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-1.6b"])
def test_policies_left_to_8c_ii_are_refused_for_the_families(arch, kw):
    """The policies item 8c(ii) left bind for the families under a mesh as
    on one device: input_copy and locality build, draft_model without its
    bundle is refused in the words it is refused in there."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = tmodel.init(cfg, seed=0, device="cpu")
    dec = DecodeConfig(**kw)
    if kw["policy"] != "draft_model":
        tserving.DecodeSession(params, cfg, dec,
                               mesh=make_mesh(1, 1, device="cpu"))
        return
    errors = []
    for mesh in (None, make_mesh(1, 1, device="cpu")):
        with pytest.raises(ValueError, match="runs a second model") as err:
            tserving.DecodeSession(params, cfg, dec, mesh=mesh)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_families_are_refused_by_the_engine(arch):
    """The engine serves attention caches only, on a mesh as on one device;
    the launcher refuses before any rank starts."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = tmodel.init(cfg, seed=0, device="cpu")
    for mesh in (None, make_mesh(1, 1, device="cpu")):
        with pytest.raises(NotImplementedError, match="attention-cache"):
            tserving.ContinuousBatchingEngine(
                params, cfg, DecodeConfig(max_new_tokens=8),
                tserving.EngineConfig(num_slots=2, max_new_cap=8), mesh=mesh)
    with pytest.raises(NotImplementedError, match="attention-cache"):
        tserve.main(["--arch", arch, "--device", "cpu", "--engine",
                     "--mesh-model", "2", "--batch", "2", "--max-new", "2",
                     "--prompt-len", "4"])


def test_experts_that_do_not_divide_the_model_axis_are_refused():
    cfg = ModelConfig(**dataclasses.asdict(jget_config(
        "olmoe-1b-7b", smoke=True)))              # 4 experts
    with pytest.raises(ValueError, match="experts do not divide"):
        tmodel.init(cfg, device="meta", mesh=Mesh(1, 8))
