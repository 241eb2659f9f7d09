"""The port's sharding policy, process mesh and refusals against the
reference's, on the CPU in one process (no ranks are spawned here; the
sharded decodes are ``test_torch_sharded_decode.py``'s).

  * specs: ``param_specs``, ``cache_specs`` (dense and paged), ``state_specs``
    (BPD and greedy loop states) and ``batch_axes`` equal the reference's,
    leaf by leaf, for every registered config's smoke parameters at meshes
    (1, 1), (1, 2), (2, 2), (1, 4) and (2, 4): both read only a mesh's
    ``shape`` and ``axis_names``, so a stand-in object serves;
  * blocks: ``shard_params`` and ``model.init(mesh=)`` give every rank a
    block, and the blocks put back together along each spec's dims equal
    the single-device leaf exactly;
  * a (1, 1) mesh decodes as no mesh does, and the data pipeline takes a
    rank's rows;
  * refusals: a world that is not data × model, the engine and its serving
    functions under a mesh, the configs and policies the sharded path does
    not run, and the removed criterion-string API of ``core.verify``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import list_archs  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import seq2seq as jseq2seq  # noqa: E402
from repro.sharding import policy as jshard  # noqa: E402
from repro.utils.tree import path_str  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig, get_config  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import verify as tverify  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import seq2seq as tseq2seq  # noqa: E402
from repro_torch.sharding import policy as tshard  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

torch.set_num_threads(2)
MESHES = [(1, 1), (1, 2), (2, 2), (1, 4), (2, 4)]
ARCHS = list_archs()
B, CTX, K = 8, 40, 4


class StandIn:
    """What the spec functions of both packages read of a mesh."""

    axis_names = ("data", "model")

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _ref_specs(tree):
    """{'/'-path: spec tuple} of a reference pytree of PartitionSpecs."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {path_str(p): tuple(s) for p, s in leaves}


@functools.lru_cache(maxsize=None)
def _configs(arch):
    jcfg = jget_config(arch, smoke=True)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    jcfg, tcfg = _configs(arch)
    jinit = jseq2seq.init if jcfg.is_encoder_decoder else jmodel.init
    return (jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg)),
            tmodel.init(tcfg, device="meta"))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    jshapes, tparams = _param_shapes(arch)
    m = StandIn(*mesh)
    want = _ref_specs(jshard.param_specs(jshapes, m))
    got = tshard.param_specs(tparams, m)
    assert got == want
    if mesh[1] > 1 and arch == "granite-3-8b":
        assert got["blocks/0/attn/wq"] == (None, "model", None)


def _caches(arch, backend):
    """(reference cache shapes, port meta caches) of ``backend``."""
    jcfg, tcfg = _configs(arch)
    if jcfg.is_encoder_decoder:
        return (jax.eval_shape(lambda: jseq2seq.init_caches(jcfg, B, CTX, K)),
                tseq2seq.init_caches(tcfg, B, CTX, K, device="meta"))
    jdec = JDecodeConfig(cache_backend=backend)
    tdec = DecodeConfig(cache_backend=backend)
    return (jax.eval_shape(lambda: jmodel.init_caches(
                jcfg, B, CTX, K, backend=jcache.get_backend(jdec))),
            tmodel.init_caches(tcfg, B, CTX, K, device="meta",
                               backend=tcache.get_backend(tdec)))


def _states(jcaches, tcaches, policy_state):
    """Reference and port BPD / greedy loop states around the caches."""
    sds = jax.ShapeDtypeStruct
    i32 = np.int32

    def rows(*shape, dtype=i32):
        return sds((B,) + shape, dtype)

    def meta(*shape, dtype=torch.int32):
        return torch.empty((B,) + shape, dtype=dtype, device="meta")

    jps, tps = policy_state
    jb = jdecode.BPDState(tokens=rows(20), text_len=rows(), proposals=rows(K),
                          caches=jcaches, finished=rows(dtype=bool),
                          iters=sds((), i32), generated=rows(),
                          policy_state=jps)
    tb = tdecode.BPDState(tokens=meta(20), text_len=meta(), proposals=meta(K),
                          caches=tcaches, finished=meta(dtype=torch.bool),
                          iters=0, generated=meta(), policy_state=tps)
    jg = jdecode.GreedyState(tokens=rows(20), text_len=rows(), tok=rows(),
                             caches=jcaches, finished=rows(dtype=bool),
                             iters=sds((), i32), generated=rows())
    tg = tdecode.GreedyState(tokens=meta(20), text_len=meta(), tok=meta(),
                             caches=tcaches, finished=meta(dtype=torch.bool),
                             iters=0, generated=meta())
    return (jb, tb), (jg, tg)


DECODE_ARCHS = [a for a in ARCHS if not jget_config(a, smoke=True).is_encoder_only]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_cache_and_state_specs_equal_reference(arch, mesh):
    jcfg, tcfg = _configs(arch)
    m = StandIn(*mesh)
    backends = ("dense",) if jcfg.is_encoder_decoder else ("dense", "paged")
    # adaptive's per-row schedule state rides the loop state
    jps = jpolicy.PolicyState(drafter=(), schedule={
        "rate": jax.ShapeDtypeStruct((B,), np.float32),
        "cap": jax.ShapeDtypeStruct((B,), np.int32)})
    tps = tpolicy.PolicyState(drafter=(), schedule={
        "rate": torch.empty((B,), device="meta"),
        "cap": torch.empty((B,), dtype=torch.int32, device="meta")})
    for backend in backends:
        jc, tc = _caches(arch, backend)
        assert tshard.cache_specs(tcfg, tc, m, B) == _ref_specs(
            jshard.cache_specs(jcfg, jc, m, B))
        for jstate, tstate in _states(jc, tc, (jps, tps)):
            want = _ref_specs(jshard.state_specs(jcfg, jstate, m))
            assert tshard.state_specs(tcfg, tstate, m) == want


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_batch_axes_and_data_specs_equal_reference(mesh):
    m = StandIn(*mesh)
    for b in (1, 2, 3, 4, 6, 8):
        assert tshard.batch_axes(m, b) == jshard.batch_axes(m, b)
        assert tshard.data_spec(m, b, 3) == tuple(jshard.data_spec(m, b, 3))
    assert tshard.data_axis_size(m) == jshard.data_axis_size(m) == mesh[0]
    batch = {"tokens": torch.zeros((4, 6), dtype=torch.int32)}
    assert tshard.batch_specs(m, batch) == {
        "tokens": tuple(jshard.batch_specs(m, {"tokens": np.zeros((4, 6))})[
            "tokens"])}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _put_back(ranks, meshes, full):
    """Every leaf of ``full`` against the ranks' blocks concatenated along
    its spec's ``model`` dim (any data coordinate: parameters replicate
    over ``data``)."""
    specs = tshard.param_specs(full, meshes[0])
    blocks = [dict(flatten_with_names(r)) for r in ranks]
    for name, leaf in flatten_with_names(full):
        s = specs[name]
        if "model" not in s:
            for b in blocks:
                assert torch.equal(b[name], leaf), name
            continue
        dim = s.index("model")
        by_m = {}
        for mesh, b in zip(meshes, blocks):
            by_m.setdefault(mesh.coords["model"], []).append(b[name])
        for parts in zip(*(by_m[i] for i in sorted(by_m))):
            assert torch.equal(torch.cat(parts, dim=dim), leaf), name
        for mesh, r in zip(meshes, ranks):
            node = r
            *path, leaf_name = name.split("/")
            for key in path:
                node = node[int(key)] if key.isdigit() else node[key]
            assert node.shard_dims.get(leaf_name) == dim and node.mesh is mesh


CONFIGS = {"tiny_dense": lambda: tiny_dense(),
           "granite_smoke": lambda: get_config("granite-3-8b", smoke=True)}


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_blocks_put_back_equal_the_single_device_leaves(name, mesh):
    cfg = CONFIGS[name]()
    tcfg = cfg if isinstance(cfg, ModelConfig) else ModelConfig(
        **dataclasses.asdict(cfg))
    meshes = [Mesh(*mesh, index=i) for i in range(mesh[0] * mesh[1])]
    full = tmodel.init(tcfg, seed=5, device="cpu")
    _put_back([tshard.shard_params(full, m) for m in meshes], meshes, full)
    # init(mesh=) draws each leaf whole and keeps the rank's block
    _put_back([tmodel.init(tcfg, seed=5, device="cpu", mesh=m)
               for m in meshes], meshes, full)


def test_one_rank_mesh_decodes_as_no_mesh():
    cfg = ModelConfig(**dataclasses.asdict(tiny_dense()))
    params = tmodel.init(cfg, seed=2, device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.groups
    dec = DecodeConfig(max_new_tokens=8, block_k=4)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, 97, (3, 5)), dtype=torch.int32)}
    for run in (tdecode.bpd_decode, tdecode.greedy_decode):
        want, ws = run(params, cfg, dec, batch)
        got, gs = run(params, cfg, dec, batch, mesh=mesh)
        assert torch.equal(got, want) and gs["iterations"] == ws["iterations"]


def test_pipeline_takes_a_ranks_rows():
    batch = {"tokens": np.arange(12).reshape(4, 3)}
    out = tpipeline.to_device(batch, sharding=Mesh(2, 1, index=1, device="cpu"))
    assert out["tokens"].tolist() == batch["tokens"][2:].tolist()
    odd = {"tokens": np.arange(9).reshape(3, 3)}     # 3 rows: replicated
    out = tpipeline.to_device(odd, sharding=Mesh(2, 1, index=1, device="cpu"))
    assert out["tokens"].tolist() == odd["tokens"].tolist()
    got = list(tpipeline.prefetch(iter([batch, batch]), sharding=Mesh(
        2, 2, index=2, device="cpu")))
    assert [g["tokens"].tolist() for g in got] == [[[6, 7, 8], [9, 10, 11]]] * 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_a_world_that_is_not_data_times_model_is_refused():
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_mesh(1, 2, device="cpu")
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_mesh(2, 2, device="cpu")


def test_engine_and_serving_fns_refuse_a_mesh():
    """Under a mesh the serving functions build for every registered
    policy, and the engine takes auxiliary bundles (cut by the primary's
    rules) and any policy's group; what it refuses there it refuses on one
    device: a recurrent-state draft model."""
    from repro_torch.core.bundle import ModelBundle

    cfg = ModelConfig(**dataclasses.asdict(tiny_dense()))
    params = tmodel.init(cfg, seed=0, device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    dec = DecodeConfig(max_new_tokens=8, image_height=4, image_width=4)
    sess = tserving.DecodeSession(params, cfg, dec, mesh=mesh)
    ecfg = tserving.EngineConfig(num_slots=2, max_new_cap=8)
    assert sess.serving_fns(ecfg).local == slice(0, 2)
    for policy in ("topk_tree", "input_copy", "locality"):
        assert sess.serving_fns(ecfg, policy=policy).local == slice(0, 2)
    eng = tserving.ContinuousBatchingEngine(
        params, cfg, dec, ecfg, mesh=mesh, policies={"draft_model": 1,
                                                     "input_copy": 1},
        bundles={"draft": ModelBundle(params, cfg)})
    assert eng.session.aux_params["draft"] is eng.session.params
    rwkv = ModelConfig(**dataclasses.asdict(get_config(
        "rwkv6-1.6b", smoke=True).replace(dtype="float32")))
    for where in (None, mesh):
        with pytest.raises(NotImplementedError, match="attention caches"):
            tserving.ContinuousBatchingEngine(
                params, cfg, dec, ecfg, mesh=where,
                bundles={"draft": ModelBundle(tmodel.init(
                    rwkv, device="cpu"), rwkv)})


# arch -> the ROADMAP.md item its refusal under a mesh names, or None for
# a config the mesh now decodes
MESH_CONFIGS = {"paper-mt-base": None, "llava-next-34b": None,
                "hubert-xlarge": r"item 8d"}


@pytest.mark.parametrize("arch", list(MESH_CONFIGS))
def test_configs_the_mesh_does_not_run_are_refused(arch):
    """The encoder-only stack (its one path is training) is refused under
    a mesh, naming sharded training; the encoder-decoder and llava's
    backbone now build a sharded session and draw their blocks."""
    cfg = get_config(arch, smoke=True)
    params = tmodel.init(cfg, device="meta")
    item = MESH_CONFIGS[arch]
    if item is None:
        sess = tserving.DecodeSession(params, cfg, DecodeConfig(),
                                      mesh=make_mesh(1, 1, device="cpu"))
        assert sess.mesh is not None
        blocks = tmodel.init(cfg, device="meta", mesh=Mesh(1, 2))
        assert blocks["blocks"][0]["attn"]["wq"].shape[1] == cfg.num_heads // 2
        return
    with pytest.raises(NotImplementedError, match=item):
        tserving.DecodeSession(params, cfg, DecodeConfig(),
                               mesh=make_mesh(1, 1, device="cpu"))
    with pytest.raises(NotImplementedError, match=item):
        tmodel.init(cfg, device="meta", mesh=Mesh(1, 2))


@pytest.mark.parametrize("kw", [dict(policy="draft_model"),
                                dict(policy="input_copy"),
                                dict(policy="locality", image_height=4,
                                     image_width=4),
                                dict(policy="input_copy",
                                     cache_backend="paged")],
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_policies_the_mesh_does_not_run_are_refused(kw):
    """Every registered policy binds under a mesh as on one device:
    draft_model without its bundle is refused in the same words there,
    with one it binds and its cache holds the draft's local KV heads."""
    from repro_torch.core.bundle import ModelBundle

    cfg = ModelConfig(**dataclasses.asdict(tiny_dense()))
    params = tmodel.init(cfg, seed=0, device="cpu")
    dec = DecodeConfig(**kw)
    if kw["policy"] != "draft_model":
        sess = tserving.DecodeSession(params, cfg, dec,
                                      mesh=make_mesh(1, 1, device="cpu"))
        assert sess.policy.name == kw["policy"]
        return
    errors = []
    for mesh in (None, make_mesh(1, 1, device="cpu")):
        with pytest.raises(ValueError, match="runs a second model") as err:
            tserving.DecodeSession(params, cfg, dec, mesh=mesh)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    sess = tserving.DecodeSession(params, cfg, dec,
                                  mesh=make_mesh(1, 1, device="cpu"),
                                  bundles={"draft": ModelBundle(params, cfg)})
    assert sess.policy.drafter.cache_cfg.num_kv_heads == cfg.num_kv_heads


def test_heads_that_straddle_kv_heads_are_refused():
    # 6 query heads a rank over KV heads of 4 queries: a rank would read
    # parts of two KV heads (the reference length-shards that cache, the
    # port's item 8c(iii))
    cfg = ModelConfig(name="odd", num_layers=1, d_model=96, num_heads=12,
                      num_kv_heads=3, head_dim=8, d_ff=64, vocab_size=97,
                      dtype="float32")
    with pytest.raises(NotImplementedError, match=r"item 8c\(iii\)"):
        tmodel.init(cfg, device="meta", mesh=Mesh(1, 2))
    assert tshard.local_kv_heads(cfg, 1) == 3
    assert tshard.local_kv_heads(cfg, 3) == 1        # 4 heads share one
    assert tshard.local_kv_heads(cfg, 12) == 1
    assert tshard.local_kv_heads(cfg, 5) == 3         # heads replicated


def test_removed_criterion_api_names_the_policy_path():
    for fn in (tverify.position_accepts, tverify.accepted_block_size):
        with pytest.raises(ValueError, match="resolve_policy"):
            fn(None, None)


# ---------------------------------------------------------------------------
# the inputs' leaves: encoder, cross, patches, bundles, a draft's cache
# ---------------------------------------------------------------------------


def _draft_config(vocab):
    return dict(name="tiny-draft", num_layers=1, d_model=32, num_heads=2,
                num_kv_heads=2, d_ff=64, vocab_size=vocab, bpd_enabled=False,
                max_seq_len=512, dtype="float32")


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_encoder_cross_and_enc_pos_specs_equal_reference(mesh):
    """paper-mt-base's encoder blocks, cross attention, ``src_embed`` and
    ``enc_pos`` spec as the reference's, and at the full config too (8
    heads of 64 over ``model``)."""
    m = StandIn(*mesh)
    for smoke in (True, False):
        jcfg = jget_config("paper-mt-base", smoke=smoke)
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        want = _ref_specs(jshard.param_specs(jax.eval_shape(
            lambda: jseq2seq.init(jax.random.PRNGKey(0), jcfg)), m))
        got = tshard.param_specs(tmodel.init(tcfg, device="meta"), m)
        assert got == want
        ax = "model"                  # every head and vocab count divides
        assert got["enc_pos"] == (None, None)
        assert got["enc_blocks/0/attn/wq"] == (None, ax, None)
        assert got["blocks/0/cross/wo"] == (ax, None, None)
        assert got["src_embed/table"] == (ax, None)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_bundle_param_specs_equal_reference(mesh):
    """A session's auxiliary bundles (a self-draft and a small draft) spec
    leaf by leaf as the reference's ``bundle_param_shardings`` places them:
    the primary's path-rule table for every bundle."""
    from repro.core.bundle import ModelBundle as JModelBundle
    from repro.config import ModelConfig as JModelConfig
    from repro_torch.core.bundle import ModelBundle

    m = StandIn(*mesh)
    jcfg, tcfg = _configs("granite-3-8b")
    jshapes, tparams = _param_shapes("granite-3-8b")
    jd = JModelConfig(**_draft_config(jcfg.vocab_size))
    td = ModelConfig(**_draft_config(jcfg.vocab_size))
    jb = {"self": JModelBundle(jshapes, jcfg), "small": JModelBundle(
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jd)), jd)}
    tb = {"self": ModelBundle(tparams, tcfg),
          "small": ModelBundle(tmodel.init(td, device="meta"), td)}
    want = {n: _ref_specs(jshard.param_specs(b.params, m))
            for n, b in jb.items()}
    assert tshard.bundle_param_specs(tb, m) == want


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_patch_batch_specs_equal_reference(mesh):
    """llava's decode batch (tokens and patch embeddings) shards its rows
    over the data axes, as the reference's ``batch_specs``."""
    m = StandIn(*mesh)
    for b in (2, 4, 8):
        batch = {"tokens": np.zeros((b, 8), np.int32),
                 "patch_embeds": np.zeros((b, 16, 256), np.float32)}
        want = {k: tuple(v) for k, v in jshard.batch_specs(m, batch).items()}
        assert tshard.batch_specs(m, {k: torch.as_tensor(v) for k, v in
                                      batch.items()}) == want


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_draft_cache_state_specs_equal_reference(mesh):
    """A draft_model loop state: the draft's KV cache in the policy state
    specs under the draft's own config (``draft_cfg=``, or read off a
    bound policy), as the reference's ``state_specs``; a slot batch and a
    prefill packet carrying it too."""
    from repro.serving import types as jtypes
    from repro_torch.serving import types as ttypes

    m = StandIn(*mesh)
    jcfg, tcfg = _configs("granite-3-8b")
    jdc = jget_config("granite-3-8b", smoke=True).replace(
        name="draft", num_layers=1, num_heads=4, num_kv_heads=4,
        bpd_enabled=False)
    tdc = ModelConfig(**dataclasses.asdict(jdc))
    jc, tc = _caches("granite-3-8b", "dense")
    jdraft = jax.eval_shape(lambda: jmodel.init_caches(jdc, B, CTX, 1))
    tdraft = tmodel.init_caches(tdc, B, CTX, 1, device="meta")
    jps = jpolicy.PolicyState(drafter={"caches": jdraft}, schedule=())
    tps = tpolicy.PolicyState(drafter={"caches": tdraft}, schedule=())
    for jstate, tstate in _states(jc, tc, (jps, tps)):
        if not hasattr(jstate, "policy_state"):
            continue
        want = _ref_specs(jshard.state_specs(jcfg, jstate, m, draft_cfg=jdc))
        assert tshard.state_specs(tcfg, tstate, m, draft_cfg=tdc) == want
        assert any("policy_state/drafter/caches/0/attn/k" == k for k in want)
        pol = tpolicy.resolve_policy(DecodeConfig(), "draft_model")
        bound = dataclasses.replace(pol, drafter=dataclasses.replace(
            pol.drafter, cfg=tdc))
        assert tshard.state_specs(tcfg, tstate, m, policy=bound) == want

    def jsds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, np.dtype(dtype))

    def tsds(shape, dtype):
        return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")

    want = _ref_specs(jshard.slot_specs(
        jcfg, _slots(jc, jps, B, jtypes, jsds), m, draft_cfg=jdc))
    assert tshard.slot_specs(tcfg, _slots(tc, tps, B, ttypes, tsds), m,
                             draft_cfg=tdc) == want


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_cross_kv_specs_follow_the_kv_heads(mesh):
    """The encoder's cross K/V, which the reference leaves to GSPMD's
    propagation, spec as a self-attention cache of the rank's KV heads:
    rows over the data axes, KV heads over ``model`` where they divide."""
    m = StandIn(*mesh)
    tcfg = _configs("paper-mt-base")[1]
    kv = torch.empty((B, 12, tcfg.num_kv_heads, tcfg.resolved_head_dim),
                     device="meta")
    tree = [{"cross": {"k": kv, "v": kv}} for _ in range(tcfg.num_layers)]
    specs = tshard.cache_specs(tcfg, tree, m, B)
    ax = tshard.batch_axes(m, B)
    heads = "model" if tcfg.num_kv_heads % mesh[1] == 0 else None
    assert specs["0/cross/k"] == tshard.spec(ax, None, heads, None)
    assert specs == {f"{i}/cross/{n}": specs["0/cross/k"]
                     for i in range(tcfg.num_layers) for n in "kv"}


def test_encoder_only_is_refused_naming_8d():
    """hubert-xlarge's one path is training: a mesh refuses it before any
    work, naming sharded training (ROADMAP.md §1 item 8d)."""
    cfg = get_config("hubert-xlarge", smoke=True)
    with pytest.raises(NotImplementedError, match=r"item 8d"):
        tmodel.check_mesh_supported(cfg, Mesh(2, 1))


def test_straddling_heads_are_refused_naming_8c_iii():
    """Query heads a rank that straddle two KV heads need the
    length-sharded cache (ROADMAP.md §1 item 8c(iii)): the session, the
    draw and a draft bundle are each refused before any work."""
    from repro_torch.core.bundle import ModelBundle

    odd = ModelConfig(name="odd", num_layers=1, d_model=96, num_heads=12,
                      num_kv_heads=3, head_dim=8, d_ff=64, vocab_size=97,
                      bpd_enabled=False, dtype="float32")
    with pytest.raises(NotImplementedError, match=r"item 8c\(iii\)"):
        tshard.local_kv_heads(odd, 2)
    cfg = ModelConfig(**dataclasses.asdict(tiny_dense()))
    params = tmodel.init(cfg, seed=0, device="cpu")
    mesh = Mesh(1, 2, device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 8c\(iii\)"):
        tserving.DecodeSession(params, cfg, DecodeConfig(policy="draft_model"),
                               mesh=mesh, bundles={"draft": ModelBundle(
                                   tmodel.init(odd, device="cpu"), odd)})


# ---------------------------------------------------------------------------
# the pod axis: batch / prefill axes, slot and packet specs, owners
# ---------------------------------------------------------------------------

POD_MESHES = [(2, 1, 2), (2, 2, 1), (2, 2, 2), (4, 1, 1)]


class PodStandIn:
    """A ("pod", "data", "model") mesh as the spec functions read it."""

    axis_names = ("pod", "data", "model")

    def __init__(self, pod, data, model):
        self.shape = {"pod": pod, "data": data, "model": model}


@pytest.mark.parametrize("mesh", POD_MESHES, ids=str)
def test_pod_batch_and_prefill_axes_equal_reference(mesh):
    m = PodStandIn(*mesh)
    for b in (1, 2, 3, 4, 6, 8):
        assert tshard.batch_axes(m, b) == jshard.batch_axes(m, b)
        assert tshard.prefill_axes(m, b) == jshard.prefill_axes(m, b)
        assert tshard.data_spec(m, b, 3) == tuple(jshard.data_spec(m, b, 3))
    assert (tshard.data_axis_size(m) == jshard.data_axis_size(m)
            == mesh[0] * mesh[1])
    flat = StandIn(mesh[1], mesh[2])
    assert all(tshard.prefill_axes(flat, b) is None
               and jshard.prefill_axes(flat, b) is None for b in (1, 2, 4))


def _slots(caches, policy_state, s, mod, sds):
    """A SlotBatch of ``mod`` (the reference's or the port's serving.types)
    of ``s`` slots around ``caches``, its leaves made by ``sds(shape,
    dtype name)``."""
    return mod.SlotBatch(
        tokens=sds((s, 20), "int32"), text_len=sds((s,), "int32"),
        prompt_len=sds((s,), "int32"), proposals=sds((s, K), "int32"),
        caches=caches, active=sds((s,), "bool"), finished=sds((s,), "bool"),
        generated=sds((s,), "int32"), max_new=sds((s,), "int32"),
        invocations=sds((s,), "int32"), policy_state=policy_state,
        group=sds((s,), "int32"))


@pytest.mark.parametrize("mesh", POD_MESHES + [(1, 2, 2)], ids=str)
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_slot_and_packet_specs_equal_reference(mesh, backend):
    """A serving group's slot batch (8 slots) and a prefill packet (widths
    4 and 2) spec as the reference's ``slot_specs`` / ``packet_specs``:
    slots over pod×data (or data), packet rows over ``pod``."""
    from repro.serving import session as jsession
    from repro.serving import types as jtypes
    from repro_torch.serving import session as tsession
    from repro_torch.serving import types as ttypes

    arch = "granite-3-8b"
    jcfg, tcfg = _configs(arch)
    m = PodStandIn(*mesh) if mesh[0] > 1 else StandIn(*mesh[1:])
    jdec, tdec = JDecodeConfig(cache_backend=backend), DecodeConfig(
        cache_backend=backend)

    def jsds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, np.dtype(dtype))

    def tsds(shape, dtype):
        return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")

    for s in (8, 4, 2):
        jc = jax.eval_shape(lambda: jmodel.init_caches(
            jcfg, s, CTX, K, backend=jcache.get_backend(jdec)))
        tc = tmodel.init_caches(tcfg, s, CTX, K, device="meta",
                                backend=tcache.get_backend(tdec))
        jps = jpolicy.PolicyState(drafter=(), schedule={
            "rate": jsds((s,), "float32"), "cap": jsds((s,), "int32")})
        tps = tpolicy.PolicyState(drafter=(), schedule={
            "rate": tsds((s,), "float32"), "cap": tsds((s,), "int32")})
        want = _ref_specs(jshard.slot_specs(
            jcfg, _slots(jc, jps, s, jtypes, jsds), m))
        assert tshard.slot_specs(tcfg, _slots(tc, tps, s, ttypes, tsds),
                                 m) == want
        jpkt = jsession.PrefillPacket(
            tokens=jsds((s, 20), "int32"), prompt_len=jsds((s,), "int32"),
            proposals=jsds((s, K), "int32"), caches=jc, policy_state=jps)
        tpkt = tsession.PrefillPacket(
            tokens=tsds((s, 20), "int32"), prompt_len=tsds((s,), "int32"),
            proposals=tsds((s, K), "int32"), caches=tc, policy_state=tps)
        assert tshard.packet_specs(tcfg, tpkt, m) == _ref_specs(
            jshard.packet_specs(jcfg, jpkt, m))


@pytest.mark.parametrize("mesh", POD_MESHES + [(1, 2, 2), (1, 1, 2)],
                         ids=str)
def test_slot_owners_and_packet_pods_partition_the_rows(mesh):
    """Every rank computes the same owner of each slot and pod of each
    packet row: a rank's slots (``comm.data_rows``) are exactly those whose
    ``slot_owner`` is its shard, the shards cover the group, and a packet's
    rows split over the pods in equal runs, or are every rank's."""
    from repro_torch.sharding import comm

    p, d, m = mesh
    ranks = [Mesh(d, m, pod=p, index=i) for i in range(p * d * m)]
    for s in (2, 4, 8):
        if tshard.batch_axes(ranks[0], s) is None and d * p > 1:
            continue                  # EngineConfig.validate refuses it
        kept = set()
        for r in ranks:
            n, shard = tshard.batch_shard(r, s)
            rows = comm.data_rows(r, s)
            assert rows.stop - rows.start == s // n
            assert all(tshard.slot_owner(r, s, j) == shard
                       for j in range(rows.start, rows.stop))
            kept |= set(range(rows.start, rows.stop))
        assert kept == set(range(s))
    for w in (1, 2, 4, 8):
        pods = [tshard.packet_pod(ranks[-1], w, row) for row in range(w)]
        if tshard.prefill_axes(ranks[-1], w) is None:
            assert pods == [None] * w
        else:
            assert pods == sorted(pods) and all(
                pods.count(i) == w // p for i in range(p))
