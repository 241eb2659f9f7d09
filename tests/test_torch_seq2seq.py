"""The port's encoder-decoder (the paper's MT setting) against the JAX
reference, in fp32 on the CPU.

- paper-mt-base's smoke config (2 + 2 layers, d 128, 4 heads of 32, vocab
  64, k 4) on weights made by ``repro.models.seq2seq.init`` and carried
  across by ``bridge``: the bridge, ``encode``, cross attention, the
  decoder forwards, and whole decodes under every ported policy;
- the trained policy-sweep fixture (``tests/data/policy_sweep``, written by
  ``tools/make_sweep_fixture.py``): the reference reproduces its own
  ``reference.json`` from the committed checkpoint, and so does the port.

Tolerance: rtol = atol = 2e-5 (``TOL``), as ``test_torch_model.py``: fp32
on both sides, sums in another order.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.kernels import tree_mask as jtree  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import seq2seq as jseq  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.kernels import block_attention, tree_mask as ttree  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import seq2seq as tseq  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "policy_sweep")
POLICIES = ("exact", "topk", "distance", "adaptive", "input_copy", "topk_tree")
B, SE, MAX_NEW, K = 2, 7, 10, 4


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def port_cfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def mt():
    """(jax cfg, port cfg, jax params, port params, src (B, Se) int32) for
    paper-mt-base's smoke config in fp32."""
    jcfg = jconfig.get_config("paper-mt-base", smoke=True).replace(dtype="float32")
    jp = jseq.init(jax.random.PRNGKey(0), jcfg)
    tcfg = port_cfg(jcfg)
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    src = np.random.default_rng(1).integers(1, jcfg.vocab_size,
                                            (B, SE)).astype(np.int32)
    return jcfg, tcfg, jp, tp, src


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _src_mask():
    mask = np.ones((B, SE), bool)
    mask[1, SE - 3:] = False
    return mask


# ---------------------------------------------------------------------------
# config, bridge, small checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_registered_paper_mt_base_matches_reference(smoke):
    want = jconfig.get_config("paper-mt-base", smoke=smoke)
    got = tconfig.get_config("paper-mt-base", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_bridge_keys_and_shapes(mt):
    _, tcfg, jp, tp, _ = mt
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
             tuple(np.shape(leaf))
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == paths
    assert {"enc_pos", "enc_blocks.1.attn.wq", "enc_norm.bias",
            "blocks.0.ln_cross.scale", "blocks.1.cross.wo",
            "lm_head.w"} <= set(paths)
    meta = tmodel.init(tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in meta.state_dict().items()} == paths


def test_unsupported_encoder_decoders_raise():
    cfg = tconfig.get_config("paper-mt-base", smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.init(cfg.replace(mlp_type="moe"), device="meta")
    with pytest.raises(ValueError, match="num_encoder_layers"):
        cfg.replace(num_encoder_layers=0).validate()


def test_bf16_cast_keeps_cross_and_encoder_norms_fp32(mt):
    _, tcfg, _, _, _ = mt
    params = tmodel.init(tcfg, device="cpu")
    tmodel.cast_for_compute(params, tcfg.replace(dtype="bfloat16"))
    dtypes = {k: v.dtype for k, v in params.state_dict().items()}
    for key in ("blocks.0.ln_cross.scale", "blocks.0.ln_cross.bias",
                "enc_norm.scale", "enc_norm.bias",
                "enc_blocks.0.ln1.scale", "final_norm.bias"):
        assert dtypes[key] == torch.float32, key
    for key in ("blocks.0.cross.wq", "enc_pos", "src_embed.table",
                "enc_blocks.1.mlp.w1.w"):
        assert dtypes[key] == torch.bfloat16, key


@pytest.mark.parametrize("hd,match", [
    (16, "CUDA device"),
    pytest.param(24, "CUDA device", id="24-head_dim 24"),
    pytest.param(160, "CUDA device", id="160-head_dim 160"),
    (192, "head_dim 192")])
def test_check_attention_inputs_head_dims(hd, match):
    """head_dim 16, 24 and 160 pass the head_dim check (a CPU tensor then
    fails the device check); 192 is refused."""
    q = torch.zeros((1, 2, 4, hd))
    kv = torch.zeros((1, 16, 4, hd))
    with pytest.raises(ValueError, match=match):
        block_attention.check_attention_inputs(
            "verify_attention", q, kv, kv, torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 16), dtype=torch.int32), kv_len=16)


def test_serve_refuses_encoder_decoders():
    """The launcher serves an encoder-decoder's static batch (its prompts
    as sources, through ``decode_seq2seq``), and refuses it the engine,
    which is decoder-only as the reference's is."""
    from repro_torch.launch import serve

    base = ["--arch", "paper-mt-base", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--max-new", "4"]
    out = serve.main(base)
    assert set(out["batch"]) == {"src"} and out["tokens"].shape[0] == 2
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.main(base + ["--engine"])


# ---------------------------------------------------------------------------
# model functions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_encode_per_layer_kv(mt, masked):
    jcfg, tcfg, jp, tp, src = mt
    mask = _src_mask() if masked else None
    jkvs, _ = jseq.encode(jp, jcfg, jnp.asarray(src),
                          None if mask is None else jnp.asarray(mask))
    tkvs = tseq.encode(tp, tcfg, torch.tensor(src),
                       None if mask is None else torch.tensor(mask))
    assert len(tkvs) == len(jkvs) == tcfg.num_layers
    want_pos = np.zeros((B, SE), np.int32) if mask is None else np.where(mask, 0, -1)
    for t, (jk, jv) in zip(tkvs, jkvs):
        close(t.k, jk)
        close(t.v, jv)
        np.testing.assert_array_equal(t.kv_pos.numpy(), want_pos)
    assert all(t.kv_pos is tkvs[0].kv_pos for t in tkvs)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention(mt, masked):
    """``cross_attn_apply`` through the kernel route (``ref.verify_attention``
    on the CPU) and ``cross_attn_full`` (plain) against the reference's
    ``cross_attn_apply``, with and without a masked source tail."""
    jcfg, tcfg, jp, tp, _ = mt
    hd, kv = jcfg.resolved_head_dim, jcfg.num_kv_heads
    x, k, v = _x((B, K, jcfg.d_model), 2), _x((B, SE, kv, hd), 3), _x((B, SE, kv, hd), 4)
    mask = _src_mask() if masked else None
    want = jattn.cross_attn_apply(jp["blocks"][0]["cross"], jcfg, jnp.asarray(x),
                                  (jnp.asarray(k), jnp.asarray(v)),
                                  None if mask is None else jnp.asarray(mask))
    enc = tattn.CrossKV(torch.tensor(k), torch.tensor(v),
                        tattn.source_positions(
                            None if mask is None else torch.tensor(mask), B, SE,
                            "cpu"))
    p = tp["blocks"][0]["cross"]
    q_pos = torch.zeros((B, K), dtype=torch.int32)
    close(tattn.cross_attn_apply(p, tcfg, torch.tensor(x), enc, q_pos), want)
    close(tattn.cross_attn_full(p, tcfg, torch.tensor(x), enc), want)


def _prefill(mt, tgt_len=3):
    """Both sides encode the source (masked tail in row 1) and prefill
    decoder caches with a target prefix of ``tgt_len`` tokens."""
    jcfg, tcfg, jp, tp, src = mt
    mask = _src_mask()
    tgt = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                            (B, tgt_len)).astype(np.int32)
    jkvs, jmask = jseq.encode(jp, jcfg, jnp.asarray(src), jnp.asarray(mask))
    tkvs = tseq.encode(tp, tcfg, torch.tensor(src), torch.tensor(mask))
    jc = jseq.init_caches(jcfg, B, 1 + MAX_NEW, K)
    tc = tseq.init_caches(tcfg, B, 1 + MAX_NEW, K, device="cpu")
    jh, jc = jseq.forward_hidden(jp, jcfg, jnp.asarray(tgt), jkvs,
                                 enc_mask=jmask, caches=jc)
    th, tc = tseq.forward_hidden(tp, tcfg, torch.tensor(tgt), tkvs, caches=tc)
    return (jkvs, jmask, jc, jh), (tkvs, tc, th), tgt_len


def _check_caches(tcaches, jcaches):
    for tc, jc in zip(tcaches, jcaches):
        for name in ("k", "v"):
            close(tc["attn"][name], jc["attn"][name])
        np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                      np.asarray(jc["attn"]["pos"]))


def test_forward_hidden(mt):
    """Teacher forcing, with and without caches (the prefill fills them)."""
    jcfg, tcfg, jp, tp, _ = mt
    (jkvs, jmask, jc, jh), (tkvs, tc, th), _ = _prefill(mt)
    close(th, jh)
    _check_caches(tc, jc)
    tgt = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, 6)).astype(np.int32)
    jh2, _ = jseq.forward_hidden(jp, jcfg, jnp.asarray(tgt), jkvs, enc_mask=jmask)
    th2, none = tseq.forward_hidden(tp, tcfg, torch.tensor(tgt), tkvs)
    assert none is None
    close(th2, jh2)


def test_cached_cross_attention_needs_q_pos(mt):
    _, tcfg, _, tp, _ = mt
    _, (tkvs, tc, _), n = _prefill(mt)
    x = torch.zeros((B, K, tcfg.d_model))
    with pytest.raises(ValueError, match="q_pos"):
        tblocks.block_cached(tp["blocks"][0], tcfg, 0, x, tc[0],
                             torch.full((B,), n, dtype=torch.int32),
                             enc_kv=tkvs[0])


@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_decode_block_step(mt, kind):
    jcfg, tcfg, jp, tp, _ = mt
    (jkvs, jmask, jc, _), (tkvs, tc, _), n = _prefill(mt)
    block = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                              (B, K)).astype(np.int32)
    ln = np.asarray([n, n - 1], np.int32)
    jtopo = jtree.default_tree(K, 2) if kind == "tree" else None
    ttopo = ttree.default_tree(K, 2) if kind == "tree" else None
    jh, jc = jseq.decode_block_step(
        jp, jcfg, jp["embed"]["table"][jnp.asarray(block)], jc, jnp.asarray(ln),
        jkvs, jmask, tree=jtopo)
    th, tc = tseq.decode_block_step(
        tp, tcfg, tp["embed"]["table"][torch.tensor(block).long()], tc,
        torch.tensor(ln), tkvs,
        torch.zeros((B, K), dtype=torch.int32), tree=ttopo)
    close(th, jh)
    _check_caches(tc, jc)


# ---------------------------------------------------------------------------
# whole decodes against the reference
# ---------------------------------------------------------------------------


def _equal_decodes(jout, tout):
    (jt, js), (tt, ts) = jout, tout
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts["generated"].numpy(), np.asarray(js["generated"]))
    assert ts["iterations"] == int(js["iterations"])
    assert ts["invocations"] == int(js["invocations"])
    assert ts["mean_accepted"] == pytest.approx(float(js["mean_accepted"]), rel=1e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_bpd_decode_seq2seq_matches_reference(mt, policy):
    jcfg, tcfg, jp, tp, src = mt
    kw = dict(max_new_tokens=MAX_NEW, block_k=K, policy=policy, top_k=2,
              epsilon=2.0)
    _equal_decodes(
        jdecode.bpd_decode_seq2seq(jp, jcfg, jconfig.DecodeConfig(**kw),
                                   {"src": jnp.asarray(src)}),
        tdecode.bpd_decode_seq2seq(tp, tcfg, tconfig.DecodeConfig(**kw),
                                   {"src": torch.tensor(src)}))


def test_greedy_decode_seq2seq_matches_reference_and_bpd(mt):
    jcfg, tcfg, jp, tp, src = mt
    kw = dict(max_new_tokens=MAX_NEW, block_k=K)
    tout = tdecode.greedy_decode_seq2seq(tp, tcfg, tconfig.DecodeConfig(**kw),
                                         {"src": torch.tensor(src)})
    _equal_decodes(
        jdecode.greedy_decode_seq2seq(jp, jcfg, jconfig.DecodeConfig(**kw),
                                      {"src": jnp.asarray(src)}), tout)
    assert tout[1]["iterations"] == MAX_NEW
    bpd, _ = tdecode.bpd_decode_seq2seq(tp, tcfg, tconfig.DecodeConfig(**kw),
                                        {"src": torch.tensor(src)})
    assert torch.equal(bpd[:, :MAX_NEW], tout[0][:, :MAX_NEW])


# twins of tests/test_policy.py's input_copy unit tests


def test_input_copy_drafts_source_aligned():
    """Slots >= 1 copy the source at the output positions the block covers;
    slot 0 is the verified greedy token."""
    drafter = tpolicy.InputCopyDrafter()
    src = torch.tensor([[10, 11, 12, 13, 14, 15]], dtype=torch.int32)
    state = drafter.init_state(None, None, {"src": src}, 1)
    b, k, v = 1, 4, 20
    logits = torch.full((b, k, v), -10.0)
    logits[0, 1, 7] = 10.0          # p_1 argmax at accepted slot 1 -> 7
    inputs = tpolicy.DraftInputs(
        hidden=torch.zeros((b, k, 8)), p1_logits=logits,
        khat=torch.tensor([2], dtype=torch.int32),
        slot=torch.tensor([1], dtype=torch.int32),
        text_len=torch.tensor([3], dtype=torch.int32),
        old_proposals=torch.zeros((1, 4), dtype=torch.int32),
        head_topk=None)
    props, _ = drafter.draft(inputs, state)
    # text_len=3 -> block covers output indices 2..5 -> src[2..5]; slot 0
    # replaced by the verified token 7
    assert props.tolist() == [[7, 13, 14, 15]]


def test_input_copy_rejects_promptless_paths():
    with pytest.raises(ValueError, match="seq2seq"):
        tpolicy.InputCopyDrafter().init_state(None, None, None, 2)
    with pytest.raises(ValueError, match="seq2seq"):
        tpolicy.InputCopyDrafter().init_state(None, None, {"tokens": None}, 2)
    assert tpolicy.resolve_policy(tconfig.DecodeConfig(policy="input_copy")).name \
        == jpolicy.resolve_policy(jconfig.DecodeConfig(policy="input_copy")).name


# ---------------------------------------------------------------------------
# the trained policy-sweep fixture
# ---------------------------------------------------------------------------


def _fixture_config(module):
    with open(os.path.join(FIXTURE, "config.json")) as f:
        fields = json.load(f)
    fields["global_attn_layers"] = tuple(fields["global_attn_layers"])
    return module.ModelConfig(**fields)


@pytest.fixture(scope="module")
def sweep():
    """(reference.json, src (16, 24) int32)."""
    with open(os.path.join(FIXTURE, "reference.json")) as f:
        ref = json.load(f)
    return ref, np.load(os.path.join(FIXTURE, "src.npy"))


def _fixture_tool():
    spec = importlib.util.spec_from_file_location(
        "make_sweep_fixture", os.path.join(ROOT, "tools", "make_sweep_fixture.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_fixture_config_is_the_sweep_config(monkeypatch):
    """config.json is, field for field, the config ``finetune_heads``
    returns (the config does not depend on the training, which is skipped
    here), and src.npy holds the rows ``policy_sweep.run`` decodes."""
    tool = _fixture_tool()
    monkeypatch.setattr(tool.policy_sweep, "train_steps",
                        lambda cfg, tc, params, *a, **kw: (params, {}))
    cfg0 = tool.policy_sweep._config(tool.K, enabled=False)
    base = jseq.init(jax.random.PRNGKey(0), cfg0)
    cfg, _ = tool.policy_sweep.finetune_heads(cfg0, base, tool.K)
    assert dataclasses.asdict(_fixture_config(jconfig)) == dataclasses.asdict(cfg)
    np.testing.assert_array_equal(np.load(os.path.join(FIXTURE, "src.npy")),
                                  tool.eval_sources())


def test_reference_reproduces_reference_json(sweep):
    """The JAX reference decoding the committed checkpoint, as the fixture
    tool decodes it, gives ``reference.json``: the fixture is the
    reference's."""
    ref, src = sweep
    tool = _fixture_tool()
    cfg = _fixture_config(jconfig)
    template = jseq.init(jax.random.PRNGKey(0), cfg)
    params, _ = jckpt.restore(os.path.join(FIXTURE, "checkpoint"), template)
    assert tool.reference_decode(params, cfg, src) == ref


@pytest.mark.parametrize("policy", POLICIES)
def test_port_reproduces_reference_json(sweep, policy):
    """The port on the CPU, row by row at B 1 as the reference: tokens,
    iterations, generated counts and mean k̂ equal ``reference.json``'s;
    the lossless policies emit exact's tokens."""
    ref, src = sweep
    cfg = _fixture_config(tconfig)
    params = bridge.load_checkpoint(os.path.join(FIXTURE, "checkpoint"), cfg,
                                    device="cpu")
    dec = tconfig.DecodeConfig(max_new_tokens=src.shape[1], block_k=8,
                               policy=policy, top_k=2, epsilon=2.0)
    rows = []
    for r in range(src.shape[0]):
        toks, stats = tdecode.bpd_decode_seq2seq(
            params, cfg, dec, {"src": torch.tensor(src[r:r + 1])})
        rows.append({"tokens": toks[0, :src.shape[1]].tolist(),
                     "iterations": stats["iterations"],
                     "generated": int(stats["generated"][0])})
    assert rows == ref[policy]["rows"]
    khat = float(np.mean([r["generated"] / max(r["iterations"], 1) for r in rows]))
    assert khat == ref[policy]["mean_khat"]
    if policy in ("adaptive", "input_copy", "topk_tree"):
        assert [r["tokens"] for r in rows] == \
            [r["tokens"] for r in ref["exact"]["rows"]]
