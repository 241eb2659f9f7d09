"""The port's model stack against the JAX reference, function by function,
in fp32 on the CPU (``conftest.tiny_dense`` geometry; weights made by
``repro.models.model.init`` and carried across by ``bridge``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro.core import heads as jheads  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch.core import heads as theads  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)


def port_cfg(jcfg):
    """The port's ModelConfig with the reference config's every field."""
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def to_torch(tree):
    """A reference pytree of arrays -> the same nesting of torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def dense():
    """(jax cfg, port cfg, jax params, port params) for tiny_dense."""
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = port_cfg(jcfg)
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ModelConfig", "DecodeConfig"])
def test_config_fields_match_reference(name):
    ref_fields = {f.name: f.default for f in
                  dataclasses.fields(getattr(jconfig, name))}
    port_fields = {f.name: f.default for f in
                   dataclasses.fields(getattr(tconfig, name))}
    assert port_fields == ref_fields


@pytest.mark.parametrize("arch,smoke", [
    *(pytest.param("granite-3-8b", smoke, id=str(smoke))
      for smoke in (False, True)),
    *(pytest.param(arch, smoke, id=f"{arch}-{smoke}")
      for arch in ("stablelm-12b", "starcoder2-7b", "nemotron-4-15b")
      for smoke in (False, True))])
def test_registered_granite_matches_reference(arch, smoke):
    """The port's copy of granite-3-8b's registered config, and of the
    other dense text decoders', full and smoke, equals the reference's
    field for field."""
    want = jconfig.get_config(arch, smoke=smoke)
    got = tconfig.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab_size == want.padded_vocab_size
    assert got.compute_dtype == torch.bfloat16


def test_state_dict_keys_are_reference_paths(dense):
    _, tcfg, jp, tp = dense
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
             tuple(np.shape(leaf))
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == paths
    assert "blocks.1.attn.wq" in paths
    meta = tmodel.init(tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in meta.state_dict().items()} == paths


def test_bridge_rejects_wrong_shapes(dense):
    jcfg, tcfg, jp, _ = dense
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["blocks"][0]["attn"]["wq"] = tree["blocks"][0]["attn"]["wq"][:, :2]
    with pytest.raises(ValueError, match="blocks.0.attn.wq"):
        bridge.from_jax_params(tree, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(kind):
    x = _x((2, 5, 64))
    p = {"scale": _x((64,), 1), "bias": _x((64,), 2)}
    want = jlayers.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind=kind)
    got = tlayers.norm_apply(to_torch(p), torch.tensor(x), kind=kind)
    close(got, want)


def test_apply_rope():
    x = _x((2, 7, 4, 16))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 300]],
                   np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu", "geglu", "relu2"])
def test_mlp_apply(act):
    jcfg = tiny_dense(activation=act)
    p = jlayers.mlp_init(jax.random.PRNGKey(1), jcfg)
    x = _x((2, 3, 64))
    want = jlayers.mlp_apply(p, jnp.asarray(x), act=act)
    got = tlayers.mlp_apply(to_torch(p), torch.tensor(x), act=act)
    close(got, want)


def test_embed_and_project_vocab(dense):
    jcfg, tcfg, jp, tp = dense
    ids = np.array([[0, 5, 96], [3, 3, 1]], np.int32)
    close(tlayers.embed_apply(tp["embed"], torch.tensor(ids)),
          jlayers.embed_apply(jp["embed"], jnp.asarray(ids)))
    h = _x((2, 3, 64))
    got = tmodel.project_vocab(tp, tcfg, torch.tensor(h))
    want = jmodel.project_vocab(jp, jcfg, jnp.asarray(h))
    close(got, want)
    assert float(got[..., jcfg.vocab_size:].max()) == -1e9


def test_project_vocab_tied():
    jcfg = tiny_dense(tie_embeddings=True)
    jp = jmodel.init(jax.random.PRNGKey(2), jcfg)
    tcfg = port_cfg(jcfg)
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    h = _x((3, 64))
    close(tmodel.project_vocab(tp, tcfg, torch.tensor(h)),
          jmodel.project_vocab(jp, jcfg, jnp.asarray(h)))
    assert tmodel.vocab_matrix(tp, tcfg).stride() == (1, 64)   # a view


def test_heads_apply_and_all_head_logits(dense):
    jcfg, tcfg, jp, tp = dense
    h = _x((2, 3, 64))
    close(theads.heads_apply(tp["bpd_heads"], tcfg, torch.tensor(h)),
          jheads.heads_apply(jp["bpd_heads"], jcfg, jnp.asarray(h)))
    close(tmodel.all_head_logits(tp, tcfg, torch.tensor(h)),
          jmodel.all_head_logits(jp, jcfg, jnp.asarray(h)), rtol=2e-5, atol=1e-4)
    close(theads.head_apply_single(tp["bpd_heads"], tcfg, torch.tensor(h), 2),
          jheads.head_apply_single(jp["bpd_heads"], jcfg, jnp.asarray(h), 2))


def test_head_topk_equals_argmax_of_all_head_logits(dense):
    """The drafter's fused-heads path gives the reference's head argmax."""
    jcfg, tcfg, jp, tp = dense
    h = _x((6, 64), 3)
    want = np.asarray(jnp.argmax(jmodel.all_head_logits(jp, jcfg, jnp.asarray(h)), -1))
    got = tmodel.head_topk(tp, tcfg, torch.tensor(h), jcfg.bpd_k - 1)
    assert got.shape == (6, jcfg.bpd_k - 1, 1)
    np.testing.assert_array_equal(got[:, :, 0].numpy(), want[:, 1:])


# ---------------------------------------------------------------------------
# attention and the cache
# ---------------------------------------------------------------------------


def _attn_setup(window=0, meta=0, seed=4):
    jcfg = tiny_dense(sliding_window=window, num_meta_tokens=meta)
    p = jattn.attn_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, port_cfg(jcfg), p, to_torch(p)


@pytest.mark.parametrize("window", [0, 8])
def test_attn_full(window):
    jcfg, tcfg, jp, tp = _attn_setup(window=window)
    x = _x((2, 12, 64))
    want, (wk, wv) = jattn.attn_full(jp, jcfg, jnp.asarray(x), return_kv=True)
    got, (gk, gv) = tattn.attn_full(tp, tcfg, torch.tensor(x), return_kv=True)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


def _prefilled_cache(jcfg, jp, tcfg, tp, b, prompt, buf_len):
    """The same prefilled cache in both packages."""
    from repro.models import cache as jcache
    from repro_torch.models import cache as tcache

    x = _x((b, prompt, 64), 5)
    pos = np.arange(prompt, dtype=np.int32)
    _, (k, v) = jattn.attn_full(jp, jcfg, jnp.asarray(x),
                                positions=jnp.asarray(pos), return_kv=True)
    jc = jattn.cache_write(jcache.attn_cache_init(b, buf_len, 2, 16, jnp.float32),
                           jcfg, 0, k, v, jnp.asarray(pos))
    tc = tattn.cache_write(tcache.attn_cache_init(b, buf_len, 2, 16, torch.float32),
                           tcfg, 0, torch.tensor(np.asarray(k)),
                           torch.tensor(np.asarray(v)), torch.tensor(pos))
    return jc, tc


def _check_cache(tc, jc):
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])


@pytest.mark.parametrize("window,meta,prompt,length", [
    (0, 0, 10, [10, 7]),     # full attention; row 1 rolled back by 3
    (16, 4, 20, [20, 18]),   # sliding window + meta tokens, ring wraps
])
def test_attn_cached(window, meta, prompt, length):
    from repro.models import cache as jcache

    jcfg, tcfg, jp, tp = _attn_setup(window=window, meta=meta)
    buf = jcache.attn_buf_len(jcfg, 0, prompt + 8, 4)
    jc, tc = _prefilled_cache(jcfg, jp, tcfg, tp, 2, prompt, buf)
    xb = _x((2, 4, 64), 6)
    ln = np.asarray(length, np.int32)
    want, jc2 = jattn.attn_cached(jp, jcfg, jnp.asarray(xb), jc, jnp.asarray(ln))
    got, tc2 = tattn.attn_cached(tp, tcfg, torch.tensor(xb), tc, torch.tensor(ln))
    assert tc2 is tc                              # written in place
    close(got, want)
    _check_cache(tc2, jc2)


def test_cache_write_ring_buffer():
    """Per-row decode writes wrap around the window ring, keeping the
    reserved meta slots, exactly where the reference writes them."""
    from repro.models import cache as jcache
    from repro_torch.models import cache as tcache

    jcfg, tcfg, _, _ = _attn_setup(window=16, meta=4)
    buf = jcache.attn_buf_len(jcfg, 0, 300, 4)
    assert buf == tcache.attn_buf_len(tcfg, 0, 300, 4) == 256
    small = 32                     # a short ring so positions wrap
    jc = jcache.attn_cache_init(2, small, 2, 16, jnp.float32)
    tc = tcache.attn_cache_init(2, small, 2, 16, torch.float32)
    for step, base in enumerate(([0, 3], [26, 40], [61, 90])):
        pos = np.asarray(base, np.int32)[:, None] + np.arange(4, dtype=np.int32)
        k, v = _x((2, 4, 2, 16), 10 + step), _x((2, 4, 2, 16), 20 + step)
        jc = jattn.cache_write(jc, jcfg, 0, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos))
        tc = tattn.cache_write(tc, tcfg, 0, torch.tensor(k), torch.tensor(v),
                               torch.tensor(pos))
        _check_cache(tc, jc)
    # a prefill longer than the buffer keeps the meta head + the tail
    pos = np.arange(50, dtype=np.int32)
    k, v = _x((2, 50, 2, 16), 30), _x((2, 50, 2, 16), 31)
    jc = jattn.cache_write(jcache.attn_cache_init(2, small, 2, 16, jnp.float32),
                           jcfg, 0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tc = tattn.cache_write(tcache.attn_cache_init(2, small, 2, 16, torch.float32),
                           tcfg, 0, torch.tensor(k), torch.tensor(v), torch.tensor(pos))
    _check_cache(tc, jc)


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


def test_forward_hidden_and_decode_block_step(dense):
    jcfg, tcfg, jp, tp = dense
    b, prompt, ctx, bk = 2, 9, 20, 4
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (b, prompt)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks)}
    jcaches = jmodel.init_caches(jcfg, b, ctx, bk)
    tcaches = tmodel.init_caches(tcfg, b, ctx, bk, device="cpu")
    pos = np.arange(prompt, dtype=np.int32)
    jh, _, jcaches = jmodel.forward_hidden(jp, jcfg, jmodel.embed_inputs(jp, jcfg, jb),
                                           positions=jnp.asarray(pos), caches=jcaches)
    th, tcaches = tmodel.forward_hidden(tp, tcfg, tmodel.embed_inputs(tp, tcfg, tb),
                                        positions=torch.tensor(pos), caches=tcaches)
    close(th, jh)
    for tc, jc in zip(tcaches, jcaches):
        _check_cache(tc["attn"], jc["attn"])

    block = np.random.default_rng(9).integers(0, jcfg.vocab_size, (b, bk)).astype(np.int32)
    ln = np.asarray([prompt, prompt - 2], np.int32)
    jh, jcaches = jmodel.decode_block_step(
        jp, jcfg, jlayers.embed_apply(jp["embed"], jnp.asarray(block)),
        jcaches, jnp.asarray(ln))
    th, tcaches = tmodel.decode_block_step(
        tp, tcfg, tlayers.embed_apply(tp["embed"], torch.tensor(block)),
        tcaches, torch.tensor(ln))
    close(th, jh)
    for tc, jc in zip(tcaches, jcaches):
        _check_cache(tc["attn"], jc["attn"])


def test_unported_families_raise():
    """Every registered arch is ported; a combination none of them uses
    still raises before any work: a vision_text backbone with MoE MLPs, an
    audio decoder, a text encoder, an encoder-decoder with MoE MLPs."""
    llava = tconfig.get_config("llava-next-34b", smoke=True)
    hubert = tconfig.get_config("hubert-xlarge", smoke=True)
    moe = dict(mlp_type="moe", num_experts=4, num_experts_per_tok=2)
    for cfg in (llava.replace(**moe), hubert.replace(is_encoder_only=False),
                hubert.replace(modality="text"),
                tconfig.get_config("paper-mt-base", smoke=True).replace(**moe)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmodel.init(cfg, device="cpu")
