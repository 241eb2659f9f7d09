"""The dense text families (stablelm-12b, starcoder2-7b, nemotron-4-15b)
in the port against the JAX reference, in fp32 on the CPU, on weights made
by ``repro.models.model.init`` and carried across by ``bridge``.

Each narrow config keeps the hard part of one family's geometry at a size
the CPU decodes in seconds (the smoke config with):

- stablelm: head_dim 160 over 4 / 1 heads, ``qk_norm``;
- starcoder2: 9 / 1 heads of 128 (G 9: 36 query rows at block_k 4), gelu,
  every layer windowed at 32, prompts of 40 tokens so the ring wraps;
- nemotron: vocab 256000 at d 64, LayerNorm, relu2, an untied ``lm_head``.

On each: full-forward logits within 2e-5 (fp32 on both sides, sums in
another order), and ``greedy_decode`` and ``bpd_decode`` under ``exact``
and ``topk_tree`` on the dense and the paged cache with the reference's
tokens, iterations, k̂ and invocations.  Then the continuous-batching
engine on starcoder2's smoke config (every layer windowed) on the managed
page pool against the reference's engine and greedy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
B, MAX_NEW, K = 3, 12, 4
FAMILIES = ("stablelm-12b", "starcoder2-7b", "nemotron-4-15b")
NARROW = {
    "stablelm-12b": dict(num_heads=4, num_kv_heads=1, head_dim=160),
    "starcoder2-7b": dict(num_heads=9, num_kv_heads=1, head_dim=128),
    "nemotron-4-15b": dict(d_model=64, vocab_size=256000),
}
PROMPT = {"stablelm-12b": 8, "starcoder2-7b": 40, "nemotron-4-15b": 8}


def narrow_config(name: str):
    """The reference's smoke config of ``name`` with its family's hard
    geometry, in fp32."""
    return jconfig.get_config(name, smoke=True).replace(dtype="float32",
                                                        **NARROW[name])


def _bridged(jcfg, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return tcfg, jp, tp


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jcfg = narrow_config(name)
    tcfg, jp, tp = _bridged(jcfg, 1)
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, PROMPT[name])).astype(np.int32)
    return name, jcfg, tcfg, jp, tp, prompt


def _rows(toks, stats):
    n = np.asarray(stats["text_len"])
    t = np.asarray(toks)
    return [t[r, :n[r]].tolist() for r in range(len(n))]


def _check_same(jres, tres):
    jt, js = jres
    tt, ts = tres
    assert _rows(tt.numpy(), ts) == _rows(jt, js)
    assert ts["iterations"] == int(js["iterations"])
    assert ts["invocations"] == int(js["invocations"])
    np.testing.assert_array_equal(ts["generated"].numpy(),
                                  np.asarray(js["generated"]))
    np.testing.assert_allclose(ts["mean_accepted"], float(js["mean_accepted"]),
                               rtol=1e-6)


def _decs(**kw):
    kw = dict(max_new_tokens=MAX_NEW, block_k=K, top_k=2, **kw)
    return jconfig.DecodeConfig(**kw), DecodeConfig(**kw)


def test_narrow_configs_keep_the_families_geometry():
    st = narrow_config("stablelm-12b")
    assert st.head_dim == 160 and st.qk_norm and st.num_kv_heads == 1
    sc = narrow_config("starcoder2-7b")
    assert sc.num_heads // sc.num_kv_heads == 9 and sc.activation == "gelu"
    assert 0 < sc.sliding_window < PROMPT["starcoder2-7b"]
    ne = narrow_config("nemotron-4-15b")
    assert ne.vocab_size == 256000 and not ne.tie_embeddings
    assert (ne.norm_type, ne.activation) == ("layernorm", "relu2")


def test_forward_logits_match_reference(family):
    _, jcfg, tcfg, jp, tp, prompt = family
    jb, tb = {"tokens": jnp.asarray(prompt)}, {"tokens": torch.tensor(prompt)}
    jh = jmodel.forward_hidden(jp, jcfg, jmodel.embed_inputs(jp, jcfg, jb))[0]
    th = tmodel.forward_hidden(tp, tcfg, tmodel.embed_inputs(tp, tcfg, tb))[0]
    want = np.asarray(jmodel.base_logits(jp, jcfg, jh))
    got = tmodel.base_logits(tp, tcfg, th).numpy()
    assert got.shape == want.shape == (B, PROMPT[family[0]],
                                       jcfg.padded_vocab_size)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["greedy", "exact", "topk_tree"])
def test_decode_matches_reference(family, policy, backend):
    """Tokens, iterations, k̂ and invocations equal the reference's; exact
    acceptance emits the port's own greedy tokens."""
    _, jcfg, tcfg, jp, tp, prompt = family
    kw = dict(cache_backend=backend, page_size=8)
    if policy != "greedy":
        kw["policy"] = policy
    jdec, tdec = _decs(**kw)
    jb, tb = {"tokens": jnp.asarray(prompt)}, {"tokens": torch.tensor(prompt)}
    fn = "greedy_decode" if policy == "greedy" else "bpd_decode"
    tres = getattr(tdecode, fn)(tp, tcfg, tdec, tb)
    _check_same(getattr(jdecode, fn)(jp, jcfg, jdec, jb), tres)
    if policy != "greedy":
        greedy = tdecode.greedy_decode(tp, tcfg, _decs()[1], tb)
        assert _rows(tres[0].numpy(), tres[1]) == _rows(greedy[0].numpy(),
                                                         greedy[1])


# ---------------------------------------------------------------------------
# the engine on starcoder2's smoke config: every layer windowed
# ---------------------------------------------------------------------------


def _drive(sched, max_steps=500):
    now, fin = 0.0, []
    while not sched.drained():
        assert now < max_steps, "scheduler did not drain"
        fin += sched.step(now=now)
        now += 1.0
    return fin


def _serve_windowed(mod, params, cfg, dcls):
    dec = dcls(max_new_tokens=24, block_k=4, top_k=2, cache_backend="paged",
               page_size=8)
    eng = mod.ContinuousBatchingEngine(
        params, cfg, dec, mod.EngineConfig(num_slots=3, max_prompt_len=40,
                                           max_new_cap=24),
        policies={"exact": 2, "topk_tree": 1})
    sched = mod.Scheduler(eng)
    rng = np.random.default_rng(5)
    prompts = {}
    for i in range(6):
        prompts[i] = rng.integers(0, cfg.vocab_size,
                                  size=int(rng.integers(20, 41)))
        sched.submit(mod.Request(
            rid=i, arrival=float(i // 2),
            policy=("exact", "topk_tree", "exact")[i % 3],
            prompt=prompts[i], max_new=int(rng.integers(12, 25))))
    return eng, _drive(sched), prompts


def test_engine_windowed_equals_reference_and_greedy():
    """Six requests of 20-40 tokens through 3 slots (an exact group of 2,
    a topk_tree group of 1) on the managed page pool, where every layer is
    windowed at 32 and so keeps its dense ring: the port's finish records
    equal the reference's, and each request's tokens are its greedy
    decode alone."""
    jcfg = jconfig.get_config("starcoder2-7b", smoke=True).replace(
        dtype="float32")
    assert jcfg.sliding_window == 32
    tcfg, jp, tp = _bridged(jcfg, 3)
    jeng, jfin, _ = _serve_windowed(jserving, jp, jcfg, jconfig.DecodeConfig)
    teng, tfin, prompts = _serve_windowed(tserving, tp, tcfg, DecodeConfig)

    def record(f):
        return (f.rid, f.prompt_len, f.tokens.tolist(), f.generated,
                f.invocations, round(f.mean_accepted, 6), f.policy)
    assert [record(f) for f in tfin] == [record(f) for f in jfin]
    assert (teng.num_steps, teng.num_admits) == (jeng.num_steps,
                                                 jeng.num_admits)
    assert len(tfin) == 6
    for f in tfin:
        prompt = torch.tensor(prompts[f.rid].astype(np.int32))[None]
        dec = DecodeConfig(max_new_tokens=f.generated, block_k=4)
        toks, stats = tdecode.greedy_decode(tp, tcfg, dec, {"tokens": prompt})
        want = toks[0, f.prompt_len:int(stats["text_len"][0])].tolist()
        assert f.tokens.tolist() == want, f.rid
        assert f.prompt_len + f.generated > jcfg.sliding_window
