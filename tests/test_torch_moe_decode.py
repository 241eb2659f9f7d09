"""Decoding the MoE family in the port against the JAX reference, in fp32 on
the CPU, on bridged weights of both smoke configs (olmoe-1b-7b: 4 experts
top-2; qwen2-moe-a2.7b: 4 experts top-2 and a shared MLP): prompts of 16
tokens overflow the default capacity (10 slots an expert), so a path that
forgot full capacity would leave the reference's tokens.

``greedy_decode`` and ``bpd_decode`` under ``exact`` and ``topk_tree`` on
the dense and the paged cache give the reference's tokens, iterations, k̂
and invocations; the engine on olmoe's smoke config gives the reference's
finish records and greedy's tokens; ``draft_model`` with the MoE model
drafting for itself gives the reference's decode and greedy's tokens; the
serve launcher runs both archs.
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
from repro.core.bundle import ModelBundle as JModelBundle  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import ModelBundle  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(2)
MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
B, PROMPT, MAX_NEW = 4, 16, 24


def _bridged(jcfg, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return tcfg, jp, tp


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe(request):
    jcfg = jconfig.get_config(request.param, smoke=True).replace(
        dtype="float32")
    tcfg, jp, tp = _bridged(jcfg, 0)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


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
    kw = dict(max_new_tokens=MAX_NEW, top_k=2, **kw)
    return jconfig.DecodeConfig(**kw), DecodeConfig(**kw)


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["greedy", "exact", "topk_tree"])
def test_decode_matches_reference(moe, policy, backend):
    """Tokens, iterations, k̂ and invocations equal the reference's; BPD
    emits the port's own greedy tokens."""
    jcfg, tcfg, jp, tp, prompt = moe
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


def test_self_draft_matches_reference_and_greedy(moe):
    """draft_model with the MoE model drafting for itself: its own prefill
    and kq-1 steps at full capacity, the reference's tokens, iterations and
    k̂, and greedy's tokens."""
    jcfg, tcfg, jp, tp, prompt = moe
    jdec, tdec = _decs(policy="draft_model", block_k=4)
    jres = jdecode.bpd_decode(jp, jcfg, jdec, {"tokens": jnp.asarray(prompt)},
                              bundles={"draft": JModelBundle(jp, jcfg)})
    tres = tdecode.bpd_decode(tp, tcfg, tdec, {"tokens": torch.tensor(prompt)},
                              bundles={"draft": ModelBundle(tp, tcfg)})
    _check_same(jres, tres)
    greedy = tdecode.greedy_decode(tp, tcfg, _decs()[1],
                                   {"tokens": torch.tensor(prompt)})
    assert _rows(tres[0].numpy(), tres[1]) == _rows(greedy[0].numpy(),
                                                     greedy[1])


# ---------------------------------------------------------------------------
# the engine on olmoe's smoke config
# ---------------------------------------------------------------------------


def _drive(sched, max_steps=500):
    now, fin = 0.0, []
    while not sched.drained():
        assert now < max_steps, "scheduler did not drain"
        fin += sched.step(now=now)
        now += 1.0
    return fin


def _serve(mod, params, cfg, dcls):
    dec = dcls(max_new_tokens=20, block_k=4, top_k=2, cache_backend="paged",
               page_size=8)
    eng = mod.ContinuousBatchingEngine(
        params, cfg, dec, mod.EngineConfig(num_slots=3, max_prompt_len=32,
                                           max_new_cap=20),
        policies={"exact": 2, "topk_tree": 1})
    sched = mod.Scheduler(eng)
    rng = np.random.default_rng(5)
    prompts = {}
    for i in range(6):
        prompts[i] = rng.integers(0, cfg.vocab_size,
                                  size=int(rng.integers(16, 33)))
        sched.submit(mod.Request(
            rid=i, arrival=float(i // 2),
            policy=("exact", "topk_tree", "exact")[i % 3],
            prompt=prompts[i], max_new=int(rng.integers(10, 21))))
    return eng, _drive(sched), prompts


def test_engine_equals_reference_and_greedy():
    """Six requests of 16-32 tokens through 3 slots (an exact group of 2,
    a topk_tree group of 1) on the managed page pool: the port's finish
    records equal the reference's, and each request's tokens are its
    greedy decode alone."""
    jcfg = jconfig.get_config("olmoe-1b-7b", smoke=True).replace(
        dtype="float32")
    tcfg, jp, tp = _bridged(jcfg, 3)
    jeng, jfin, _ = _serve(jserving, jp, jcfg, jconfig.DecodeConfig)
    teng, tfin, prompts = _serve(tserving, tp, tcfg, DecodeConfig)

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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_runs_moe(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--max-new", "8"])
    assert out["cfg"].name == arch and out["cfg"].mlp_type == "moe"
    assert tuple(out["tokens"].shape)[0] == 2
    assert bool((out["stats"]["generated"] == 8).all())
    assert out["stats"]["mean_accepted"] >= 1.0
