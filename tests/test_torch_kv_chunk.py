"""``kv_chunk``, the reference's memory-bounded long prefill, against the
JAX reference in fp32 on the CPU (``conftest.tiny_dense`` geometry):
``_chunked_attend`` and ``attn_full`` with chunks of 1, 7, 16 and 64 keys
(a cache of 20-30 positions: chunks shorter than, not dividing and longer
than it), the port's unchunked ``attn_cached`` against the reference's
chunked one, the tree refusal, whole decodes whose tokens ``kv_chunk``
leaves unchanged, and the launcher's ``--kv-chunk``.

Tolerance: rtol = atol = 1e-5, fp32 on both sides with the online
softmax's sums in the reference's order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 DecodeSession, EngineConfig, Request,
                                 Scheduler)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKS = (1, 7, 16, 64)
B, K, PS = 3, 4, 8


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _attn(window=0, meta=0, seed=4):
    jcfg = tiny_dense(sliding_window=window, num_meta_tokens=meta)
    p = jattn.attn_init(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), p, tp


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["causal", "window+meta", "bidirectional",
                                  "per-row positions"])
def test_chunked_attend_matches_reference(kind, chunk):
    """The online softmax alone: GQA (4 heads over 2), masked keys (-1),
    a window with meta tokens, the encoder's bidirectional mask, and
    per-row (B, S) positions."""
    b, sq, sk, h, kvh, hd = 2, 9, 21, 4, 2, 16
    q, k, v = _x((b, sq, h, hd), 1), _x((b, sk, kvh, hd), 2), _x((b, sk, kvh, hd), 3)
    q_pos = np.arange(sk - sq, sk, dtype=np.int32)
    kv_pos = np.arange(sk, dtype=np.int32)
    kv_pos[5] = -1
    kw = dict(window=0, num_meta=0, bidirectional=False, head_dim=hd,
              chunk=chunk)
    if kind == "window+meta":
        kw.update(window=6, num_meta=2)
    elif kind == "bidirectional":
        kw.update(bidirectional=True)
    elif kind == "per-row positions":
        q_pos = np.stack([q_pos, q_pos - 4])
        kv_pos = np.stack([kv_pos, np.where(kv_pos < sk - 4, kv_pos, -1)])
    want = jattn._chunked_attend(*(jnp.asarray(a) for a in (q, k, v, q_pos,
                                                           kv_pos)), **kw)
    got = tattn._chunked_attend(*(torch.tensor(a) for a in (q, k, v, q_pos,
                                                           kv_pos)), **kw)
    _close(got, want)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("window,meta", [(0, 0), (8, 2)])
def test_attn_full_kv_chunk_matches_reference(window, meta, chunk):
    """Prefill attention of 23 positions with its K/V, chunked on both
    sides; the chunked output also equals the unchunked one."""
    jcfg, tcfg, jp, tp = _attn(window, meta)
    x = _x((B, 23, 64), 5)
    jy, (jk, jv) = jattn.attn_full(jp, jcfg, jnp.asarray(x), return_kv=True,
                                   kv_chunk=chunk)
    ty, (tk, tv) = tattn.attn_full(tp, tcfg, torch.tensor(x), return_kv=True,
                                   kv_chunk=chunk)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)
    _close(ty, jattn.attn_full(jp, jcfg, jnp.asarray(x)))


def _prefilled(backend, jcfg, tcfg, jp, prompt=17, context=30):
    """One layer's cache prefilled with ``prompt`` positions in both
    packages, dense or paged."""
    if backend == "paged":
        jbe, tbe = jcache.PagedBackend(PS), tcache.PagedBackend(PS)
    else:
        jbe, tbe = jcache.DenseBackend(), tcache.DenseBackend()
    jc = jbe.layer_attn_init(jcfg, 0, B, context, K, jnp.float32)
    tc = tbe.layer_attn_init(tcfg, 0, B, context, K, torch.float32)
    x = _x((B, prompt, 64), 6)
    pos = np.arange(prompt, dtype=np.int32)
    _, (kk, vv) = jattn.attn_full(jp, jcfg, jnp.asarray(x),
                                  positions=jnp.asarray(pos), return_kv=True)
    jc = jattn.cache_write(jc, jcfg, 0, kk, vv, jnp.asarray(pos))
    tc = tattn.cache_write(tc, tcfg, 0, torch.tensor(np.asarray(kk)),
                           torch.tensor(np.asarray(vv)), torch.tensor(pos))
    return jc, tc


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_attn_cached_kv_chunk_matches_reference(backend, chunk):
    """A verify block of K fresh tokens at per-row lengths against a
    prefilled cache: the port's ``attn_cached`` takes no ``kv_chunk`` (a
    block's (K, L) scores need no bound), and equals the reference's
    chunked one."""
    jcfg, tcfg, jp, tp = _attn()
    jc, tc = _prefilled(backend, jcfg, tcfg, jp)
    x = _x((B, K, 64), 7)
    length = np.array([17, 15, 12], np.int32)
    jy, _ = jattn.attn_cached(jp, jcfg, jnp.asarray(x), jc, jnp.asarray(length),
                              kv_chunk=chunk)
    ty, _ = tattn.attn_cached(tp, tcfg, torch.tensor(x), tc,
                              torch.tensor(length))
    _close(ty, jy)


def _params(jcfg):
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jp, bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, device="cpu")


def test_tree_with_kv_chunk_raises():
    """As the reference: chunked attention has no per-column mask override
    for a tree's nodes, so a tree-drafting decode refuses ``kv_chunk``
    (through ``bpd_decode`` and a session's serving prefill alike)."""
    jcfg = tiny_dense()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp, params = _params(jcfg)
    dec = DecodeConfig(max_new_tokens=6, block_k=K, policy="topk_tree", top_k=2)
    prompt = np.zeros((1, 5), np.int32)
    jdec = JDecodeConfig(max_new_tokens=6, block_k=K, policy="topk_tree",
                         top_k=2)
    with pytest.raises(ValueError, match="kv_chunk"):
        jdecode.bpd_decode(jp, jcfg, jdec, {"tokens": jnp.asarray(prompt)},
                           kv_chunk=8)
    with pytest.raises(ValueError, match="kv_chunk"):
        tdecode.bpd_decode(params, tcfg, dec, {"tokens": torch.tensor(prompt)},
                           kv_chunk=8)
    sess = DecodeSession(params, tcfg, dec, kv_chunk=8)
    eng = ContinuousBatchingEngine(params, tcfg, dec, EngineConfig(
        num_slots=1, max_prompt_len=5, max_new_cap=6), session=sess)
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, prompt=prompt[0], max_new=6))
    with pytest.raises(ValueError, match="kv_chunk"):
        sched.run()


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_dense()
    jp, tp = _params(jcfg)
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                                (2, 21)).astype(np.int32)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp, prompts


@pytest.mark.parametrize("chunk", [7, 64])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_bpd_tokens_unchanged_by_kv_chunk(model, backend, chunk):
    """BPD exact and greedy with kv_chunk emit the tokens, iterations and
    k̂ they emit without it, which are the reference's with it."""
    jcfg, tcfg, jp, tp, prompts = model
    kw = dict(max_new_tokens=10, block_k=K, cache_backend=backend,
              page_size=PS)
    batch = {"tokens": torch.tensor(prompts)}
    plain, pstats = tdecode.bpd_decode(tp, tcfg, DecodeConfig(**kw), batch)
    toks, stats = tdecode.bpd_decode(tp, tcfg, DecodeConfig(**kw), batch,
                                     kv_chunk=chunk)
    jt, js = jdecode.bpd_decode(jp, jcfg, JDecodeConfig(**kw),
                                {"tokens": jnp.asarray(prompts)},
                                kv_chunk=chunk)
    assert torch.equal(toks, plain)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    assert stats["iterations"] == pstats["iterations"] == int(js["iterations"])
    assert stats["mean_accepted"] == pytest.approx(float(js["mean_accepted"]),
                                                   rel=1e-6)
    greedy, _ = tdecode.greedy_decode(tp, tcfg, DecodeConfig(**kw), batch,
                                      kv_chunk=chunk)
    assert torch.equal(greedy, tdecode.greedy_decode(tp, tcfg,
                                                     DecodeConfig(**kw),
                                                     batch)[0])


def test_decode_session_kv_chunk(model):
    """DecodeSession(kv_chunk=) decodes as bpd_decode(kv_chunk=) and its
    greedy as greedy_decode; the serving functions it builds prefill in
    chunks too and serve the same tokens."""
    jcfg, tcfg, jp, tp, prompts = model
    dec = DecodeConfig(max_new_tokens=8, block_k=K)
    batch = {"tokens": torch.tensor(prompts)}
    sess = DecodeSession(tp, tcfg, dec, kv_chunk=5)
    toks, stats = sess.decode(batch)
    want, wstats = tdecode.bpd_decode(tp, tcfg, dec, batch, kv_chunk=5)
    assert torch.equal(toks, want) and stats["iterations"] == wstats["iterations"]
    assert torch.equal(sess.greedy(batch)[0],
                       tdecode.greedy_decode(tp, tcfg, dec, batch)[0])
    eng = ContinuousBatchingEngine(tp, tcfg, dec, EngineConfig(
        num_slots=2, max_prompt_len=21, max_new_cap=8), session=sess)
    sched = Scheduler(eng)
    for r in range(2):
        sched.submit(Request(rid=r, prompt=prompts[r], max_new=8))
    done = {f.rid: f for f in sched.run()}
    for r in range(2):
        n = int(stats["text_len"][r])
        assert done[r].tokens.tolist() == toks[r, 21:n].tolist()


@pytest.mark.parametrize("mode", [[], ["--engine"]])
def test_serve_kv_chunk_flag(mode):
    """``launch.serve --kv-chunk`` (static batch and ``--engine``) prefills
    12-token prompts in chunks of 5 keys and serves the tokens of the
    unchunked run."""
    from repro_torch.launch import serve

    argv = ["--arch", "granite-3-8b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--max-new", "8", *mode]
    plain = serve.main(argv)
    out = serve.main(argv + ["--kv-chunk", "5"])
    if mode:
        def rows(o):
            return {f.rid: f.tokens.tolist() for f in o["finished"]}
        assert len(out["finished"]) == 4 and rows(out) == rows(plain)
    else:
        assert torch.equal(out["tokens"], plain["tokens"])
        assert out["stats"]["iterations"] == plain["stats"]["iterations"]
