"""bf16 decodes of the MoE family in the port against the JAX reference's,
on the CPU, on the same bridged weights (olmoe-1b-7b's smoke config from
seeds 0 and 1, qwen2-moe-a2.7b's from seed 1), each cast for bf16 compute.

The two frameworks round bf16 at other places, so a row may leave the
reference's tokens at a near-tie, and an MoE model has two kinds:

- a logit near-tie: the reference's top-2 gap of p_1 (its full forward at
  full capacity over the row's prefix) is within TIE_ULPS bf16 ulps of its
  top logit;
- a router near-tie: the first (position, layer) at which the two decodes'
  chosen experts differ has a relative K-th / (K+1)-th router-probability
  gap, (p_K - p_{K+1}) / p_K on either side, of at most ROUTER_TIE.  One
  swapped expert moves the hidden state by a few percent, which can change
  a token far from any logit near-tie.

The routings are the decodes' own: the port's through ``moe.ROUTER_TRACE``,
the reference's through a ``jax.debug.callback`` wrapped around its
``moe_apply`` for the length of the test (the reference's files are not
touched).  Each position's routing is the one of the last forward that
computed it (later blocks recompute rejected positions).  Every divergence
must be one of the two kinds; the test prints which.
"""
import contextlib
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(2)
TIE_ULPS = 4
ROUTER_TIE = 4 * 2.0 ** -7      # 4 bf16 ulps of relative precision
B, PROMPT, MAX_NEW, K = 4, 16, 24, 4
CASES = [("olmoe-1b-7b", 0), ("olmoe-1b-7b", 1), ("qwen2-moe-a2.7b", 1)]


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def bf16_pair(request):
    name, seed = request.param
    jcfg = jconfig.get_config(name, smoke=True).replace(dtype="bfloat16")
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    tmodel.cast_for_compute(tp, tcfg)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


@contextlib.contextmanager
def reference_routing(records):
    """Append (layer, positions (B, S), router logits (B, S, E)) of every
    MoE layer the reference runs, from inside its compiled loops: the
    attention call before each MoE layer gives the layer and positions."""
    cur = {}
    real = jblocks.attn_cached, jblocks.attn_full, jblocks.moe_apply

    def attn_cached(p, cfg, h, cache, length, **kw):
        b, k = h.shape[:2]
        cur["layer"] = kw["layer_idx"]
        cur["pos"] = (jnp.broadcast_to(jnp.asarray(length, jnp.int32), (b,))
                      [:, None] + jnp.arange(k, dtype=jnp.int32))
        return real[0](p, cfg, h, cache, length, **kw)

    def attn_full(p, cfg, h, *, layer_idx=0, positions=None, **kw):
        b, s = h.shape[:2]
        pos = jnp.arange(s, dtype=jnp.int32) if positions is None else positions
        cur["layer"], cur["pos"] = layer_idx, jnp.broadcast_to(pos, (b, s))
        return real[1](p, cfg, h, layer_idx=layer_idx, positions=positions,
                       **kw)

    def moe_apply(p, cfg, x, *, full_capacity=False):
        logits = x.astype(jnp.float32) @ p["router"]["w"].astype(jnp.float32)
        layer = cur["layer"]
        jax.debug.callback(lambda pos, lg: records.append(
            (layer, np.asarray(pos), np.asarray(lg))), cur["pos"], logits)
        return real[2](p, cfg, x, full_capacity=full_capacity)

    jblocks.attn_cached, jblocks.attn_full, jblocks.moe_apply = (
        attn_cached, attn_full, moe_apply)
    try:
        yield
    finally:
        jax.effects_barrier()
        jblocks.attn_cached, jblocks.attn_full, jblocks.moe_apply = real


@contextlib.contextmanager
def port_routing(records):
    tmoe.ROUTER_TRACE = lambda layer, pos, logits: records.append(
        (layer, pos.numpy(), logits.numpy()))
    try:
        yield
    finally:
        tmoe.ROUTER_TRACE = None


def final_routing(records, row):
    """{(position, layer): router logits} of ``row``, each from the last
    forward that computed the position (the one starting latest)."""
    out = {}
    for layer, pos, logits in records:
        start = int(pos[row, 0])
        for j, q in enumerate(pos[row].tolist()):
            if (q, layer) not in out or out[(q, layer)][0] <= start:
                out[(q, layer)] = (start, logits[row, j])
    return {key: val[1] for key, val in out.items()}


def router_gap(logits, k: int) -> float:
    p = np.exp(logits - logits.max())
    p = np.sort(p / p.sum())[::-1]
    return float((p[k - 1] - p[k]) / p[k - 1])


def first_routing_difference(a, b, end: int, cfg):
    """The first (position, layer), positions 0..end-1, at which the chosen
    expert sets differ, with the larger of the two sides' router gaps."""
    k = cfg.num_experts_per_tok
    for q in range(end):
        for layer in range(cfg.num_layers):
            la, lb = a[(q, layer)], b[(q, layer)]
            top_a = set(np.argsort(-la, kind="stable")[:k].tolist())
            top_b = set(np.argsort(-lb, kind="stable")[:k].tolist())
            if top_a != top_b:
                return q, layer, max(router_gap(la, k), router_gap(lb, k))
    return None


def _rows(toks, stats):
    n = np.asarray(stats["text_len"])
    t = np.asarray(toks)
    return [t[r, :n[r]].tolist() for r in range(len(n))]


def _reference_gap(jp, jcfg, prefix) -> tuple:
    """(top-2 gap, top logit) of the reference's p_1 after ``prefix``: its
    full forward at full capacity, in the config's compute dtype."""
    toks = jnp.asarray(np.asarray(prefix, np.int32)[None])
    h = jmodel.forward_hidden(jp, jcfg, jmodel.embed_inputs(
        jp, jcfg, {"tokens": toks}), moe_full_capacity=True)[0]
    logits = np.asarray(jmodel.base_logits(jp, jcfg, h)[0, -1]
                        .astype(jnp.float32))[:jcfg.vocab_size]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0]), float(top2[1])


@pytest.mark.parametrize("fn", ["greedy_decode", "bpd_decode"])
def test_bf16_decode_agrees_with_reference_up_to_near_ties(bf16_pair, fn,
                                                           capsys):
    jcfg, tcfg, jp, tp, prompt = bf16_pair
    kw = dict(max_new_tokens=MAX_NEW, block_k=K)
    jrec, trec = [], []
    with reference_routing(jrec):
        jt, js = getattr(jdecode, fn)(jp, jcfg, jconfig.DecodeConfig(**kw),
                                      {"tokens": jnp.asarray(prompt)})
    with port_routing(trec):
        tt, ts = getattr(tdecode, fn)(tp, tcfg, DecodeConfig(**kw),
                                      {"tokens": torch.tensor(prompt)})
    assert tt.dtype == torch.int32 and jrec and trec
    kinds = []
    for r, (want, got) in enumerate(zip(_rows(jt, js),
                                        _rows(tt.numpy(), ts))):
        at = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                  None)
        if at is None:
            assert got == want, r
            continue
        assert at >= PROMPT and got[:at] == want[:at], r
        gap, top = _reference_gap(jp, jcfg, want[:at])
        if gap <= TIE_ULPS * bf16_ulp(top):
            kinds.append(f"row {r} at {at}: logit near-tie, "
                         f"{gap / bf16_ulp(top):.1f} ulps")
            continue
        flip = first_routing_difference(final_routing(jrec, r),
                                        final_routing(trec, r), at, tcfg)
        assert flip is not None and flip[2] <= ROUTER_TIE, (
            f"row {r} leaves the reference at position {at} where its top-2 "
            f"gap is {gap / bf16_ulp(top):.1f} bf16 ulps of {top}, and the "
            f"first routing difference before it is {flip}")
        kinds.append(f"row {r} at {at}: router near-tie at position "
                     f"{flip[0]}, layer {flip[1]}, gap {flip[2]:.4g}")
    with capsys.disabled():
        print(f"\n  {jcfg.name} {fn}: {kinds or 'every row equal'}")
