"""bf16 decodes of the port against the JAX reference's, on the CPU, on the
same bridged weights: stablelm-12b's narrow geometry (head_dim 160 over 4 /
1 heads, ``qk_norm``) and granite-3-8b's smoke config, each cast for bf16
compute (the port's ``cast_for_compute``; the reference casts at use).

The two frameworks round bf16 at other places, so a row may leave the
reference's tokens where the reference's own p_1 has a near-tie.  The test
holds each row to two things: the tokens before its first divergence are
the reference's, and at that divergence the reference's top-2 gap (its
full forward over the row's prefix, in bf16) is within TIE_ULPS bf16 ulps
of its top logit.  A divergence at a wider gap would be a fault of the
port, not a rounding.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

torch.set_num_threads(2)
TIE_ULPS = 4
B, PROMPT, MAX_NEW, K = 4, 8, 16, 4
GEOMETRIES = {
    "stablelm-12b": dict(num_heads=4, num_kv_heads=1, head_dim=160),
    "granite-3-8b": {},
}


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def bf16_pair(request):
    name = request.param
    jcfg = jconfig.get_config(name, smoke=True).replace(
        dtype="bfloat16", **GEOMETRIES[name])
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    tmodel.cast_for_compute(tp, tcfg)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _rows(toks, stats):
    n = np.asarray(stats["text_len"])
    t = np.asarray(toks)
    return [t[r, :n[r]].tolist() for r in range(len(n))]


def _reference_gap(jp, jcfg, prefix) -> tuple:
    """(top-2 gap, top logit) of the reference's p_1 after ``prefix``, its
    full forward in the config's compute dtype."""
    toks = jnp.asarray(np.asarray(prefix, np.int32)[None])
    h = jmodel.forward_hidden(jp, jcfg, jmodel.embed_inputs(
        jp, jcfg, {"tokens": toks}))[0]
    logits = np.asarray(jmodel.base_logits(jp, jcfg, h)[0, -1]
                        .astype(jnp.float32))[:jcfg.vocab_size]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0]), float(top2[1])


@pytest.mark.parametrize("fn", ["greedy_decode", "bpd_decode"])
def test_bf16_decode_agrees_with_reference_up_to_near_ties(bf16_pair, fn):
    jcfg, tcfg, jp, tp, prompt = bf16_pair
    kw = dict(max_new_tokens=MAX_NEW, block_k=K)
    jt, js = getattr(jdecode, fn)(jp, jcfg, jconfig.DecodeConfig(**kw),
                                  {"tokens": jnp.asarray(prompt)})
    tt, ts = getattr(tdecode, fn)(tp, tcfg, DecodeConfig(**kw),
                                  {"tokens": torch.tensor(prompt)})
    assert tt.dtype == torch.int32
    for r, (want, got) in enumerate(zip(_rows(jt, js),
                                        _rows(tt.numpy(), ts))):
        at = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                  None)
        if at is None:
            assert got == want, r
            continue
        assert at >= PROMPT and got[:at] == want[:at], r
        gap, top = _reference_gap(jp, jcfg, want[:at])
        assert gap <= TIE_ULPS * bf16_ulp(top), (
            f"row {r} leaves the reference at position {at} where its "
            f"top-2 gap {gap} is {gap / bf16_ulp(top):.1f} bf16 ulps of {top}")
