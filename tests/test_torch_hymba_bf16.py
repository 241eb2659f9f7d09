"""bf16 decodes of the port's Hymba family against the JAX reference's, on
the CPU, on the same bridged weights: hymba-1.5b's smoke config (d 160, 5
heads of 32, 4 meta tokens, a window of 32 on layer 1) and
``conftest.tiny_hymba``, each cast for bf16 compute (the port's
``cast_for_compute``, which keeps Mamba's A_log and D in fp32 as the
reference reads them; the reference casts at use).  Prompts of 40 tokens
cross the window.

The two frameworks round bf16 at other places, so a row may leave the
reference's tokens where the reference's own p_1 has a near-tie.  Each row
is held to two things: the tokens before its first divergence are the
reference's, and at that divergence the reference's top-2 gap (its full
forward over the row's prefix, in bf16) is within TIE_ULPS bf16 ulps of
its top logit, as ``test_torch_families_bf16.py`` holds the dense
families.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_hymba  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_families_bf16 import TIE_ULPS, bf16_ulp  # noqa: E402

torch.set_num_threads(2)
B, PROMPT, MAX_NEW, K = 4, 40, 16, 4
CONFIGS = {
    "hymba-1.5b smoke": lambda: jconfig.get_config("hymba-1.5b", smoke=True),
    "tiny-hymba": tiny_hymba,
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def bf16_pair(request):
    jcfg = CONFIGS[request.param]().replace(dtype="bfloat16")
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    tmodel.cast_for_compute(tp, tcfg)
    assert tp["blocks"][0]["mamba"]["A_log"].dtype == torch.float32
    assert tp["blocks"][0]["mamba"]["in_proj"]["w"].dtype == torch.bfloat16
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _rows(toks, stats):
    n = np.asarray(stats["text_len"])
    t = np.asarray(toks)
    return [t[r, :n[r]].tolist() for r in range(len(n))]


def _reference_gap(jp, jcfg, prefix) -> tuple:
    """(top-2 gap, top logit) of the reference's p_1 after ``prefix``, its
    full forward (meta tokens first) in the config's compute dtype."""
    toks = jnp.asarray(np.asarray(prefix, np.int32)[None])
    h = jmodel.forward_hidden(jp, jcfg, jmodel.embed_inputs(
        jp, jcfg, {"tokens": toks}))[0]
    logits = np.asarray(jmodel.base_logits(jp, jcfg, h)[0, -1]
                        .astype(jnp.float32))[:jcfg.vocab_size]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0]), float(top2[1])


@pytest.mark.parametrize("fn,backend", [("greedy_decode", "dense"),
                                        ("bpd_decode", "dense"),
                                        ("bpd_decode", "paged")])
def test_bf16_decode_agrees_with_reference_up_to_near_ties(bf16_pair, fn,
                                                           backend):
    jcfg, tcfg, jp, tp, prompt = bf16_pair
    kw = dict(max_new_tokens=MAX_NEW, block_k=K, cache_backend=backend,
              page_size=8)
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
