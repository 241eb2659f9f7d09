"""The port's serving step factories and the twins of the serving and
translation examples, against the JAX reference on the CPU.

``make_prefill_step`` followed by one ``make_serve_step`` for every
decoder-only smoke arch (as ``tests/test_arch_smoke.py`` parametrises
them; weights made by ``repro.models.model.init`` and carried across by
``bridge``): the prefill's proposals, then the iteration's tokens,
text_len, proposals, generated count and iterations equal the
reference's.  The encoder-only prefill step's code logits within 1e-5 of
the reference's (relative, and of the largest absolute).
``materialize_serve_state``'s fields equal the reference's
``serve_state_struct`` in shape and dtype, and one serve step from it
equals the reference's.  ``examples/serve_bpd_torch.py`` (static,
``--continuous``, an RWKV-6 arch, the encoder-only exit) and
``examples/translate_bpd_torch.py`` run with ``--device cpu`` at a few
steps.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.configs import ASSIGNED  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402

torch.set_num_threads(2)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
DECODERS = [a for a in ASSIGNED if not jget_config(a).is_encoder_only
            and not jget_config(a).is_encoder_decoder]
B, PROMPT, MAX_NEW = 2, 16, 8


def _setup(arch, seed=0):
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, seed=1):
    """B prompts of PROMPT tokens; a vision_text model's behind its
    config's patch count of embeddings, so the serve step's prefix (the
    config's) is the prefill's."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)}
    if cfg.modality == "vision_text":
        out["patch_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model))).astype(np.float32)
    return out


def _decs(cfg):
    kw = dict(max_new_tokens=MAX_NEW, block_k=cfg.bpd_k)
    return JDecodeConfig(**kw), DecodeConfig(**kw)


def _same_state(got, want):
    for field in ("tokens", "text_len", "proposals", "generated", "finished"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.iters == int(want.iters)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_serve_step_matches_reference(arch):
    jcfg, jp, tcfg, tp = _setup(arch)
    batch = _batch(jcfg)
    jdec, tdec = _decs(jcfg)
    prefix = jcfg.num_meta_tokens + (jcfg.num_patch_tokens
                                     if jcfg.modality == "vision_text" else 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    jstate = jsteps.make_prefill_step(jcfg, jdec)(jp, jb)
    tstate = tsteps.make_prefill_step(tcfg, tdec)(tp, tb)
    _same_state(tstate, jstate)

    kw = dict(seq_len=PROMPT + prefix, max_new=MAX_NEW)
    jstate = jax.jit(jsteps.make_serve_step(jcfg, jdec, **kw))(jp, jstate)
    tstate = tsteps.make_serve_step(tcfg, tdec, **kw)(tp, tstate)
    _same_state(tstate, jstate)
    assert tstate.iters == 1
    assert bool((tstate.text_len >= PROMPT + 1).all())


def test_encoder_only_prefill_step_matches_reference():
    """hubert-xlarge's smoke config: the code logits of one bidirectional
    encode."""
    jcfg, jp, tcfg, tp = _setup("hubert-xlarge")
    frames = np.random.default_rng(2).standard_normal(
        (B, PROMPT, jcfg.d_model)).astype(np.float32)
    jdec, tdec = _decs(jcfg)
    want = np.asarray(jsteps.make_prefill_step(jcfg, jdec)(
        jp, {"frame_embeds": jnp.asarray(frames)}))
    got = tsteps.make_prefill_step(tcfg, tdec)(
        tp, {"frame_embeds": torch.as_tensor(frames)})
    assert got.shape == want.shape == (B, PROMPT, jcfg.padded_vocab_size)
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _leaves(tree, path=""):
    """{path: leaf} of nested dicts, tuples and lists (NamedTuples by
    field name)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}/{k}"))
    return out


SERVE_STATES = {
    "granite dense": ("granite-3-8b", dict()),
    "granite paged": ("granite-3-8b", dict(cache_backend="paged", page_size=8)),
    "granite adaptive": ("granite-3-8b", dict(policy="adaptive")),
    "rwkv6": ("rwkv6-1.6b", dict()),
    "hymba": ("hymba-1.5b", dict()),
    "olmoe": ("olmoe-1b-7b", dict()),
    "llava": ("llava-next-34b", dict()),
}


@pytest.mark.parametrize("case", sorted(SERVE_STATES))
def test_materialize_serve_state_matches_struct(case):
    """Every field and cache leaf of the zero state has the shape and dtype
    of the reference's ``serve_state_struct``; one serve step from it
    equals the reference's from its own materialized state."""
    arch, kw = SERVE_STATES[case]
    jcfg, jp, tcfg, tp = _setup(arch)
    jdec, tdec = (c.replace(**kw) for c in _decs(jcfg))
    prefix = jcfg.num_meta_tokens + (jcfg.num_patch_tokens
                                     if jcfg.modality == "vision_text" else 0)
    seq_len = PROMPT + prefix
    struct = jsteps.serve_state_struct(jcfg, jdec, batch=B, seq_len=seq_len,
                                       max_new=MAX_NEW)
    state = tsteps.materialize_serve_state(tcfg, tdec, batch=B,
                                           seq_len=seq_len, max_new=MAX_NEW,
                                           device="cpu")
    want = {p: (tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in _leaves(struct).items() if not p.startswith("/iters")}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in _leaves(state).items() if not p.startswith("/iters")}
    assert got == want
    assert state.iters == 0 and int(struct.iters.size) == 1
    assert all(t.device.type == "cpu" for t in _leaves(state).values()
               if isinstance(t, torch.Tensor))

    jstate = jsteps.materialize_serve_state(jcfg, jdec, batch=B,
                                            seq_len=seq_len, max_new=MAX_NEW)
    kw = dict(seq_len=seq_len, max_new=MAX_NEW)
    jout = jax.jit(jsteps.make_serve_step(jcfg, jdec, **kw))(jp, jstate)
    tout = tsteps.make_serve_step(tcfg, tdec, **kw)(tp, state)
    _same_state(tout, jout)


def test_serve_step_runs_under_no_grad():
    """The serve step builds no graph, though the weights of a training
    run require grad."""
    _, _, tcfg, tp = _setup("rwkv6-1.6b")
    for p in tp.parameters():
        p.requires_grad_(True)
    _, tdec = _decs(tcfg)
    state = tsteps.make_prefill_step(tcfg, tdec)(
        tp, {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()})
    state = tsteps.make_serve_step(tcfg, tdec, seq_len=PROMPT,
                                   max_new=MAX_NEW)(tp, state)
    assert all(t.grad_fn is None for t in _leaves(state.caches).values()
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# the example twins
# ---------------------------------------------------------------------------


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["granite-3-8b", "rwkv6-1.6b"])
def test_serve_bpd_twin_static(capsys, arch):
    """A few training steps, then the serve loop: every row ends with its
    budget, and its tokens are greedy's on the same weights."""
    out = _example("serve_bpd_torch").main(
        ["--arch", arch, "--device", "cpu", "--steps", "3", "--batch", "2",
         "--max-new", "6"])
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "per-row outputs" in text
    state, batch, dec = out["state"], out["batch"], out["dec"]
    assert state.generated.tolist() == [6, 6] and out["iterations"] <= 6
    gt, _ = tdecode.greedy_decode(out["params"], out["cfg"], dec, batch)
    n = PROMPT + 6
    assert torch.equal(state.tokens[:, :n], gt[:, :n])


def test_serve_bpd_twin_continuous(capsys):
    """The engine serves twice as many requests as slots; each request's
    tokens are greedy's on its own prompt and budget."""
    out = _example("serve_bpd_torch").main(
        ["--device", "cpu", "--steps", "3", "--batch", "2", "--max-new", "6",
         "--continuous"])
    assert "continuous: 4 requests through 2 slots" in capsys.readouterr().out
    done = {f.rid: f for f in out["finished"]}
    assert sorted(done) == [r.rid for r in out["requests"]]
    for req in out["requests"]:
        prompt = torch.as_tensor(req.prompt)[None]
        gt, _ = tdecode.greedy_decode(out["params"], out["cfg"],
                                      out["dec"].replace(max_new_tokens=req.max_new),
                                      {"tokens": prompt})
        want = gt[0, prompt.shape[1]:prompt.shape[1] + req.max_new].tolist()
        assert [int(x) for x in done[req.rid].tokens] == want, req.rid


def test_serve_bpd_twin_refuses_an_encoder_only_arch():
    with pytest.raises(SystemExit, match="encoder-only: no decode path"):
        _example("serve_bpd_torch").main(["--arch", "hubert-xlarge",
                                          "--device", "cpu"])


def test_translate_bpd_twin(capsys, monkeypatch):
    """The four stages at a few steps each (the quick schedule cut to 4
    pre-training and 4 fine-tuning steps and 2 distilled batches): the
    trace prints a step per iteration, and BPD of the batch emits the
    greedy decode's tokens on the same weights."""
    mod = _example("translate_bpd_torch")
    monkeypatch.setitem(mod.SCHEDULE, "quick", (4, 4, 2))
    out = mod.main(["--quick", "--device", "cpu", "--k", "4"])
    text = capsys.readouterr().out
    for stage in ("[1/4]", "[2/4]", "[3/4]", "[4/4]", "Step 1:", "k̂ ="):
        assert stage in text, stage
    assert f"Step {out['trace_steps']}:" in text
    assert out["trace_tokens"].shape[0] >= mod.TGT_LEN
    gt, _ = tdecode.greedy_decode_seq2seq(out["params"], out["cfg"],
                                          out["dec"], out["batch"])
    assert torch.equal(out["tokens"][:, :mod.TGT_LEN], gt[:, :mod.TGT_LEN])
    assert out["stats"]["mean_accepted"] >= 1.0
