"""The port's decode loop against the JAX reference, in fp32 on the CPU
(``conftest.tiny_dense``, weights carried across by ``bridge``): BPD and
greedy tokens and counters, one hand-made BPD iteration, the checkpoint
bridge, import hygiene and the device default."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

torch.set_num_threads(2)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
B, PROMPT, MAX_NEW, K = 3, 6, 12, 4


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                               (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _decode_both(setup, *, eos=-1, rows=None, fused=False):
    """(reference, port) results of BPD and greedy: tokens up to each
    row's text_len, plus the counters."""
    jcfg, tcfg, jp, tp, prompt = setup
    kw = dict(max_new_tokens=MAX_NEW, block_k=K, eos_id=eos, fused_verify=fused)
    jdec, tdec = JDecodeConfig(**kw), DecodeConfig(**kw)
    jb, tb = {"tokens": jnp.asarray(prompt)}, {"tokens": torch.tensor(prompt)}
    jr = {"bpd": jdecode.bpd_decode(jp, jcfg, jdec, jb, max_new_rows=rows)}
    tr = {"bpd": tdecode.bpd_decode(tp, tcfg, tdec, tb, max_new_rows=rows)}
    if rows is None:
        jr["greedy"] = jdecode.greedy_decode(jp, jcfg, jdec, jb)
        tr["greedy"] = tdecode.greedy_decode(tp, tcfg, tdec, tb)
    return jr, tr


@pytest.fixture(scope="module")
def plain(setup):
    """The default decode in both packages, shared by the tests below."""
    return _decode_both(setup)


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
    np.testing.assert_array_equal(ts["generated"].numpy(), np.asarray(js["generated"]))
    np.testing.assert_allclose(ts["mean_accepted"], float(js["mean_accepted"]),
                               rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_matches_reference(setup, plain, fused):
    jr, tr = _decode_both(setup, fused=True) if fused else plain
    _check_same(jr["bpd"], tr["bpd"])
    _check_same(jr["greedy"], tr["greedy"])
    # the paper's guarantee, in the port: BPD emits greedy's tokens
    assert _rows(*tr["bpd"]) == _rows(*tr["greedy"])


def test_decode_with_eos_matches_reference(setup, plain):
    _, tr = plain
    eos = _rows(*tr["greedy"])[0][PROMPT + 3]          # a token greedy emits
    jr, tr = _decode_both(setup, eos=eos)
    _check_same(jr["bpd"], tr["bpd"])
    _check_same(jr["greedy"], tr["greedy"])
    assert _rows(*tr["bpd"]) == _rows(*tr["greedy"])
    assert len(_rows(*tr["bpd"])[0]) == PROMPT + 4     # stopped at the EOS


def test_decode_with_max_new_rows_matches_reference(setup):
    rows = np.asarray([MAX_NEW, 5, 8], np.int32)
    jr, tr = _decode_both(setup, rows=rows)
    _check_same(jr["bpd"], tr["bpd"])
    np.testing.assert_array_equal(tr["bpd"][1]["generated"].numpy(), rows)


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (5, 2), (8, 3)])
def test_port_bpd_equals_greedy(k, seed):
    """Any block size: BPD with exact acceptance emits greedy's tokens."""
    cfg = ModelConfig(name="t", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=97, bpd_k=8,
                      dtype="float32")
    params = tmodel.init(cfg, seed=seed, device="cpu")
    prompt = torch.randint(0, 97, (4, 5), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(seed))
    dec = DecodeConfig(max_new_tokens=10, block_k=k)
    bt, bs = tdecode.bpd_decode(params, cfg, dec, {"tokens": prompt})
    gt, gs = tdecode.greedy_decode(params, cfg, dec, {"tokens": prompt})
    assert _rows(bt.numpy(), bs) == _rows(gt.numpy(), gs)
    assert bs["iterations"] <= 10 and bs["mean_accepted"] >= 1.0


# ---------------------------------------------------------------------------
# one hand-made iteration: multi-token accepts and their rollback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corrupt", [None, 1, 2, 3])
def test_iteration_with_handmade_proposals(setup, plain, corrupt):
    """From the prefill state, propose greedy's own continuation (k̂ = k),
    or corrupt slot j of it (k̂ = j); both packages agree on everything."""
    jcfg, tcfg, jp, tp, prompt = setup
    dec_kw = dict(max_new_tokens=MAX_NEW, block_k=K)
    jdec, tdec = JDecodeConfig(**dec_kw), DecodeConfig(**dec_kw)
    _, tr = plain
    greedy = np.asarray([r[PROMPT:PROMPT + K] for r in _rows(*tr["greedy"])],
                        np.int32)
    props = greedy.copy()
    if corrupt is not None:
        props[:, corrupt] = (props[:, corrupt] + 1) % jcfg.vocab_size
    js, _ = jdecode.bpd_prefill_causal_lm(jp, jcfg, jdec,
                                          {"tokens": jnp.asarray(prompt)},
                                          max_new=MAX_NEW)
    ts, _ = tdecode.bpd_prefill_causal_lm(tp, tcfg, tdec,
                                          {"tokens": torch.tensor(prompt)},
                                          max_new=MAX_NEW)
    np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
    assert ts.proposals[:, 0].tolist() == greedy[:, 0].tolist()
    js = js._replace(proposals=jnp.asarray(props))
    ts = ts._replace(proposals=torch.tensor(props))
    js = jdecode.bpd_iteration(jp, jcfg, jdec, jdecode.causal_lm_backend(jcfg),
                               js, prefix_offset=0, max_new=MAX_NEW)
    ts = tdecode.bpd_iteration(tp, tcfg, tdec, tdecode.causal_lm_backend(tcfg),
                               ts, prefix_offset=0, max_new=MAX_NEW)
    khat = K if corrupt is None else corrupt
    assert ts.text_len.tolist() == [PROMPT + khat] * B
    np.testing.assert_array_equal(ts.text_len.numpy(), np.asarray(js.text_len))
    np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
    np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
    np.testing.assert_array_equal(ts.generated.numpy(), np.asarray(js.generated))
    for tc, jc in zip(ts.caches, js.caches):
        np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                      np.asarray(jc["attn"]["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["attn"][name].numpy(),
                                       np.asarray(jc["attn"][name]),
                                       rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# bridge, imports, device default, what is not ported
# ---------------------------------------------------------------------------


def test_bridge_checkpoint_round_trip(setup, tmp_path):
    from repro.checkpoint import save

    jcfg, tcfg, jp, tp, _ = setup
    save(str(tmp_path), 7, jp, extra={"arch": "tiny"})
    loaded = bridge.load_checkpoint(str(tmp_path), tcfg, device="cpu")
    want = tp.state_dict()
    got = loaded.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "             or n == 'repro')\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "granite-3-8b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init(ModelConfig())


def test_serve_static_path_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "granite-3-8b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "8", "--max-new", "6"])
    printed = capsys.readouterr().out
    assert "mean accepted block size" in printed and "invocations" in printed
    gt, gs = tdecode.greedy_decode(out["params"], out["cfg"], out["dec"],
                                   out["batch"])
    assert _rows(out["tokens"].numpy(), out["stats"]) == _rows(gt.numpy(), gs)


UNSERVED = {   # argv -> why the launcher refuses it before any rank starts
    ("--engine", "--mesh-data", "2", "--batch", "2", "--arch",
     "paper-mt-base", "--policy", "input_copy"): "decoder-only",
    ("--http", "--mesh-model", "2", "--arch", "llava-next-34b"): "text-only",
    ("--engine", "--mesh-pod", "2", "--arch", "rwkv6-1.6b"): "attention-cache",
}


@pytest.mark.parametrize("argv", [list(a) for a in UNSERVED])
def test_unported_serving_options_raise(argv):
    """The engine, the HTTP server and the pod axis serve under a mesh what
    they serve on one device, every policy and draft_model's bundles
    included; what the engine refuses there (the encoder-decoder, llava's
    per-request patches, the recurrent families) it refuses under a mesh
    before any rank starts, in the same words."""
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match=UNSERVED[tuple(argv)]):
        serve.main(["--arch", "granite-3-8b", "--device", "cpu", "--max-new",
                    "2", "--batch", "1", "--prompt-len", "4", *argv])


@pytest.mark.parametrize("argv", [["--mesh-data", "2"], ["--mesh-model", "2"]])
def test_serve_static_mesh_on_cpu(argv, capfd):
    """The static batch on a mesh of 2 spawned CPU ranks prints the rows
    the single-device launcher prints."""
    from repro_torch.launch import serve

    base = ["--arch", "granite-3-8b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--max-new", "6"]
    out = serve.main(base + argv)
    meshed = capfd.readouterr().out
    one = serve.main(base)
    single = capfd.readouterr().out

    def rows(text):
        return [ln for ln in text.splitlines() if ln.startswith("    row ")]

    assert "backend gloo" in meshed and len(out["ranks"]) == 2
    assert rows(meshed) == rows(single) and len(rows(single)) == 2
    assert _rows(out["tokens"].numpy(), out["stats"]) == _rows(
        one["tokens"].numpy(), one["stats"])


@pytest.mark.parametrize("policy", ["input_copy"])
def test_serve_seq2seq_on_a_model_mesh(policy, capfd):
    """``--arch paper-mt-base --policy input_copy`` over a (1, 2) mesh of
    spawned CPU ranks (both stacks' heads and the cross attention split,
    the sources' rows shared): the rows, tokens and counts of the
    single-device launcher."""
    from repro_torch.launch import serve

    base = ["--arch", "paper-mt-base", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--max-new", "10", "--policy", policy]
    out = serve.main(base + ["--mesh-model", "2"])
    meshed = capfd.readouterr().out
    one = serve.main(base)
    single = capfd.readouterr().out

    def rows(text):
        return [ln for ln in text.splitlines() if ln.startswith("    row ")]

    assert "backend gloo" in meshed and len(out["ranks"]) == 2
    assert rows(meshed) == rows(single) and len(rows(single)) == 2
    assert torch.equal(out["tokens"], one["tokens"])
    for key in ("generated", "text_len"):
        assert torch.equal(out["stats"][key], one["stats"][key])
    assert out["stats"]["iterations"] == one["stats"]["iterations"]


@pytest.mark.parametrize("arch,argv", [("olmoe-1b-7b", ["--engine"]),
                                       ("qwen2-moe-a2.7b", []),
                                       ("rwkv6-1.6b", []),
                                       ("hymba-1.5b", [])])
def test_serve_families_on_a_model_mesh(arch, argv, capfd):
    """The MoE, RWKV-6 and Hymba families on a ``model`` mesh of 2 spawned
    CPU ranks (experts, wkv heads, Mamba channels split): the static
    batch prints the single-device launcher's rows, and olmoe's engine
    finishes its requests with the single-device engine's tokens."""
    from repro_torch.launch import serve

    base = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--max-new", "6", *argv]
    out = serve.main(base + ["--mesh-model", "2"])
    meshed = capfd.readouterr().out
    one = serve.main(base)
    single = capfd.readouterr().out
    assert "backend gloo" in meshed and len(out["ranks"]) == 2
    if "--engine" in argv:
        done = [sorted((f.rid, f.tokens.tolist()) for f in r["finished"])
                for r in out["ranks"]]
        want = sorted((f.rid, f.tokens.tolist()) for f in one["finished"])
        assert done == [want, want] and len(want) == 4
        return

    def rows(text):
        return [ln for ln in text.splitlines() if ln.startswith("    row ")]

    assert rows(meshed) == rows(single) and len(rows(single)) == 2


def test_exact_resolves_and_unported_policies_raise():
    pol = tpolicy.resolve_policy(DecodeConfig())
    assert pol.name == "exact" and isinstance(pol.drafter, tpolicy.HeadsDrafter)
    assert tpolicy.resolve_policy(DecodeConfig(fused_verify=True)).acceptor.fused
    # every policy the reference registers is ported: draft_model resolves,
    # unbound until a session binds its draft bundle
    pol = tpolicy.resolve_policy(DecodeConfig(policy="draft_model"))
    assert pol.name == "draft_model" and pol.drafter.cfg is None
    with pytest.raises(ValueError, match="unknown decode policy"):
        tpolicy.resolve_policy(DecodeConfig(policy="no_such_policy"))


def test_serve_ckpt_dir_single_and_mesh(tmp_path, capfd):
    """``--ckpt-dir`` serves the restored weights, on one device and on a
    ``model`` mesh of 2 spawned CPU ranks, with equal rows, and those rows
    are greedy's on the saved weights."""
    from repro_torch.checkpoint import ckpt as tckpt
    from repro_torch.config import get_config
    from repro_torch.launch import serve

    cfg = get_config("granite-3-8b", smoke=True).replace(dtype="float32")
    saved = tmodel.init(cfg.replace(param_dtype="float32"), seed=11,
                        device="cpu")
    tckpt.save(str(tmp_path), 3, saved)
    base = ["--arch", "granite-3-8b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--max-new", "6", "--ckpt-dir", str(tmp_path)]
    one = serve.main(base)
    single = capfd.readouterr().out
    out = serve.main(base + ["--mesh-model", "2"])
    meshed = capfd.readouterr().out

    def rows(text):
        return [ln for ln in text.splitlines() if ln.startswith("    row ")]

    assert f"restored {tmp_path}" in single and f"restored {tmp_path}" in meshed
    assert rows(meshed) == rows(single) and len(rows(single)) == 2
    assert _rows(out["tokens"].numpy(), out["stats"]) == _rows(
        one["tokens"].numpy(), one["stats"])
    gt, gs = tdecode.greedy_decode(saved, one["cfg"], one["dec"], one["batch"])
    assert _rows(one["tokens"].numpy(), one["stats"]) == _rows(gt.numpy(), gs)
