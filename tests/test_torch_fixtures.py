"""The pinned trained fixtures, decoded by the reference and by the port on
the CPU, against their ``reference.json``:

- ``tests/data/quickstart`` (``tools/make_quickstart_fixture.py``):
  ``examples/quickstart.py``'s model (d 96 over 4 heads of 24), its 8
  prompts as one batch, greedy and BPD exact, 48 new tokens;
- ``tests/data/locality`` (``tools/make_locality_fixture.py``): the two
  image-decoding arms of ``benchmarks/policy_sweep.run_locality``, each
  of 8 fields decoded alone under ``locality``, ``locality_exact`` and
  ``locality_raster``.

Each fixture's config is the one its tool's recipe makes (the training,
skipped here, does not change it), and its inputs are the ones the recipe
draws.  Tokens, iterations and generated counts must be equal; k̂,
iterations per token and MAE are computed from them, k̂ to float32's
rounding for the batch decode (the reference computes it in float32)."""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.data.synthetic import OrdinalField as JOrdinalField  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.data.synthetic import OrdinalField  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICKSTART = os.path.join(ROOT, "tests", "data", "quickstart")
LOCALITY = os.path.join(ROOT, "tests", "data", "locality")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _config(module, path):
    with open(os.path.join(path, "config.json")) as f:
        fields = json.load(f)
    fields["global_attn_layers"] = tuple(fields["global_attn_layers"])
    return module.ModelConfig(**fields)


def _reference(path):
    with open(os.path.join(path, "reference.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_fixture_is_quickstarts():
    """config.json is quickstart's config and prompts.npy its prompts."""
    tool = _tool("make_quickstart_fixture")
    assert (dataclasses.asdict(_config(jconfig, QUICKSTART))
            == dataclasses.asdict(tool.quickstart_config()))
    assert tool.quickstart_config().resolved_head_dim == 24
    np.testing.assert_array_equal(np.load(os.path.join(QUICKSTART,
                                                       "prompts.npy")),
                                  tool.prompts())


def test_quickstart_reference_reproduces_reference_json():
    tool = _tool("make_quickstart_fixture")
    cfg = _config(jconfig, QUICKSTART)
    template = jmodel.init(jax.random.PRNGKey(0), cfg)
    params, _ = jckpt.restore(os.path.join(QUICKSTART, "checkpoint"), template)
    prompts = np.load(os.path.join(QUICKSTART, "prompts.npy"))
    assert tool.reference_decode(params, cfg, prompts) == _reference(QUICKSTART)


def test_quickstart_port_reproduces_reference_json():
    """The port's greedy and BPD exact of the batch: tokens, iterations,
    invocations and generated counts equal, k̂ to float32's rounding; BPD
    emits greedy's tokens in fewer invocations."""
    ref = _reference(QUICKSTART)
    cfg = _config(tconfig, QUICKSTART)
    params = bridge.load_checkpoint(os.path.join(QUICKSTART, "checkpoint"),
                                    cfg, device="cpu")
    prompts = torch.as_tensor(np.load(os.path.join(QUICKSTART, "prompts.npy")))
    n = len(ref["bpd"]["tokens"][0])
    dec = tconfig.DecodeConfig(max_new_tokens=n - prompts.shape[1],
                               block_k=cfg.bpd_k, criterion="exact")
    for name, run in (("bpd", tdecode.bpd_decode),
                      ("greedy", tdecode.greedy_decode)):
        toks, stats = run(params, cfg, dec, {"tokens": prompts})
        want = ref[name]
        assert toks[:, :n].tolist() == want["tokens"], name
        assert stats["iterations"] == want["iterations"]
        assert stats["invocations"] == want["invocations"]
        assert stats["generated"].tolist() == want["generated"]
        assert stats["mean_accepted"] == pytest.approx(want["mean_accepted"],
                                                       rel=1e-6)
    assert ref["bpd"]["tokens"] == ref["greedy"]["tokens"]
    assert ref["bpd"]["mean_accepted"] > 1.5
    assert ref["bpd"]["invocations"] < ref["greedy"]["invocations"]


# ---------------------------------------------------------------------------
# locality
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loc_tool():
    return _tool("make_locality_fixture")


@pytest.mark.parametrize("arm", ["locality", "raster"])
def test_locality_fixture_is_run_localitys(loc_tool, arm, monkeypatch):
    """Each arm's config.json is ``_train_field_model``'s config (the
    training skipped), and grids.npy the fields ``run_locality`` draws."""
    ps = loc_tool.ps
    monkeypatch.setattr(ps, "train_steps",
                        lambda cfg, tc, params, *a, **kw: (params, 0.0))
    field, cfg, _ = ps._train_field_model(arm, pretrain_steps=1, head_steps=1)
    assert (dataclasses.asdict(_config(jconfig, os.path.join(LOCALITY, arm)))
            == dataclasses.asdict(cfg))
    grids = np.load(os.path.join(LOCALITY, "grids.npy"))
    np.testing.assert_array_equal(grids, loc_tool.eval_grids(field))
    port_field = OrdinalField(levels=cfg.vocab_size, height=ps.LOC_H,
                              width=ps.LOC_W, n_waves=2, stride=ps.LOC_STRIDE,
                              order=arm, bilinear=True)
    np.testing.assert_array_equal(
        port_field.sample_grid(np.random.default_rng(42), grids.shape[0]), grids)


def _arm(module, arm):
    cfg = _config(module, os.path.join(LOCALITY, arm))
    ckpt = os.path.join(LOCALITY, arm, "checkpoint")
    if module is jconfig:
        template = jmodel.init(jax.random.PRNGKey(0), cfg)
        return cfg, jckpt.restore(ckpt, template)[0]
    return cfg, bridge.load_checkpoint(ckpt, cfg, device="cpu")


@pytest.mark.parametrize("name", ["locality", "locality_exact",
                                  "locality_raster"])
def test_locality_reference_reproduces_reference_json(loc_tool, name):
    arm, policy = loc_tool.ROWS[name]
    cfg, params = _arm(jconfig, arm)
    field = JOrdinalField(levels=cfg.vocab_size, height=8, width=8, n_waves=2,
                          stride=2, order=arm, bilinear=True)
    grids = np.load(os.path.join(LOCALITY, "grids.npy"))
    assert (loc_tool.reference_decode(field, cfg, params, policy, grids)
            == _reference(LOCALITY)[name])


@pytest.mark.parametrize("name", ["locality", "locality_exact",
                                  "locality_raster"])
def test_locality_port_reproduces_reference_json(loc_tool, name):
    """Each row decoded alone by the port from its coarse prompt: tokens,
    iterations and generated counts equal; iterations per token, k̂ and MAE
    equal."""
    ref = _reference(LOCALITY)
    arm, policy = loc_tool.ROWS[name]
    cfg, params = _arm(tconfig, arm)
    grids = np.load(os.path.join(LOCALITY, "grids.npy"))
    field = OrdinalField(levels=cfg.vocab_size, height=grids.shape[1],
                         width=grids.shape[2], n_waves=2, stride=2,
                         order=arm, bilinear=True)
    stream = field.serialize(grids)
    start, n = field.coarse_len, stream.shape[1]
    dec = tconfig.DecodeConfig(max_new_tokens=n - start, block_k=cfg.bpd_k,
                               policy=policy, image_height=grids.shape[1],
                               image_width=grids.shape[2], locality_stride=2)
    rows = []
    for r in range(grids.shape[0]):
        toks, stats = tdecode.bpd_decode(
            params, cfg, dec, {"tokens": torch.as_tensor(stream[r:r + 1, :start])})
        rows.append({"tokens": toks[0, :n].tolist(),
                     "iterations": stats["iterations"],
                     "generated": int(stats["generated"].sum())})
    want = ref[name]
    assert rows == want["rows"]
    iters = sum(r["iterations"] for r in rows)
    gen = sum(r["generated"] for r in rows)
    mae = float(np.abs(field.to_grid(np.asarray([r["tokens"] for r in rows]))
                       .astype(int) - grids.astype(int)).mean())
    assert (iters / gen, gen / iters, mae) == (want["iters_per_token"],
                                               want["mean_khat"], want["mae"])


def test_locality_fixture_shows_the_effect():
    """reference.json: locality emits locality_exact's tokens, in fewer
    iterations than the raster twin, at a lower MAE."""
    ref = _reference(LOCALITY)
    assert ([r["tokens"] for r in ref["locality"]["rows"]]
            == [r["tokens"] for r in ref["locality_exact"]["rows"]])
    its = {k: sum(r["iterations"] for r in v["rows"]) for k, v in ref.items()}
    assert its["locality"] < its["locality_raster"]
    assert ref["locality"]["mae"] < ref["locality_raster"]["mae"]
