"""The pinned draft-model fixture (``tests/data/draft_model``, written by
``tools/make_draft_fixture.py`` from the committed policy-sweep teacher):
the gold-prefix and the scheduled-sampling student, and the reference's
decode of the sweep's 16 source rows with each as the ``draft_model``
drafter.  The reference reproduces its own ``reference.json`` from the
committed checkpoints, and so does the port on the CPU, row by row at B 1:
tokens, iterations, generated counts, k̂ and the draft's sequential
forwards per iteration."""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import ModelBundle  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "draft_model")
TEACHER = os.path.join(ROOT, "tests", "data", "policy_sweep")
ROWS = {"draft_model": "gold", "ss_draft_model": "ss"}   # row -> student


def _config(module, path):
    with open(os.path.join(path, "config.json")) as f:
        fields = json.load(f)
    fields["global_attn_layers"] = tuple(fields["global_attn_layers"])
    return module.ModelConfig(**fields)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_draft_fixture", os.path.join(ROOT, "tools", "make_draft_fixture.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def fixture():
    """(reference.json, src (16, 24) int32)."""
    with open(os.path.join(FIXTURE, "reference.json")) as f:
        ref = json.load(f)
    return ref, np.load(os.path.join(TEACHER, "src.npy"))


def test_fixture_config_is_the_sweep_student():
    """config.json is, field for field, ``policy_sweep``'s student config;
    the two students share it and ``reference.json`` has both rows with
    the carry-over's forward counts."""
    tool = _tool()
    assert dataclasses.asdict(_config(jconfig, FIXTURE)) == \
        dataclasses.asdict(tool.policy_sweep._draft_config())
    with open(os.path.join(FIXTURE, "reference.json")) as f:
        ref = json.load(f)
    assert sorted(ref) == sorted(ROWS)
    for row in ROWS:
        assert ref[row]["draft_steps_per_iter"] == 7.0
        assert ref[row]["draft_steps_saved"] == 1.0
        assert len(ref[row]["rows"]) == 16


@pytest.mark.parametrize("row", sorted(ROWS))
def test_reference_reproduces_reference_json(fixture, row):
    """The JAX reference decoding the committed teacher with the committed
    student, as the fixture tool decodes it, gives ``reference.json``."""
    ref, src = fixture
    tool = _tool()
    cfg, params = tool.load_teacher()
    dcfg = _config(jconfig, FIXTURE)
    template = jmodel.init(jax.random.PRNGKey(0), dcfg)
    dparams, _ = jckpt.restore(os.path.join(FIXTURE, ROWS[row]), template)
    assert tool.reference_decode(params, cfg, dcfg, dparams, src) == ref[row]


@pytest.mark.parametrize("row", sorted(ROWS))
def test_port_reproduces_reference_json(fixture, row):
    """The port on the CPU, each row alone at B 1 through one
    ``DecodeSession`` with the student as its ``draft`` bundle: rows,
    mean k̂ and forward counts equal ``reference.json``'s, and the tokens
    are ``exact``'s (the sweep fixture's)."""
    ref, src = fixture
    cfg = _config(tconfig, TEACHER)
    params = bridge.load_checkpoint(os.path.join(TEACHER, "checkpoint"), cfg,
                                    device="cpu")
    dcfg = _config(tconfig, FIXTURE)
    dparams = bridge.load_checkpoint(os.path.join(FIXTURE, ROWS[row]), dcfg,
                                     device="cpu")
    dec = tconfig.DecodeConfig(max_new_tokens=src.shape[1], block_k=8,
                               policy="draft_model")
    sess = tserving.DecodeSession(params, cfg, dec,
                                  bundles={"draft": ModelBundle(dparams, dcfg)})
    rows = []
    for r in range(src.shape[0]):
        toks, stats = sess.decode_seq2seq({"src": torch.tensor(src[r:r + 1])})
        rows.append({"tokens": toks[0, :src.shape[1]].tolist(),
                     "iterations": stats["iterations"],
                     "generated": int(stats["generated"][0])})
    assert rows == ref[row]["rows"]
    khat = float(np.mean([r["generated"] / max(r["iterations"], 1)
                          for r in rows]))
    assert khat == ref[row]["mean_khat"]
    steps = sess.policy.drafter.draft_steps_per_iter(8)
    assert (float(steps), float(8 - steps)) == (
        ref[row]["draft_steps_per_iter"], ref[row]["draft_steps_saved"])
    with open(os.path.join(TEACHER, "reference.json")) as f:
        exact = json.load(f)["exact"]["rows"]
    assert [r["tokens"] for r in rows] == [r["tokens"] for r in exact]


def test_fixture_stays_small():
    """The committed fixture stays under 1 MB."""
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(FIXTURE) for f in files)
    assert size < 2 ** 20, size

