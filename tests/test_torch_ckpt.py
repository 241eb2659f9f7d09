"""Checkpoints both ways between the port and ``repro.checkpoint`` (the same
``step_N/arrays.npz`` + ``meta.msgpack`` layout), the port's own msgpack
bytes against ``msgpack.packb``, rotation and ``latest_step``, and the
train launcher's checkpoints and resume, on the CPU."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense, tiny_seq2seq  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import seq2seq as jseq2seq  # noqa: E402
from repro.utils.tree import flatten_with_names as jflatten  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

torch.set_num_threads(2)

CONFIGS = {"dense": (tiny_dense, jmodel.init), "seq2seq": (tiny_seq2seq, jseq2seq.init)}


def reference(kind):
    make_cfg, init = CONFIGS[kind]
    jcfg = make_cfg()
    return jcfg, init(jax.random.PRNGKey(3), jcfg)


def port_cfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


# ---------------------------------------------------------------------------
# both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_port_checkpoint_restored_by_reference(tmp_path, kind):
    jcfg, jp = reference(kind)
    tp = tmodel.init(port_cfg(jcfg), seed=5, device="cpu")
    path = tckpt.save(str(tmp_path), 7, tp, extra={"arch": jcfg.name, "n": 3})
    assert os.path.basename(path) == "step_00000007"
    assert jckpt.latest_step(str(tmp_path)) == 7
    restored, extra = jckpt.restore(str(tmp_path), jp)
    assert extra == {"arch": jcfg.name, "n": 3}
    got = dict(flatten_with_names(tp))
    for name, arr in jflatten(restored):
        np.testing.assert_array_equal(np.asarray(arr), got[name].numpy(), err_msg=name)
    assert len(got) == len(jflatten(restored))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_reference_checkpoint_restored_by_port(tmp_path, kind):
    jcfg, jp = reference(kind)
    jckpt.save(str(tmp_path), 12, jp, extra={"arch": jcfg.name})
    template = tmodel.init(port_cfg(jcfg), device="cpu")
    restored, extra = tckpt.restore(str(tmp_path), template)
    assert extra == {"arch": jcfg.name}
    assert isinstance(restored, tmodel.ParamTree)
    got = dict(flatten_with_names(restored))
    want = dict(jflatten(jp))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr), err_msg=name)
    # the bridge reads the same files
    loaded = bridge.load_checkpoint(str(tmp_path), port_cfg(jcfg), device="cpu")
    assert all(torch.equal(v, restored.state_dict()[k])
               for k, v in loaded.state_dict().items())


def test_nested_dict_round_trip(tmp_path):
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3)},
            "blocks": [{"x": torch.ones(2)}, {"x": torch.zeros(2, dtype=torch.int32)}]}
    tckpt.save(str(tmp_path), 1, tree)
    restored, extra = tckpt.restore(str(tmp_path), tree)
    assert extra == {}
    assert isinstance(restored["blocks"], list)
    assert torch.equal(restored["a"]["w"], tree["a"]["w"])
    assert restored["blocks"][1]["x"].dtype == torch.int32
    jtree, _ = jckpt.restore(str(tmp_path), jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), tree))
    np.testing.assert_array_equal(np.asarray(jtree["a"]["w"]), tree["a"]["w"].numpy())


def test_restore_refuses_a_mismatched_template(tmp_path):
    tp = tmodel.init(port_cfg(tiny_dense()), device="cpu")
    tckpt.save(str(tmp_path), 1, tp)
    other = tmodel.init(port_cfg(tiny_dense(num_layers=3)), device="cpu")
    with pytest.raises(ValueError, match="missing.*blocks/2/attn/wk"):
        tckpt.restore(str(tmp_path), other)
    wide = tmodel.init(port_cfg(tiny_dense(d_ff=64)), device="cpu")
    with pytest.raises(ValueError, match="wrong shape"):
        tckpt.restore(str(tmp_path), wide)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tp)


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------


METAS = {
    "meta": {"step": 120, "treedef": "ParamTree",
             "keys": ["embed\x1ftable", "blocks\x1f0\x1fattn\x1fwq"],
             "dtypes": {"embed\x1ftable": "float32"}, "extra": {"arch": "granite-3-8b"}},
    "ints": {"v": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                   2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                   -2 ** 31, -2 ** 31 - 1, -2 ** 63]},
    "strings": {"s": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 70000,
                      "ünïcødé"]},
    "containers": {"list16": list(range(16)), "list15": list(range(15)),
                   "map16": {str(i): i for i in range(16)},
                   "big": list(range(70000)), "nested": [[{}], []]},
    "scalars": {"t": True, "f": False, "n": None, "x": 1.5, "y": -2.25e-300,
                "tuple": (1, "a")},
}


@pytest.mark.parametrize("case", sorted(METAS))
def test_msgpack_bytes_equal_msgpack_packb(case):
    msgpack = pytest.importorskip("msgpack")
    obj = METAS[case]
    assert tckpt.packb(obj) == msgpack.packb(obj)


@pytest.mark.parametrize("case", sorted(METAS))
def test_msgpack_round_trip(case):
    obj = METAS[case]
    want = {k: (list(v) if isinstance(v, tuple) else v) for k, v in obj.items()}
    if case == "scalars":
        want["tuple"] = [1, "a"]
    assert tckpt.unpackb(tckpt.packb(obj)) == want


def test_msgpack_refusals():
    with pytest.raises(TypeError, match="cannot pack"):
        tckpt.packb({"a": object()})
    with pytest.raises(ValueError, match="trailing"):
        tckpt.unpackb(b"\xc0\xc0")
    with pytest.raises(ValueError, match="unsupported"):
        tckpt.unpackb(b"\xc4\x00")


# ---------------------------------------------------------------------------
# rotation, latest_step
# ---------------------------------------------------------------------------


def test_rotation_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d + "/missing") is None
    assert tckpt.latest_step(d) is None
    tree = {"w": torch.zeros(2)}
    for step in (5, 10, 15, 20):
        tree["w"] += 1
        tckpt.save(d, step, tree, keep=2)
    os.makedirs(os.path.join(d, "step_00000099.tmp"))    # a save cut short
    assert sorted(os.listdir(d)) == ["step_00000015", "step_00000020",
                                     "step_00000099.tmp"]
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 20
    restored, _ = tckpt.restore(d, tree, step=15)
    assert float(restored["w"][0]) == 3.0
    tckpt.save(d, 20, {"w": torch.full((2,), 9.0)}, keep=2)     # overwrite
    assert float(tckpt.restore(d, tree)[0]["w"][0]) == 9.0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-8b", "paper-mt-base"])
def test_launcher_checkpoints_and_resumes(tmp_path, capsys, arch):
    d = str(tmp_path / "ck")
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2", "--seq", "16",
            "--log-every", "2", "--ckpt-dir", d, "--ckpt-every", "2"]
    out = tlaunch.main(argv + ["--steps", "3"])
    assert out["start"] == 0 and tckpt.latest_step(d) == 3
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    text = capsys.readouterr().out
    assert "[train] step     2  loss" in text and "tok/s" in text
    restored, extra = tckpt.restore(d, out["params"])
    assert extra == {"arch": arch}
    for (name, a), (_, b) in zip(flatten_with_names(restored),
                                 flatten_with_names(out["params"])):
        assert torch.equal(a, b), name
    again = tlaunch.main(argv + ["--steps", "4"])
    assert again["start"] == 3
    assert "[train] restored step 3" in capsys.readouterr().out
    assert tckpt.latest_step(d) == 4


def test_launcher_refuses_unported_families_and_missing_card():
    """Every registered arch trains (rwkv6-1.6b since its scan got a
    backward: tests/test_torch_rwkv6_train.py); a name outside the registry
    is refused, and so is the card where there is none."""
    with pytest.raises(KeyError, match="unknown arch"):
        tlaunch.main(["--arch", "rwkv7-1.6b", "--device", "cpu", "--steps", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--arch", "granite-3-8b", "--steps", "1"])
