"""Checkpoints in the reference's layout (``repro.checkpoint.ckpt``):

    <dir>/step_<N:08d>/arrays.npz      one array per leaf, the key its path
                                       joined by "\\x1f", list indices as
                                       numbers (blocks\\x1f3\\x1fattn\\x1fwq)
    <dir>/step_<N:08d>/meta.msgpack    {step, treedef, keys, dtypes, extra}

so either package restores what the other saved.  ``save`` writes to a
``.tmp`` directory, renames it into place and keeps the newest ``keep``
steps.  The card's machine has no ``msgpack`` package, so this module packs
and unpacks the subset ``meta`` uses (maps, arrays, str, int, float, bool,
nil) itself, byte for byte as ``msgpack.packb`` does.
"""
from __future__ import annotations

import os
import re
import shutil
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.model import ParamTree
from repro_torch.utils.tree import flatten_with_names

_SEP = "\x1f"  # unit separator: the reference's key joiner
_STEP_DIR = re.compile(r"step_(\d+)")


# ---------------------------------------------------------------------------
# msgpack, the subset of meta.msgpack
# ---------------------------------------------------------------------------


def _pack_len(n: int, fix: int, fix_max: int, wide: Tuple[int, ...]) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt in zip(wide, (">B", ">H", ">I")[-len(wide):]):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 128 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    table = ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")) if n >= 0 \
        else ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q"))
    for code, fmt in table:
        try:
            return bytes([code]) + struct.pack(fmt, n)
        except struct.error:
            continue
    raise ValueError(f"msgpack: integer {n} out of range")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for maps, lists / tuples, str, int, float,
    bool and None."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), 0xa0, 31, (0xd9, 0xda, 0xdb)) + raw
    if isinstance(obj, (list, tuple)):
        return _pack_len(len(obj), 0x90, 15, (0xdc, 0xdd)) + b"".join(
            packb(x) for x in obj)
    if isinstance(obj, dict):
        return _pack_len(len(obj), 0x80, 15, (0xde, 0xdf)) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
        0xde: ">H", 0xdf: ">I"}


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data)`` for what ``packb`` writes (and float32)."""
    pos = 0

    def take(fmt):
        nonlocal pos
        (val,) = struct.unpack_from(fmt, data, pos)
        pos += struct.calcsize(fmt)
        return val

    def item():
        nonlocal pos
        code = data[pos]
        pos += 1
        if code < 0x80 or code >= 0xe0:
            return code if code < 0x80 else code - 0x100
        if code in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[code]
        if code in _FIXED:
            return take(_FIXED[code])
        if 0xa0 <= code <= 0xbf or code in (0xd9, 0xda, 0xdb):
            n = code & 0x1f if code <= 0xbf else take(_LEN[code])
            pos += n
            return data[pos - n:pos].decode("utf-8")
        if 0x90 <= code <= 0x9f or code in (0xdc, 0xdd):
            n = code & 0x0f if code <= 0x9f else take(_LEN[code])
            return [item() for _ in range(n)]
        if 0x80 <= code <= 0x8f or code in (0xde, 0xdf):
            n = code & 0x0f if code <= 0x8f else take(_LEN[code])
            return {item(): item() for _ in range(n)}
        raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")

    out = item()
    if pos != len(data):
        raise ValueError("msgpack: trailing bytes")
    return out


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {name.replace("/", _SEP): leaf.detach().cpu().numpy()
            for name, leaf in flatten_with_names(tree)}


def nest(flat: Dict[str, Any]) -> Dict:
    """{"blocks\\x1f0\\x1fattn\\x1fwq": a, ...} -> nested dicts, the dicts
    whose keys are all list indices turned back into lists."""
    root: Dict = {}
    for key, arr in flat.items():
        node = root
        *path, leaf = key.split(_SEP)
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def step_path(ckpt_dir: str, step: Optional[int] = None) -> str:
    """The directory of ``step`` (default the latest) under ``ckpt_dir``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def read_arrays(path: str) -> Dict[str, np.ndarray]:
    """The flat {key: array} of a step directory's ``arrays.npz``."""
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        return {k: arrays[k] for k in arrays.files}


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write ``tree`` (a ``ParamTree`` or nested dicts / lists of tensors)
    as step ``step``; returns the step's directory."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {
        "step": step,
        "treedef": type(tree).__name__,
        "keys": list(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(packb(meta))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _rotate(ckpt_dir, keep)
    return path


def _rotate(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if _STEP_DIR.fullmatch(d))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_DIR.fullmatch(d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, *, step: Optional[int] = None
            ) -> Tuple[Any, Dict]:
    """Restore step ``step`` (default the latest) into the structure of
    ``template`` (a ``ParamTree``, or nested dicts / lists of tensors),
    on the template's device; shapes and dtypes come from the checkpoint,
    which must hold exactly the template's leaves at their shapes.
    Returns (tree, meta's ``extra``)."""
    path = step_path(ckpt_dir, step)
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = unpackb(f.read())
    flat = read_arrays(path)
    leaves = flatten_with_names(template)
    want = {name: tuple(leaf.shape) for name, leaf in leaves}
    got = {k.replace(_SEP, "/"): tuple(v.shape) for k, v in flat.items()}
    if want != got:
        raise ValueError(
            f"checkpoint {path} does not match the template: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}, wrong shape "
            f"{sorted(k for k in set(want) & set(got) if want[k] != got[k])}")
    dev = leaves[0][1].device if leaves else torch.device("cpu")
    tree = nest({k: torch.from_numpy(v).to(dev) for k, v in flat.items()})
    return (ParamTree(tree) if isinstance(template, nn.Module) else tree), meta["extra"]
