"""Weights from the JAX reference into the port, under identical key paths.

``from_jax_params`` takes the reference's parameter pytree as numpy arrays
(``params["blocks"][3]["attn"]["wq"]`` becomes ``blocks.3.attn.wq``);
``load_checkpoint`` reads the reference's ``step_N/arrays.npz`` checkpoints
with numpy alone.  Both check every key and shape against ``cfg``.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import model as model_lib

_SEP = "\x1f"  # the reference checkpoint's key joiner (checkpoint/ckpt.py)


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def from_jax_params(np_tree: Dict, cfg: ModelConfig, device=None):
    """A reference param pytree (nested dicts / lists of arrays) -> the
    port's ``ParamTree`` on ``device`` (default the card)."""
    dev = resolve_device(device)
    params = model_lib.ParamTree(_to_torch(np_tree, dev))
    want = {k: tuple(v.shape) for k, v in
            model_lib.init(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.state_dict().items()}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(
            f"parameters do not match {cfg.name}: missing {missing}, "
            f"unexpected {extra}, wrong shape {[(k, got[k], want[k]) for k in shapes]}")
    return params


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    """{"blocks\\x1f0\\x1fattn\\x1fwq": a, ...} -> nested dicts, with the
    dicts whose keys are all list indices turned back into lists."""
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


def load_checkpoint(ckpt_dir: str, cfg: ModelConfig, device=None, *,
                    step: Optional[int] = None):
    """Read the reference's ``<ckpt_dir>/step_<N>/arrays.npz`` (the latest
    step unless ``step`` is given) into the port's ``ParamTree``."""
    if step is None:
        steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
                 if (m := re.fullmatch(r"step_(\d+)", d))]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = max(steps)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as arrays:
        flat = {k: arrays[k] for k in arrays.files}
    return from_jax_params(_nest(flat), cfg, device)
