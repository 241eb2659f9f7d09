"""Weights from the JAX reference into the port, under identical key paths.

``from_jax_params`` takes the reference's parameter pytree as numpy arrays
(``params["blocks"][3]["attn"]["wq"]`` becomes ``blocks.3.attn.wq``);
``load_checkpoint`` reads ``step_N/arrays.npz`` checkpoints (the
reference's layout, ``repro_torch.checkpoint``) with numpy alone.  Both
check every key and shape against ``cfg``.  With ``mesh`` each rank keeps its
blocks of the reference's whole leaves (``sharding.shard_params``): the
``PARAM_RULES`` cuts, Mamba's ``in_proj`` cut in each of its u and z
halves (``sharding.policy.SPLIT_LEAVES``), experts, wkv heads and Mamba
channels over ``model``; an encoder-decoder's both stacks, its cross
attention and ``src_embed`` too, and a draft bundle's tree by the same
rules.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.config import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.sharding import shard_params


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def from_jax_params(np_tree: Dict, cfg: ModelConfig, device=None, *,
                    mesh=None):
    """A reference param pytree (nested dicts / lists of arrays) -> the
    port's ``ParamTree`` on ``device`` (default the card); with ``mesh``,
    this rank's blocks of it (``sharding.shard_params``)."""
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
    return params if mesh is None else shard_params(params, mesh)


def load_checkpoint(ckpt_dir: str, cfg: ModelConfig, device=None, *,
                    step: Optional[int] = None, mesh=None):
    """Read ``<ckpt_dir>/step_<N>/arrays.npz`` (the latest step unless
    ``step`` is given), written by the reference or by
    ``repro_torch.checkpoint.save``, into the port's ``ParamTree``; with
    ``mesh``, this rank's blocks of it."""
    path = ckpt_lib.step_path(ckpt_dir, step)
    return from_jax_params(ckpt_lib.nest(ckpt_lib.read_arrays(path)), cfg,
                           device, mesh=mesh)
