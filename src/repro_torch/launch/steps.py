"""Step factories, as ``repro.launch.steps``: training, prefill and BPD
serving on one device.

  * ``make_train_step``   — forward + the BPD multi-head loss + backward +
                            optimizer update
  * ``make_prefill_step`` — the parallel forward that fills the caches and
                            drafts the first block (the paper's initial
                            predict substep); for an encoder-only model the
                            encode, returning the code logits
  * ``make_serve_step``   — ONE blockwise-parallel-decoding iteration
                            against the caches (paper §4 combined model)
  * ``materialize_serve_state`` — the zero serving state those iterations
                            run on, at a context of ``seq_len``

The reference's ``input_specs``, ``serve_state_struct`` and
``adapt_config`` shape its multi-pod dry run, which is not ported
(ROADMAP.md §1 item 8e).  The prefill and serve steps run under
``torch.no_grad``, as every decode entry point does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import DecodeConfig, ModelConfig, TrainConfig
from repro_torch.core import decode as decode_lib
from repro_torch.core.policy import resolve_policy
from repro_torch.core.train import loss_fn_for
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.model import set_trainable
from repro_torch.optim import optimizer_update
from repro_torch.utils.tree import flatten_with_names, tree_map_with_name

I32 = torch.int32


def _prefix(cfg: ModelConfig) -> int:
    """The positions before the text: the meta tokens, and a vision_text
    config's full patch count (the reference takes it from the config, not
    from a batch)."""
    return cfg.num_meta_tokens + (
        cfg.num_patch_tokens if cfg.modality == "vision_text" else 0)


def text_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions = seq_len minus the modality / meta prefix."""
    return max(seq_len - _prefix(cfg), 8)


def differentiated(cfg: ModelConfig, tc: TrainConfig, params) -> Dict[str, float]:
    """The leaves the reference's gradient reaches ({name: 1.0 or 0.0}):
    every leaf of a fine-tuned model, of an MoE model, whose router terms
    reach the trunk past the frozen hidden states, or of an encoder-only
    model, whose masked-prediction loss stops no gradient; with a frozen
    base otherwise only the heads and the vocab projection, whose gradient
    counts in the clip's global norm even where a mask freezes it."""
    proj = "embed/table" if cfg.tie_embeddings else "lm_head/"
    every = not tc.freeze_base or cfg.mlp_type == "moe" or cfg.is_encoder_only
    return tree_map_with_name(
        lambda name, p: float(every or name.startswith("bpd_heads")
                              or name.startswith(proj)), params)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    mask: Optional[Dict[str, float]] = None) -> Callable:
    """``train_step(params, opt_state, batch, gen, *, head_idx=None,
    swap=None) -> (params, opt_state, metrics)``: params and state are
    updated in place, each leaf's gradient stays in its ``.grad`` until the
    next step, and the metrics are tensors on the device (no host read) or
    host numbers (``head_idx``, ``lr``).  ``gen`` is the host generator of
    the step's draws; ``head_idx`` / ``swap`` override them
    (``core.train``).  Raises for a family whose loss is not ported."""
    loss_fn = loss_fn_for(cfg)

    def train_step(params, opt_state, batch, gen, *, head_idx=None, swap=None):
        set_trainable(params, differentiated(cfg, tc, params))
        leaves = flatten_with_names(params)
        for _, p in leaves:
            p.grad = None
        loss, metrics = loss_fn(params, cfg, tc, batch, gen,
                                head_idx=head_idx, swap=swap)
        loss.backward()
        grads = {name: p.grad for name, p in leaves if p.grad is not None}
        params, opt_state, opt_m = optimizer_update(grads, opt_state, params,
                                                    tc, mask=mask)
        metrics.update(opt_m)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# prefill_step and serve_step
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, dec: DecodeConfig, *,
                      kv_chunk: int = 0) -> Callable:
    """``prefill_step(params, batch)``: for a decoder the ``BPDState`` of
    ``decode.bpd_prefill_causal_lm`` (caches filled from the prompt, the
    first proposals drafted; ``dec.max_new_tokens`` of room); for an
    encoder-only model the code logits (B, S, Vp) of one bidirectional
    encode.  ``kv_chunk`` > 0 bounds the forward's attention scores."""
    if cfg.is_encoder_only:
        @torch.no_grad()
        def encode_step(params, batch):
            h = model_lib.embed_inputs(params, cfg, batch)
            hidden, _ = model_lib.forward_hidden(params, cfg, h,
                                                 bidirectional=True,
                                                 kv_chunk=kv_chunk)
            return model_lib.project_vocab(params, cfg, hidden)

        return encode_step

    def prefill_step(params, batch) -> decode_lib.BPDState:
        state, _ = decode_lib.bpd_prefill_causal_lm(
            params, cfg, dec, batch, max_new=dec.max_new_tokens,
            kv_chunk=kv_chunk)
        return state

    return prefill_step


def make_serve_step(cfg: ModelConfig, dec: DecodeConfig, *, seq_len: int,
                    max_new: int = 4096, kv_chunk: int = 0,
                    aux_params=None) -> Callable:
    """``serve_step(params, state) -> state``: one ``bpd_iteration`` under
    ``dec``'s resolved policy, the text offset by ``_prefix``.
    ``seq_len`` and ``kv_chunk`` are the reference's arguments: a decode
    iteration's (k, L) scores need no chunking, and the state carries its
    own lengths.  ``aux_params`` ({bundle name: params}) is handed to a
    drafter that runs an auxiliary model (see core.bundle); the default
    serve path is single-model."""
    del seq_len, kv_chunk
    prefix = _prefix(cfg)
    backend = decode_lib.causal_lm_backend(cfg)
    pol = resolve_policy(dec)

    @torch.no_grad()
    def serve_step(params, state: decode_lib.BPDState) -> decode_lib.BPDState:
        return decode_lib.bpd_iteration(
            params, cfg, dec, backend, state, prefix_offset=prefix,
            max_new=max_new, policy=pol, aux_params=aux_params)

    return serve_step


def _zeros(tree, device):
    """Every tensor of ``tree`` as zeros of its shape and dtype on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _zeros(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zeros(v, device) for v in tree)
    return tree


def materialize_serve_state(cfg: ModelConfig, dec: DecodeConfig, *, batch: int,
                            seq_len: int, max_new: int = 4096,
                            device=None) -> decode_lib.BPDState:
    """The serving state at a context of ``seq_len`` positions (the prefix
    included) with every tensor zero, on ``device`` (None: the card), as
    the reference materializes its ``serve_state_struct``: the caches of
    ``init_caches`` for ``seq_len + max_new`` positions on ``dec``'s cache
    backend (their positions zero too), a token buffer of ``seq_len``
    minus the prefix + ``max_new`` + block_k, and the state of ``dec``'s
    resolved policy (a drafter that needs the decode's inputs raises, as
    in the reference).  Its fields have the shapes and dtypes of
    ``serve_state_struct``; a serve step on it is shaped work, as the
    reference's dry run lowers."""
    block_k = dec.block_k or cfg.bpd_k
    pol = resolve_policy(dec)
    caches = model_lib.init_caches(cfg, batch, seq_len + max_new, block_k,
                                   device="meta",
                                   backend=cache_lib.get_backend(dec))
    text_cap = seq_len - _prefix(cfg) + max_new + block_k
    state = decode_lib.BPDState(
        tokens=torch.empty((batch, text_cap), dtype=I32, device="meta"),
        text_len=torch.empty((batch,), dtype=I32, device="meta"),
        proposals=torch.empty((batch, block_k), dtype=I32, device="meta"),
        caches=caches,
        finished=torch.empty((batch,), dtype=torch.bool, device="meta"),
        iters=0,
        generated=torch.empty((batch,), dtype=I32, device="meta"),
        policy_state=pol.init_state(cfg, dec, None, batch),
    )
    return _zeros(state, resolve_device(device))
