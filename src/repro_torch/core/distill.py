"""Sequence-level knowledge distillation (paper §6.2), as
``repro.core.distill``: greedy teacher decodes become the training streams
(the reference distills with greedy decodes too; any deterministic teacher
decode gives the "consistent mode breaking" the paper relies on)."""
from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.core.decode import greedy_decode, greedy_decode_seq2seq


def distill_lm_batches(teacher_params, cfg: ModelConfig, batches: Iterable[Dict],
                       *, prompt_len: int, max_new: int) -> List[Dict]:
    """Replace each batch's token stream after ``prompt_len`` with the
    teacher's greedy continuation of its prompt.

    Input batches: {"tokens": (B, S)} (arrays or tensors).  Output: the
    same structure with tensors on the teacher's device,
    ``tokens[:, prompt_len:]`` the teacher's.
    """
    dec = DecodeConfig(max_new_tokens=max_new, block_k=1, eos_id=-1)
    dev = next(teacher_params.parameters()).device
    out = []
    for batch in batches:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        s = tokens.shape[1]
        if prompt_len >= s:
            raise ValueError(
                f"distill_lm_batches: prompt_len={prompt_len} leaves no "
                f"positions to distill in a width-{s} batch")
        if prompt_len + max_new < s:
            # the decode buffer covers prompt_len + max_new positions only:
            # slicing past them would hand its zero padding to the student
            # as teacher tokens
            raise ValueError(
                f"distill_lm_batches: prompt_len + max_new = "
                f"{prompt_len + max_new} < batch width {s} — the teacher "
                f"decode cannot fill the stream; raise max_new to at least "
                f"{s - prompt_len}")
        toks, _ = greedy_decode(teacher_params, cfg, dec,
                                {"tokens": tokens[:, :prompt_len]})
        out.append(dict(batch, tokens=toks[:, :s]))
    return out


def distill_seq2seq_to_causal_batches(teacher_params, cfg: ModelConfig,
                                      src_batches: Iterable, *, max_new: int,
                                      bos_id: int = 0) -> List[Dict]:
    """Draft-student training data from a seq2seq teacher (§6.2 reuse):
    greedy decodes of each (B, Ss) source batch become BOS-prefixed causal
    LM streams, {"tokens": (B, 1 + max_new)} with ``tokens[:, 0] ==
    bos_id``, the stream a draft model replays at decode time."""
    dec = DecodeConfig(max_new_tokens=max_new, block_k=1, eos_id=-1)
    dev = next(teacher_params.parameters()).device
    out = []
    for src in src_batches:
        toks, _ = greedy_decode_seq2seq(
            teacher_params, cfg, dec, {"src": torch.as_tensor(src, device=dev)})
        toks = toks[:, :max_new].to(torch.int32)
        bos = torch.full((toks.shape[0], 1), bos_id, dtype=torch.int32,
                         device=toks.device)
        out.append({"tokens": torch.cat([bos, toks], dim=1)})
    return out
