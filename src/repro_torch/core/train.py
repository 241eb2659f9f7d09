"""Training for the combined scoring/proposal model (paper §6), as
``repro.core.train``.

* **Random sub-loss selection**: one head per minibatch, drawn uniformly,
  an unbiased estimate of the mean of the k head losses (``head_loss =
  "mean"`` computes all k, for small models).  The head index is drawn on
  the host from a CPU ``torch.Generator``, so the draw never waits for the
  card.
* **Frozen vs fine-tuned base (§6.1)**: with ``freeze_base`` the trunk runs
  under ``torch.no_grad()`` (the port's form of the reference's
  ``stop_gradient`` on the hidden states), and frozen training draws the
  head from {1..k-1}, since head 0 is the base model itself.  Gradients
  still reach the vocab projection, as in the reference.  An MoE trunk
  runs with gradients even so: the reference stops the gradient at the
  hidden states only, so its router terms still reach the trunk.
* Logit z-loss and label smoothing; for an MoE model the load-balance and
  router-z terms (``router_aux_coef`` · ``moe_aux_loss`` + ``router_z_coef``
  · ``moe_z_loss``, averaged over layers), from a capacity-bounded forward
  as in the reference: training drops the assignments past capacity.
* **Masked prediction** (hubert, encoder-only): the codebook ids of the
  masked frames from a bidirectional forward (``masked_prediction_loss``).
* **Parallel scheduled sampling** (arXiv:1906.04331): one no-grad forward
  predicts every position of the gold stream; the conditioning stream
  swaps each token after the first for that prediction with probability
  ``ss_ratio``.  The swap mask is drawn on the tokens' device, from a
  generator seeded by the host generator.

The reference threads a PRNG key through these functions; the port
threads a ``torch.Generator`` (``gen``).  ``head_idx=`` and ``swap=``
override the two draws, so a test can hand the port the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.heads import head_apply_dynamic
from repro_torch.models import model as model_lib
from repro_torch.models import seq2seq as seq2seq_lib
from repro_torch.models.blocks import check_supported


def softmax_xent(logits, targets, *, mask=None, label_smoothing=0.0,
                 z_loss=0.0):
    """logits (..., V), targets (...,) int; returns (loss, metrics)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    idx = targets.long()[..., None]
    nll = logz - logits.gather(-1, idx)[..., 0]
    if label_smoothing:
        smooth = logz - logits.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    if z_loss:
        nll = nll + z_loss * logz.square()
    if mask is None:
        mask = torch.ones_like(nll)
    mask = torch.broadcast_to(mask.float(), nll.shape)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    hits = (logits.argmax(dim=-1) == targets.long()).float()
    acc = (hits * mask).sum().detach() / denom.detach()
    return loss, {"nll": loss.detach(), "accuracy": acc}


def _head_logits_for(params, cfg: ModelConfig, hidden, head_idx: int,
                     freeze_base: bool, detach_residual: bool = False):
    """Logits of head ``head_idx`` over the trunk's hidden states."""
    if freeze_base:
        hidden = hidden.detach()
    if not cfg.bpd_enabled:          # plain LM pre-training (no heads yet)
        return model_lib.project_vocab(params, cfg, hidden)
    h = head_apply_dynamic(params["bpd_heads"], cfg, hidden, head_idx,
                           identity_p1=cfg.bpd_identity_p1,
                           detach_residual=detach_residual)
    return model_lib.project_vocab(params, cfg, h)


def _sample_head(gen: torch.Generator, cfg: ModelConfig,
                 tc: TrainConfig) -> Optional[int]:
    if tc.head_loss == "mean" or not cfg.bpd_enabled:
        return None
    lo = 1 if (tc.freeze_base and cfg.bpd_identity_p1) else 0
    return int(torch.randint(lo, cfg.bpd_k, (), generator=gen))


# ---------------------------------------------------------------------------
# Parallel scheduled sampling (arXiv:1906.04331)
# ---------------------------------------------------------------------------


def scheduled_sampling_ratio(tc: TrainConfig, step: int) -> float:
    """Linear 0 -> ``tc.ss_ratio`` over ``tc.ss_anneal_steps`` steps
    (constant when 0; 0 without scheduled sampling).  A loop passes it as
    ``batch["ss_ratio"]``; a batch without the key uses ``tc.ss_ratio``."""
    if not tc.scheduled_sampling:
        return 0.0
    if tc.ss_anneal_steps <= 0:
        return float(tc.ss_ratio)
    frac = min(max(step, 0) / tc.ss_anneal_steps, 1.0)
    return float(tc.ss_ratio) * frac


def _ss_ratio_for(tc: TrainConfig, batch: Dict) -> float:
    return float(batch["ss_ratio"]) if "ss_ratio" in batch else float(tc.ss_ratio)


def _swap_mask(gen: torch.Generator, ratio: float, shape, device) -> torch.Tensor:
    """Bernoulli(``ratio``) of ``shape`` on ``device``: on the card from a
    generator there, seeded by one draw of the host generator."""
    if device.type != "cpu":
        seed = int(torch.randint(2 ** 62, (), generator=gen))
        gen = torch.Generator(device=device).manual_seed(seed)
    probs = torch.full(shape, ratio, dtype=torch.float32, device=device)
    return torch.bernoulli(probs, generator=gen).bool()


def _mix(stream, model_stream, swap):
    """``stream`` with each position after the first swapped for
    ``model_stream``'s where ``swap``."""
    keep_first = torch.arange(stream.shape[1], device=stream.device)[None, :] > 0
    return torch.where(swap.to(stream.device) & keep_first, model_stream,
                       stream).to(stream.dtype)


@torch.no_grad()
def ss_mix_lm(params, cfg: ModelConfig, batch: Dict, gen, ratio: float,
              with_pred: bool = False, *, swap=None):
    """The mixed conditioning stream of a causal LM: p_1's prediction of
    every position from one forward of the gold stream, swapped in with
    probability ``ratio`` (never at position 0).  With ``with_pred`` also
    the model-token stream (position 0 gold, then p_1's prediction of each
    later position): the self-distillation targets of
    ``tc.ss_self_targets``.  ``swap`` (B, S) bool replaces the draw."""
    tokens = batch["tokens"]
    h = model_lib.embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    hidden, _ = model_lib.forward_hidden(params, cfg, h, positions=positions)
    hidden = hidden[:, model_lib.prefix_len(cfg, batch):, :]
    logits = _head_logits_for(params, cfg, hidden, 0, freeze_base=True)
    pred = logits.argmax(dim=-1).to(tokens.dtype)          # predicts t+1
    model_tok = torch.cat([tokens[:, :1], pred[:, :-1]], dim=1)
    if swap is None:
        swap = _swap_mask(gen, ratio, tokens.shape, tokens.device)
    mixed = _mix(tokens, model_tok, swap)
    return (mixed, model_tok) if with_pred else mixed


@torch.no_grad()
def ss_mix_seq2seq(params, cfg: ModelConfig, batch: Dict, gen, ratio: float,
                   enc_kvs=None, with_pred: bool = False, *, swap=None):
    """As ``ss_mix_lm`` over the BOS-shifted target (BOS always stays);
    ``enc_kvs`` reuses an encoder forward.  With ``with_pred`` also the
    model's prediction of the target stream (``pred[t]`` predicts
    ``tgt[t]``)."""
    src, tgt = batch["src"], batch["tgt"]
    if enc_kvs is None:
        enc_kvs = seq2seq_lib.encode(params, cfg, src)
    bos = torch.zeros((tgt.shape[0], 1), dtype=tgt.dtype, device=tgt.device)
    dec_in = torch.cat([bos, tgt[:, :-1]], dim=1)
    hidden, _ = seq2seq_lib.forward_hidden(params, cfg, dec_in, enc_kvs)
    logits = _head_logits_for(params, cfg, hidden, 0, freeze_base=True)
    pred = logits.argmax(dim=-1).to(tgt.dtype)             # predicts tgt[t]
    model_in = torch.cat([bos, pred[:, :-1]], dim=1)
    if swap is None:
        swap = _swap_mask(gen, ratio, dec_in.shape, dec_in.device)
    mixed = _mix(dec_in, model_in, swap)
    return (mixed, pred) if with_pred else mixed


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _head_targets(stream, offs: int, tgt_mask=None):
    """Targets ``stream[t + offs]`` (clamped at the end) and the mask of
    the positions where ``t + offs`` lies inside the stream."""
    b, s = stream.shape
    tpos = torch.arange(s, device=stream.device)[None, :] + offs
    tpos_c = torch.clamp(tpos, max=s - 1).expand(b, s)
    targets = stream.gather(1, tpos_c)
    mask = (tpos < s).float()
    if tgt_mask is not None:
        mask = mask * tgt_mask.float().gather(1, tpos_c)
    return targets, mask


def _heads_loss(params, cfg: ModelConfig, tc: TrainConfig, hidden, stream,
                gen, head_idx: Optional[int], first_offset: int,
                tgt_mask=None) -> Tuple[torch.Tensor, Dict]:
    """The §6 loss of the heads over ``hidden``: head i predicts
    ``stream[t + first_offset + i]``; one head under ``random`` (drawn
    unless ``head_idx`` is given), the mean of all k under ``mean``."""
    def one(i):
        logits = _head_logits_for(params, cfg, hidden, i, tc.freeze_base,
                                  tc.detach_head_residual)
        targets, mask = _head_targets(stream, i + first_offset, tgt_mask)
        return softmax_xent(logits, targets, mask=mask,
                            label_smoothing=tc.label_smoothing,
                            z_loss=tc.z_loss)

    if cfg.bpd_enabled and tc.head_loss == "random":
        if head_idx is None:
            head_idx = _sample_head(gen, cfg, tc)
        loss, m = one(head_idx)
        m["head_idx"] = float(head_idx)
        return loss, m
    nheads = cfg.bpd_k if cfg.bpd_enabled else 1
    total, m = 0.0, {}
    for i in range(nheads):
        li, mi = one(i)
        total = total + li / nheads
        if i == 0:
            m = mi
    return total, m


def lm_loss(params, cfg: ModelConfig, tc: TrainConfig, batch: Dict, gen, *,
            head_idx: Optional[int] = None, swap=None) -> Tuple[torch.Tensor, Dict]:
    """batch: tokens (B, S).  Head i (0-based) predicts position t+1+i
    from the hidden state at t.  Under ``tc.scheduled_sampling`` the
    conditioning stream is ``ss_mix_lm``'s mixture and the targets stay
    gold, unless ``tc.ss_self_targets`` supervises with the base's own
    chain predictions."""
    tokens = batch["tokens"]
    fwd_batch = batch
    if tc.scheduled_sampling:
        mixed, model_tok = ss_mix_lm(params, cfg, batch, gen,
                                     _ss_ratio_for(tc, batch),
                                     with_pred=True, swap=swap)
        fwd_batch = dict(batch, tokens=mixed)
        if tc.ss_self_targets:
            tokens = model_tok
    moe = cfg.mlp_type == "moe"
    moe_m: Dict = {}
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and (moe or not tc.freeze_base)):
        h = model_lib.embed_inputs(params, cfg, fwd_batch)
        positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        hidden, _ = model_lib.forward_hidden(params, cfg, h, positions=positions,
                                             metrics=moe_m if moe else None)
    hidden = hidden[:, model_lib.prefix_len(cfg, batch):, :]   # text only
    loss, m = _heads_loss(params, cfg, tc, hidden, tokens, gen, head_idx, 1)
    if moe:
        loss = (loss + cfg.router_aux_coef * moe_m["moe_aux_loss"]
                + cfg.router_z_coef * moe_m["moe_z_loss"])
        m.update({k: v.detach() for k, v in moe_m.items()})
    m["loss"] = loss.detach()
    return loss, m


def seq2seq_loss(params, cfg: ModelConfig, tc: TrainConfig, batch: Dict, gen,
                 *, head_idx: Optional[int] = None,
                 swap=None) -> Tuple[torch.Tensor, Dict]:
    """batch: src (B, Ss), tgt (B, St) [, tgt_mask (B, St)]; teacher forcing
    on the BOS-shifted target: decoder position t has seen tgt[<t], and
    head i predicts tgt[t+i].  Scheduled sampling as in ``lm_loss``."""
    src, tgt = batch["src"], batch["tgt"]
    with torch.set_grad_enabled(torch.is_grad_enabled() and not tc.freeze_base):
        enc_kvs = seq2seq_lib.encode(params, cfg, src)
        bos = torch.zeros((tgt.shape[0], 1), dtype=tgt.dtype, device=tgt.device)
        dec_in = torch.cat([bos, tgt[:, :-1]], dim=1)
        if tc.scheduled_sampling:
            dec_in, ss_pred = ss_mix_seq2seq(params, cfg, batch, gen,
                                             _ss_ratio_for(tc, batch),
                                             enc_kvs=enc_kvs, with_pred=True,
                                             swap=swap)
            if tc.ss_self_targets:
                tgt = ss_pred
        hidden, _ = seq2seq_lib.forward_hidden(params, cfg, dec_in, enc_kvs)
    loss, m = _heads_loss(params, cfg, tc, hidden, tgt, gen, head_idx, 0,
                          batch.get("tgt_mask"))
    m["loss"] = loss.detach()
    return loss, m


def masked_prediction_loss(params, cfg: ModelConfig, tc: TrainConfig,
                           batch: Dict, gen=None, *, head_idx=None,
                           swap=None) -> Tuple[torch.Tensor, Dict]:
    """The encoder-only loss (hubert): batch frame_embeds (B, S, d), mask
    (B, S) bool, targets (B, S) int32.  The masked frames are replaced by
    ``mask_embed`` (``model.embed_inputs``), the stack runs bidirectional,
    and the codebook cross-entropy with z-loss is averaged over the masked
    frames only, the pad lanes of the vocab at -1e9.  It draws nothing:
    ``gen``, ``head_idx`` and ``swap`` are taken, as ``make_train_step``
    passes them to every loss, and unused."""
    h = model_lib.embed_inputs(params, cfg, batch)
    hidden, _ = model_lib.forward_hidden(params, cfg, h, bidirectional=True)
    logits = model_lib.project_vocab(params, cfg, hidden)
    loss, m = softmax_xent(logits, batch["targets"], mask=batch["mask"].float(),
                           z_loss=tc.z_loss)
    m["loss"] = loss.detach()
    return loss, m


def loss_fn_for(cfg: ModelConfig) -> Callable:
    """The reference's choice, in its order: ``masked_prediction_loss`` for
    an encoder-only model, ``seq2seq_loss`` for an encoder-decoder,
    ``lm_loss`` for a decoder-only model, RWKV-6 included (its prefill scan
    runs ``kernels.rwkv6_scan.RWKV6Scan`` under autograd, whose backward is
    the reverse scan); the unported combinations raise."""
    check_supported(cfg)
    if cfg.is_encoder_only:
        return masked_prediction_loss
    return seq2seq_loss if cfg.is_encoder_decoder else lm_loss
