"""Config dataclasses, field for field those of ``repro.config.base``.

``ModelConfig`` describes the architecture, ``DecodeConfig`` the
blockwise-parallel-decoding parameters, ``TrainConfig`` the training run
(optimizer, schedule, the paper's §6 head loss, scheduled sampling).
``DTYPES`` maps the dtype names to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio | seq2seq
    source: str = ""               # citation for the config numbers

    # --- trunk shape ---------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4             # query heads (ignored for attn-free blocks)
    num_kv_heads: int = 4          # GQA kv heads
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 1024               # dense MLP width (per-expert width for MoE)
    vocab_size: int = 512

    # --- block composition ---------------------------------------------------
    block_type: str = "attn"       # attn | rwkv6 | hymba
    mlp_type: str = "dense"        # dense | moe | rwkv_channel_mix
    activation: str = "silu"       # silu | gelu | relu2 | geglu
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    qk_norm: bool = False
    tie_embeddings: bool = False

    # --- attention -----------------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full attention
    global_attn_layers: Tuple[int, ...] = ()  # layers exempt from the window
    attn_logit_softcap: float = 0.0

    # --- encoder / seq2seq ---------------------------------------------------
    is_encoder_only: bool = False
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    expert_pad_multiple: int = 1
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM / hybrid --------------------------------------------------------
    ssm_state_dim: int = 16
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    rwkv_head_dim: int = 64
    num_meta_tokens: int = 0       # hymba learnable prefix tokens

    # --- modality frontends --------------------------------------------------
    modality: str = "text"         # text | vision_text | audio
    num_patch_tokens: int = 0
    frontend_dim: int = 0

    # --- blockwise parallel decoding (the paper's technique) -----------------
    bpd_k: int = 8                 # number of prediction heads p_1..p_k
    bpd_hidden: int = 0            # head FFN hidden size (0 -> d_ff heuristic)
    bpd_enabled: bool = True
    bpd_identity_p1: bool = True   # paper footnote 1: identity head for p_1

    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    max_seq_len: int = 8192
    remat: bool = False

    # ------------------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256; ``project_vocab`` masks the
        pad lanes, and token ids are always < vocab_size."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def padded_num_experts(self) -> int:
        """Expert count rounded up to ``expert_pad_multiple`` (qwen2-moe's 60
        experts pad to 64); the router never selects an id >= num_experts,
        so pad experts receive no tokens."""
        if not self.num_experts:
            return 0
        m = max(self.expert_pad_multiple, 1)
        return ((self.num_experts + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def resolved_bpd_hidden(self) -> int:
        return self.bpd_hidden or min(self.d_ff, 4 * self.d_model)

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def params_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def num_kv_groups(self) -> int:
        return max(self.num_heads, 1) // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.block_type in ("attn", "hymba") \
                and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.num_kv_heads}")
        if self.mlp_type == "moe" and not (
                0 < self.num_experts_per_tok <= self.num_experts):
            raise ValueError(
                f"{self.name}: an MoE layer needs 0 < num_experts_per_tok="
                f"{self.num_experts_per_tok} <= num_experts={self.num_experts}")
        if self.block_type == "rwkv6" and self.d_model % self.rwkv_head_dim:
            raise ValueError(
                f"{self.name}: d_model={self.d_model} not divisible by "
                f"rwkv_head_dim={self.rwkv_head_dim}")
        if self.is_encoder_decoder and self.num_encoder_layers < 1:
            raise ValueError(
                f"{self.name}: an encoder-decoder needs num_encoder_layers "
                f">= 1, got {self.num_encoder_layers}")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Paper §3-§5 decode-time parameters (see ``repro.config.DecodeConfig``).

    ``fused_verify`` selects the one-pass accept path for CPU tensors; on the
    card the accept step always runs the fused-verify kernel.
    """

    max_new_tokens: int = 64
    block_k: int = 0               # 0 -> model's bpd_k
    criterion: str = "exact"       # exact | topk | distance  (§3, §5.1, §5.2)
    policy: str = ""               # registered DecodePolicy name ("" -> criterion)
    top_k: int = 1
    epsilon: float = 0.0
    min_block: int = 1
    eos_id: int = -1               # -1: decode for max_new_tokens
    temperature: float = 0.0
    cache_backend: str = "dense"
    page_size: int = 16
    fused_verify: bool = False
    image_height: int = 0
    image_width: int = 0
    locality_stride: int = 4

    def replace(self, **kw) -> "DecodeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    global_batch: int = 32
    seq_len: int = 256
    steps: int = 200
    # optimizer
    optimizer: str = "adamw"       # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    schedule: str = "inv_sqrt"     # inv_sqrt | cosine | constant
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-9
    grad_clip: float = 1.0
    # BPD head training (paper §6)
    head_loss: str = "random"      # random (paper) | mean
    freeze_base: bool = False      # §6.1 frozen base
    detach_head_residual: bool = False  # stabilized fine-tuning (see heads.py)
    label_smoothing: float = 0.0
    z_loss: float = 1e-4
    # Parallel scheduled sampling (arXiv:1906.04331): one extra no-grad
    # forward predicts every position; the conditioning prefix is mixed
    # gold -> model per position with probability ss_ratio (annealed over
    # ss_anneal_steps); targets stay gold unless ss_self_targets, which
    # supervises the heads with the frozen base's own chain predictions.
    scheduled_sampling: bool = False
    ss_ratio: float = 0.5          # peak probability of a model-token swap
    ss_anneal_steps: int = 0       # linear 0 -> ss_ratio ramp (0 = constant)
    ss_self_targets: bool = False

    def __post_init__(self):
        valid_head_loss = ("random", "mean")
        if self.head_loss not in valid_head_loss:
            raise ValueError(
                f"TrainConfig.head_loss must be one of {valid_head_loss}, "
                f"got {self.head_loss!r}")
        if not 0.0 <= self.ss_ratio <= 1.0:
            raise ValueError(
                f"TrainConfig.ss_ratio must be in [0, 1], got {self.ss_ratio}")
        if self.ss_anneal_steps < 0:
            raise ValueError(
                f"TrainConfig.ss_anneal_steps must be >= 0, "
                f"got {self.ss_anneal_steps}")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
