"""olmoe-1b-7b [moe] — 64 routed experts top-8, QK-norm, no shared experts.
[arXiv:2409.02060]"""
from repro_torch.config import ModelConfig, register

NAME = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="moe",
        source="arXiv:2409.02060",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,             # per-expert width
        vocab_size=50304,
        mlp_type="moe",
        activation="silu",
        qk_norm=True,
        num_experts=64,
        num_experts_per_tok=8,
        bpd_k=8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=64,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=2,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
