"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts with a
sigmoid gate (shared width 4×1408 = 5632).  [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.config import ModelConfig, register

NAME = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,             # per-expert width
        vocab_size=151936,
        mlp_type="moe",
        activation="silu",
        rope_theta=1_000_000.0,
        num_experts=60,
        expert_pad_multiple=16,   # 60 -> 64 lanes: shards over model=16
        num_experts_per_tok=4,
        num_shared_experts=4,
        shared_expert_d_ff=5632,
        bpd_k=8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=96,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=2,
        expert_pad_multiple=1,
        num_shared_experts=1,
        shared_expert_d_ff=96,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
