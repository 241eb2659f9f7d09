"""stablelm-12b [dense] — GQA with per-head QK norm.
[hf:stabilityai/stablelm-2-1_6b scaled per assignment]"""
from repro_torch.config import ModelConfig, register

NAME = "stablelm-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        activation="silu",
        qk_norm=True,
        bpd_k=8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=256,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
