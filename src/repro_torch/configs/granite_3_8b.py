"""granite-3-8b [dense] — GQA, tied embeddings.
[hf:ibm-granite/granite-3.0-2b-base scaled per assignment]"""
from repro_torch.config import ModelConfig, register

NAME = "granite-3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        activation="silu",
        tie_embeddings=True,
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
