"""starcoder2-7b [dense] — GQA + RoPE with the model's native 4096-token
sliding window (long_500k runs on the native window).  [arXiv:2402.19173]"""
from repro_torch.config import ModelConfig, register

NAME = "starcoder2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="dense",
        source="arXiv:2402.19173",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        activation="gelu",     # non-gated c_fc/c_proj MLP
        sliding_window=4096,
        rope_theta=100_000.0,
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
        sliding_window=32,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
