"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP, 256k vocabulary (the
biggest beneficiary of the logits-free fused-heads kernel).
[arXiv:2402.16819]"""
from repro_torch.config import ModelConfig, register

NAME = "nemotron-4-15b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="dense",
        source="arXiv:2402.16819",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        activation="relu2",    # squared ReLU, non-gated
        norm_type="layernorm",
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
        vocab_size=512,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
