"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent per-channel decay,
O(1) recurrent state.  [arXiv:2404.05892]"""
from repro_torch.config import ModelConfig, register

NAME = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="ssm",
        source="arXiv:2404.05892",
        num_layers=24,
        d_model=2048,
        num_heads=0,           # attention-free
        num_kv_heads=0,
        d_ff=7168,
        vocab_size=65536,
        block_type="rwkv6",
        mlp_type="rwkv_channel_mix",
        rwkv_head_dim=64,
        bpd_k=8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2,
        d_model=128,
        d_ff=256,
        vocab_size=256,
        rwkv_head_dim=32,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
