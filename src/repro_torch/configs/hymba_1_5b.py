"""hymba-1.5b [hybrid] — parallel attention + mamba heads within each layer,
sliding-window attention with 3 global layers, 128 learnable meta tokens.
[arXiv:2411.13676]"""
from repro_torch.config import ModelConfig, register

NAME = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="hybrid",
        source="arXiv:2411.13676",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        block_type="hymba",
        mlp_type="dense",
        activation="silu",
        sliding_window=1024,
        global_attn_layers=(0, 15, 31),
        ssm_state_dim=16,
        ssm_expand=2,
        num_meta_tokens=128,
        bpd_k=8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2,
        d_model=160,
        num_heads=5,
        num_kv_heads=5,
        head_dim=32,
        d_ff=384,
        vocab_size=128,
        sliding_window=32,
        global_attn_layers=(0,),
        num_meta_tokens=4,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
