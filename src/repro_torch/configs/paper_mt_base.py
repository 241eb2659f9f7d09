"""paper-mt-base — the paper's own setting: a transformer_base-shaped
encoder-decoder for machine translation (Vaswani et al. 2017
hyperparameters) with the combined scoring/proposal head of §4/§6 on the
decoder.  Field for field ``repro.configs.paper_mt_base``."""
from repro_torch.config import ModelConfig, register

NAME = "paper-mt-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="seq2seq",
        source="Stern et al. 2018 §7.1 (transformer_base)",
        num_layers=6,
        num_encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=32000,
        activation="relu",
        norm_type="layernorm",
        is_encoder_decoder=True,
        bpd_k=8,
        bpd_hidden=2048,
        max_seq_len=4096,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2,
        num_encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=64,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
