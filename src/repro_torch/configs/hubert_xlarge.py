"""hubert-xlarge [audio] — encoder-only masked prediction over a 504-entry
codebook.  The conv / mel frontend is a stub: the batch carries frame
embeddings (``data.synthetic.MaskedFrames``).  There is no autoregressive
decode, so blockwise parallel decoding does not apply and the model only
trains.  [arXiv:2106.07447]"""
from repro_torch.config import ModelConfig, register

NAME = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="audio",
        source="arXiv:2106.07447",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        activation="gelu",
        norm_type="layernorm",
        is_encoder_only=True,
        modality="audio",
        bpd_enabled=False,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=64,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
