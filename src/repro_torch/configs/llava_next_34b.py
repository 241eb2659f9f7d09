"""llava-next-34b [vlm] — the language backbone only; the vision tower and
projector are stubs: ``data.pipeline.stub_frontend_inputs`` provides anyres
patch embeddings of the right shape, which the backbone reads before the
text.  [hf:llava-hf/llava-v1.6-mistral-7b-hf scaled per assignment]"""
from repro_torch.config import ModelConfig, register

NAME = "llava-next-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        activation="silu",
        rope_theta=5_000_000.0,
        modality="vision_text",
        num_patch_tokens=2880,  # anyres: 4 tiles + base, 576 patches each
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
        num_patch_tokens=16,
        bpd_k=4,
        max_seq_len=256,
    )


register(NAME, config, smoke_config)
