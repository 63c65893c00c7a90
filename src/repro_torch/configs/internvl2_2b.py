"""internvl2-2b backbone: InternLM2-1.8B decoder; InternViT frontend is a
stub (precomputed 1024-d patch embeddings, 256-token prefix)
[arXiv:2404.16821]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        d_ff=8192, vocab_size=92553, block_pattern=("dense",),
        frontend_dim=1024, num_prefix=256, rope_theta=1_000_000.0,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="internvl2-tiny", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=256, block_pattern=("dense",),
        frontend_dim=32, num_prefix=8,
    )
