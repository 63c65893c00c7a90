"""deepseek-7b: dense llama-arch decoder [arXiv:2401.02954]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense",
        num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=11008, vocab_size=102400, block_pattern=("dense",),
        rope_theta=10_000.0,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, block_pattern=("dense",),
    )
