"""qwen3-32b: dense decoder with qk_norm and GQA kv=8 [hf:Qwen/Qwen3]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=25600, vocab_size=151936,
        block_pattern=("dense",), qk_norm=True, rope_theta=1_000_000.0,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=256, block_pattern=("dense",), qk_norm=True,
    )
