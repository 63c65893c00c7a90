"""qwen1.5-4b: dense decoder with QKV bias [hf:Qwen/Qwen1.5 family]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
        d_ff=6912, vocab_size=151936, block_pattern=("dense",),
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, block_pattern=("dense",), qkv_bias=True,
    )
