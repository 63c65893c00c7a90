"""rwkv6-1.6b "Finch": attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536, block_pattern=("rwkv",),
        rwkv_head_dim=64, chunk_size=128,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-tiny", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, block_pattern=("rwkv",),
        rwkv_head_dim=16, chunk_size=8,
    )
