"""recurrentgemma-2b: RG-LRU + local attention hybrid [arXiv:2402.19427]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        block_pattern=("rglru", "rglru", "local"), window=2048,
        lru_width=2560, conv_width=4, tie_embeddings=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-tiny", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=160, vocab_size=256,
        block_pattern=("rglru", "rglru", "local"), window=8,
        lru_width=64, tie_embeddings=True,
    )
