"""gemma3-1b: 5:1 local:global attention, 262k vocab [hf:google/gemma-3]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
        head_dim=256, d_ff=6912, vocab_size=262144,
        block_pattern=("local",) * 5 + ("dense",), window=512,
        tie_embeddings=True, rope_theta=1_000_000.0,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-tiny", family="dense",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=160, vocab_size=256,
        block_pattern=("local",) * 5 + ("dense",), window=8,
        tie_embeddings=True,
    )
