"""arctic-480b: 128-expert top-2 MoE with a parallel dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=4864, vocab_size=32000,
        block_pattern=("moe",), num_experts=128, top_k=2,
        dense_residual=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="arctic-tiny", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, block_pattern=("moe",),
        num_experts=8, top_k=2, dense_residual=True,
    )
