"""grok-1-314b: 8-expert top-2 MoE decoder [hf:xai-org/grok-1]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=32768, vocab_size=131072,
        block_pattern=("moe",), num_experts=8, top_k=2,
        logits_softcap=30.0,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="grok-tiny", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, block_pattern=("moe",),
        num_experts=4, top_k=2, logits_softcap=30.0,
    )
