"""seamless-m4t-large-v2 backbone: enc-dec transformer; the audio frontend
is a stub per the assignment (input_specs provides precomputed 80-d fbank
frame embeddings) [arXiv:2308.11596]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=256206, block_pattern=("cross",),
        enc_layers=24, frontend_dim=80,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="seamless-tiny", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, block_pattern=("cross",),
        enc_layers=2, frontend_dim=16,
    )
