"""Model substrate: composable blocks covering all assigned families."""
from repro_torch.models.common import ModelConfig
from repro_torch.models import (attention, blocks, moe, recurrent,
                                transformer)
from repro_torch.models.transformer import (cross_memory, decode_step,
                                            forward, init_decode_state,
                                            init_lm, lm_loss)

__all__ = [
    "ModelConfig", "attention", "blocks", "moe", "recurrent", "transformer",
    "cross_memory", "decode_step", "forward", "init_decode_state", "init_lm",
    "lm_loss",
]
