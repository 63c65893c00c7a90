"""Model substrate: composable blocks covering the assigned families
(the recurrent mixes are not ported yet; see ``blocks``)."""
from repro_torch.models.common import ModelConfig
from repro_torch.models import attention, blocks, moe, transformer
from repro_torch.models.transformer import (cross_memory, decode_step,
                                            forward, init_decode_state,
                                            init_lm, lm_loss)

__all__ = [
    "ModelConfig", "attention", "blocks", "moe", "transformer",
    "cross_memory", "decode_step", "forward", "init_decode_state", "init_lm",
    "lm_loss",
]
