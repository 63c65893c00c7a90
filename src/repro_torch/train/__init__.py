"""Training: step builders + instrumented trainer loop."""
from repro_torch.train.step import make_eval_step, make_train_step

__all__ = ["make_eval_step", "make_train_step"]
