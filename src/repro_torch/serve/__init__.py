"""Serving: prefill/decode steps and the batched engine."""
from repro_torch.serve.engine import Engine, Request, make_decode_step, make_prefill_step  # noqa: F401
