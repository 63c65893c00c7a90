"""Serving: prefill/decode steps, engine, flash-decode."""
from repro_torch.serve.engine import Engine, Request, make_decode_step, make_prefill_step  # noqa: F401
