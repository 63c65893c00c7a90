"""The plain reference, by the configuration's family: ``lm_loss`` and
``decode_logits`` run the module ``reference/<family>.py`` of the shape's
family (a ``-`` in the name is a ``_`` in the file's); the products,
norms and the logit gap are :mod:`gappbench.reference.common`'s.

Every family's reference is float32 PyTorch with TF32 off and imports
nothing of the port: the weights are the benchmark's, given as a tree of
the port's keys.  ``mm`` is the product every matrix multiplication goes
through: ``a @ b`` for the reference, a lower-precision emulation for
the control (:func:`fp8_mm`).
"""
from __future__ import annotations

import importlib

from gappbench.reference.common import (  # noqa: F401
    fp8_mm, no_tf32, plain_mm, rope, widest_gap)


def family_reference(s):
    """The reference module of ``s``'s family."""
    return importlib.import_module(
        "gappbench.reference." + s.family.replace("-", "_"))


def lm_loss(params, tokens, frontend, s, mm=plain_mm, remat: bool = True,
            keep_rows=None):
    """The training objective over a batch of ``tokens`` (and a patch
    prefix ``frontend``, or None): mean next-token cross entropy, plus
    what the family adds (a router's auxiliary loss).  ``keep_rows``: the
    batch rows the loss is averaged over (a fault that leaves rows
    out)."""
    return family_reference(s).lm_loss(params, tokens, frontend, s, mm=mm,
                                       remat=remat, keep_rows=keep_rows)


def decode_logits(params, tokens, start: int, ctx_k, ctx_v, s, mm=plain_mm,
                  **routing):
    """Logits (n, V) at positions start .. start+n-1 of one sequence whose
    tokens there are ``tokens`` (n,), over the prompt's rows ``ctx_k[i]``,
    ``ctx_v[i]`` (start, KV, hd) at positions 0 .. start-1 of each cache
    layer ``i``: a prefill of the new tokens against the prompt's cache.
    ``routing`` (``routes``, ``route_gaps``, ``reroute``,
    ``own_route_gap``), for a family whose layers route tokens to experts:
    route as the program did (see
    ``reference/tiny_pattern.py::decode_logits``)."""
    return family_reference(s).decode_logits(params, tokens, start, ctx_k,
                                             ctx_v, s, mm=mm, **routing)
