"""Serving: prefill and decode step builders + a minimal batched engine.

``make_prefill_step`` runs the full-sequence forward and returns last-token
logits; ``make_decode_step`` advances one token against the decode state
(KV caches), which it updates in place.

The :class:`Engine` drives continuous batched decoding on the host and is
GAPP-instrumented: each request slot is a logical worker, so stalls from
uneven sequence lengths (a serialization bottleneck: one long request holds
the whole batch) surface directly in the CMetric profile.  The step runs
eagerly (the reference's ``jax.jit`` has no counterpart here); the host
reads the step's tokens once, with one ``tolist()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models import decode_step, forward, init_decode_state
from repro_torch.models.common import ModelConfig, tree_leaves


def make_prefill_step(cfg: ModelConfig, **fw_kwargs) -> Callable:
    def prefill(params, batch):
        logits, _ = forward(params, batch, cfg, **fw_kwargs)
        return logits[:, -1]
    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, tokens, pos, state, memory=None):
        logits, state = decode_step(params, tokens, pos, state, cfg,
                                    memory=memory)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, state
    return step


#: The matrices the model reads in float32 whatever the compute dtype: the
#: MoE router (``moe_ffn``), RWKV-6's decay projections (``_rwkv_project``)
#: and its bonus (``rwkv_tmix``, ``rwkv_tmix_step``).
FLOAT32_MATRICES = frozenset({"router", "decay_w1", "decay_w2", "bonus_u"})


def _serving_params(params, cfg: ModelConfig):
    """The tree with every matrix in ``cfg.compute_dtype``, made once.

    The model functions cast each matrix to the compute dtype where they
    use it (``.to(cdt)``, a no-op on a matrix already in it), so this copy
    gives the values of the per-call casts without a cast per step.  Norm
    scales, biases and the matrices in :data:`FLOAT32_MATRICES` (vectors
    and those keys) stay as they are, since the model reads those in
    float32."""
    def walk(tree, keep=False):
        if isinstance(tree, dict):
            return {k: walk(v, k in FLOAT32_MATRICES)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree if keep or tree.ndim < 2 else tree.to(cfg.compute_dtype)
    return walk(params)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)


class Engine:
    """Small continuous-batching decode engine (host loop).

    ``device`` (the port's default device when None) is resolved once; the
    parameters must already lie there.  The engine keeps a copy of them
    with every matrix in the compute dtype (:func:`_serving_params`).
    Like the reference, ``submit`` does not prefill the prompt: a request
    decodes from its last prompt token at position ``len(prompt) - 1``,
    over cache slots that hold zeros or a previous request's K/V, and a
    recurrent block's state, which a slot's previous request left."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 cache_len: int, gapp=None, *, device=None):
        self.device = device_lib.resolve(device)
        dev = self.device
        bad = {str(x.device) for x in tree_leaves(params)
               if x.device.type != dev.type
               or dev.index not in (None, x.device.index)}
        if bad:
            raise ValueError(f"Engine on {self.device}: parameters on "
                             f"{sorted(bad)}")
        self.cfg = cfg
        self.params = _serving_params(params, cfg)
        self.slots = batch_slots
        self.cache_len = cache_len
        self.state = init_decode_state(cfg, batch_slots, cache_len,
                                       device=self.device)
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int32,
                                  device=self.device)
        self.pos = torch.zeros((batch_slots,), dtype=torch.int32,
                               device=self.device)
        self.active: list[Request | None] = [None] * batch_slots
        self._step = make_decode_step(cfg)
        self.gapp = gapp
        if gapp is not None:
            self.slot_wids = [gapp.register_worker(f"slot{i}", "device")
                              for i in range(batch_slots)]

    def submit(self, req: Request) -> bool:
        for i in range(self.slots):
            if self.active[i] is None:
                self.active[i] = req
                self.tokens[i] = int(req.prompt[-1])
                self.pos[i] = len(req.prompt) - 1
                if self.gapp is not None:
                    self.gapp.begin(self.slot_wids[i], f"decode/req{req.rid}")
                return True
        return False

    def step(self) -> list[Request]:
        """One decode step for all active slots; returns finished requests."""
        next_tok, _, self.state = self._step(self.params, self.tokens,
                                             self.pos, self.state)
        self.tokens = next_tok
        self.pos = self.pos + 1
        toks = next_tok.tolist()        # the step's one read on the host
        done = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(toks[i])
            if len(req.out) >= req.max_new:
                done.append(req)
                self.active[i] = None
                if self.gapp is not None:
                    self.gapp.end(self.slot_wids[i])
        return done

    def run(self, requests: list[Request]) -> list[Request]:
        pending = list(requests)
        finished: list[Request] = []
        while pending or any(r is not None for r in self.active):
            while pending and self.submit(pending[0]):
                pending.pop(0)
            finished += self.step()
        return finished
