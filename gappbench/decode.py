"""The decode entry: ``serve.Engine`` at full occupancy under a standing
backlog (offline or batch generation), with or without a GAPP session.

Set-up makes the weights (bf16, as served) and the prompts' K/V on the
device from the seed, builds the engine, fills every slot's cache with
its prompt rows and runs the warm-up steps.  The window then drives
``Engine.submit`` and ``Engine.step`` as ``Engine.run`` does, until
``seconds`` have passed.

The engine has no prefill: a request decodes from its prompt's last token
at position ``len(prompt) - 1`` over whatever the slot's cache holds.  The
benchmark stands in for the prefill stage of a disaggregated deployment:
when a request takes a slot, the rows its predecessor wrote are given back
their prompt K/V (the slot's rows of the bank, rotated by the slot's
offset), so every request decodes over its own prompt's rows.

Where each layer's cache sits and how many rows it has is the
configuration's family's (``cell.CacheLayer``): position ``p`` lies at
row ``p % rows`` of a layer, so a ring of a window's rows holds the last
of a prompt's positions, and its prompt K/V is the layer's bank row
``(p + offset) % rows``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gappbench import cell as cell_lib
from gappbench import gapp_check, weights
from gappbench.reference import model as ref
from gappbench.traffic import generate


@dataclasses.dataclass
class Live:
    """One run's state: the program's objects and what the harness saw."""

    engine: object
    session: object
    layout: list          # the family's cell.CacheLayer, one a layer
    bank: tuple
    offsets: np.ndarray
    pending: list
    slot_of: dict = dataclasses.field(default_factory=dict)
    dirty: dict = dataclasses.field(default_factory=dict)
    finished: list = dataclasses.field(default_factory=list)
    submitted: int = 0
    issue_s: list = dataclasses.field(default_factory=list)
    drain_s: list = dataclasses.field(default_factory=list)


def _kv(engine, c) -> tuple:
    kv = engine.state[c.group][c.block]["kv"]
    return kv["k"], kv["v"]


def _restore(live: Live, slot: int, lo: int, hi: int) -> None:
    """Give positions [lo, hi) of ``slot`` back their prompt K/V, in each
    layer at the rows that hold them (a ring's, the last of them)."""
    if hi <= lo:
        return
    bk, bv = live.bank
    off = int(live.offsets[slot])
    idx = {}
    for layer, c in enumerate(live.layout):
        a = max(lo, hi - c.rows)
        if c.rows not in idx:
            bank_rows = torch.arange(a, hi, device=bk[layer].device)
            at = a % c.rows
            cache_rows = slice(at, at + hi - a) if at + hi - a <= c.rows \
                else bank_rows % c.rows
            idx[c.rows] = ((bank_rows + off) % c.rows, cache_rows)
        src, dst = idx[c.rows]
        k, v = _kv(live.engine, c)
        k[slot, dst] = bk[layer][src]
        v[slot, dst] = bv[layer][src]


def _fill(live: Live) -> None:
    """Every slot's whole cache from the bank (rotated by its offset)."""
    bk, bv = live.bank
    for layer, c in enumerate(live.layout):
        k, v = _kv(live.engine, c)
        rows = c.rows
        if k.shape[1] != rows or bk[layer].shape[0] != rows:
            raise RuntimeError(
                f"cache layer {c}: the engine holds {k.shape[1]} rows and "
                f"the bank {bk[layer].shape[0]}")
        for slot, off in enumerate(live.offsets.tolist()):
            off %= rows
            k[slot, :rows - off] = bk[layer][off:]
            k[slot, rows - off:] = bk[layer][:off]
            v[slot, :rows - off] = bv[layer][off:]
            v[slot, rows - off:] = bv[layer][:off]


def _wrap_step(live: Live) -> None:
    """Time the host's issue of each step (the call, which returns before
    the device is done)."""
    engine = live.engine
    real = engine._step

    def step(*a, **k):
        t = time.perf_counter()
        out = real(*a, **k)
        live.issue_s.append(time.perf_counter() - t)
        return out
    engine._step = step


def setup(cell, seed: int, device) -> Live:
    from repro_torch.core import ProfileSession
    from repro_torch.serve.engine import Engine
    mix, s = cell.traffic, cell.shape
    cfg = cell_lib.model_config(s, cell.config_name)
    params = weights.make_params(s, seed, torch.bfloat16, device)
    session = None
    if mix.get("gapp"):
        if device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()
        session = ProfileSession(n_min=mix["gapp"].get("n_min"),
                                 dt=mix["gapp"]["dt"], device=device)
    engine = Engine(cfg, params, batch_slots=mix["slots"],
                    cache_len=mix["cache_len"], gapp=session, device=device)
    rng = np.random.default_rng([seed, 7])
    live = Live(engine, session,
                cell_lib.family_of(s).cache_layers(s, mix["cache_len"]),
                weights.make_bank(s, seed, mix["cache_len"], device),
                rng.integers(0, mix["cache_len"], size=mix["slots"]),
                generate.decode_requests(mix, seed, s.vocab)[::-1])
    _fill(live)
    _wrap_step(live)
    if session is not None:
        gapp_check.time_drains(session, live.drain_s)
        session.start()
    for _ in range(mix["warmup_steps"]):
        _one_step(live)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    live.issue_s.clear()
    live.drain_s.clear()
    return live


def _admit(live: Live) -> None:
    from repro_torch.serve.engine import Request
    engine = live.engine
    while live.pending and any(a is None for a in engine.active):
        r = live.pending[-1]
        prompt = np.full(r["start"] + 1, r["last_token"], np.int64)
        req = Request(rid=r["rid"], prompt=prompt, max_new=r["max_new"])
        if not engine.submit(req):
            break
        live.pending.pop()
        live.submitted += 1
        slot = next(i for i, a in enumerate(engine.active) if a is req)
        lo, hi = live.dirty.get(slot, (0, 0))
        _restore(live, slot, lo, hi)
        live.dirty[slot] = (r["start"], r["start"] + r["max_new"])
        live.slot_of[r["rid"]] = (slot, r)


def _one_step(live: Live) -> tuple[int, int, list]:
    """Admit, then one engine step; ``(tokens, rows, positions)``: the
    tokens it emitted, the cache rows its slots attend in a whole cache
    and the positions its slots decode at."""
    _admit(live)
    engine = live.engine
    tokens = rows = 0
    positions = []
    for req in engine.active:
        if req is not None:
            tokens += 1
            n = len(req.prompt) + len(req.out)
            rows += n
            positions.append(n - 1)
    for req in engine.step():
        live.finished.append(req)
    return tokens, rows, positions


def window(live: Live, seconds: float, mark=None) -> dict:
    """Steps until ``seconds`` have passed; the window's record."""
    step_s, toks, rows, positions = [], [], [], []
    n_done0 = len(live.finished)
    t0 = time.perf_counter()
    last = t0
    t_end = t0 + seconds
    while last < t_end:
        if mark is not None:
            with mark("gappbench/engine.step"):
                n, r, pos = _one_step(live)
        else:
            n, r, pos = _one_step(live)
        now = time.perf_counter()
        step_s.append(now - last)
        toks.append(n)
        rows.append(r)
        positions.append(pos)
        last = now
    done = live.finished[n_done0:]
    return {"entry": "decode", "window_s": last - t0, "step_s": step_s,
            "tokens": toks, "rows": rows, "positions": positions,
            "issue_s": list(live.issue_s),
            "drain_s": list(live.drain_s),
            "attempted": len(done),
            "failed": sum(len(r.out) != r.max_new for r in done)}


def close(live: Live) -> dict:
    """Stop the session and read what the check needs from the program;
    the program's state is dropped."""
    out = {"finished": [(r.rid, list(r.out)) for r in live.finished],
           "slot_of": dict(live.slot_of), "gapp": None}
    if live.session is not None:
        cap = gapp_check.capture(live.session)
        why = gapp_check.capture_complete(cap, live.submitted,
                                          len(live.finished))
        out["gapp"] = (cap, why)
    live.engine = live.session = None
    return out


def sample(finished: list, seed: int, k: int) -> list:
    """The checked requests: the longest finished one and ``k - 1`` more
    drawn from the seed."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng([seed, 11])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def reference_gaps(cell, seed: int, device, closed: dict, bank, offsets,
                   mm_names=("plain",)) -> dict:
    """For each product in ``mm_names`` (``plain``: the reference,
    ``fp8``: the control), the widest gap over the checked requests by
    which a token lies below the float32 reference's best logit: the
    program's served token for ``plain``, the control's first choice at
    the same position for ``fp8``.  Under ``untied`` the same over each
    request's tokens before the first that the reference routes by a tie
    (``ties`` of the family's ``decode_logits``; a family that routes
    nothing has none): from there on, the program may rightly have routed
    otherwise, and its cache rows then differ too."""
    ref.no_tf32()
    s = cell.shape
    params = weights.make_params(s, seed, torch.bfloat16, device)
    bk, bv = bank
    layers = range(len(bk))
    gaps = {name: 0.0 for name in mm_names}
    untied = dict(gaps)
    n_tokens = n_untied = 0
    for rid, out in sample(closed["finished"], seed,
                           cell.traffic["check"]["requests"]):
        slot, r = closed["slot_of"][rid]
        start = r["start"]
        at = torch.arange(start, device=device) + int(offsets[slot])
        ctx_k = [bk[i][at % bk[i].shape[0]] for i in layers]
        ctx_v = [bv[i][at % bv[i].shape[0]] for i in layers]
        tokens = torch.tensor([r["last_token"]] + out[:-1], device=device)
        served = torch.tensor(out, device=device)
        ties: list = []
        with torch.no_grad():
            logits = ref.decode_logits(params, tokens, start, ctx_k, ctx_v,
                                       s, ties=ties)
            chosen = {"plain": served}
            if "fp8" in gaps:
                chosen["fp8"] = ref.decode_logits(
                    params, tokens, start, ctx_k, ctx_v, s,
                    mm=ref.fp8_mm).argmax(dim=-1)
        cut = min(ties, default=len(out))
        for name in gaps:
            gaps[name] = max(gaps[name], ref.widest_gap(logits, chosen[name]))
            if cut:
                untied[name] = max(untied[name], ref.widest_gap(
                    logits[:cut], chosen[name][:cut]))
        n_tokens += len(out)
        n_untied += cut
    gaps.update(tokens=n_tokens, untied=untied, tokens_untied=n_untied)
    return gaps
