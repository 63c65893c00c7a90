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

Where the family's layers route tokens to experts (``route_layers``), a
:class:`RouteTap` keeps the experts the program chose at every step, from
the first warm-up step on, and the check judges the served tokens under
those choices.
"""
from __future__ import annotations

import contextlib
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
    tap: object = None    # a RouteTap where the family routes to experts


class RouteTap:
    """The experts the program chose in each expert layer at each step,
    held by reference: the tensors the program made, with no op, copy or
    read on the host added to the step.

    The port's ``moe_ffn`` hands each layer's choices ``top_e``
    (slots, 1, top_k) to ``repro_torch.models.moe._dispatch``; while the
    tap is open (a context manager, so that it is closed however the run
    ends) that function is wrapped and each call's ``top_e`` kept.  A step
    whose expert layers do not all show up, or that shows fewer rows than
    the engine's slots (a rank's share of a sharded batch), raises: the
    check cannot judge what it cannot see."""

    def __init__(self, layers: list, slots: int):
        self.layers, self.slots = layers, slots
        self.calls: list = []
        self.steps: list = []       # each step's choices, one an expert layer
        self.first_step: dict = {}  # request id -> its first step's index
        self._real = None

    def __enter__(self):
        from repro_torch.models import moe
        real = self._real = moe._dispatch

        def tap(x, top_e, *rest):
            self.calls.append(top_e)
            return real(x, top_e, *rest)
        moe._dispatch = tap
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._dispatch = self._real

    def admit(self, rid) -> None:
        """Request ``rid`` takes a slot before the next step."""
        self.first_step[rid] = len(self.steps)

    def take(self) -> None:
        """Keep the step's choices, one tensor an expert layer in order."""
        calls, self.calls = self.calls, []
        if len(calls) != len(self.layers):
            raise RuntimeError(
                f"the program showed {len(calls)} expert layers' choices in "
                f"a step; the family has {len(self.layers)}")
        rows = {int(c.shape[0]) for c in calls}
        if rows != {self.slots}:
            raise RuntimeError(
                f"the program's choices cover {sorted(rows)} rows a step; "
                f"the engine has {self.slots} slots")
        self.steps.append(calls)

    def record(self) -> dict:
        """What the check reads: every step's choices and where each
        request's first step lies."""
        return {"routes": self.steps, "first_step": dict(self.first_step)}


def route_tap(cell):
    """A :class:`RouteTap` for ``cell`` where its family routes tokens to
    experts; otherwise a context that taps nothing."""
    layers = cell_lib.route_layers(cell.shape)
    if not layers:
        return contextlib.nullcontext()
    return RouteTap(layers, cell.traffic["slots"])


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


def setup(cell, seed: int, device, tap=None) -> Live:
    """Weights, engine, caches and warm-up; ``tap``: the open
    :class:`RouteTap` of a family that routes tokens to experts."""
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
    live.tap = tap
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
        if live.tap is not None:
            live.tap.admit(r["rid"])


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
    if live.tap is not None:
        live.tap.take()
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
    if live.tap is not None:
        out.update(live.tap.record())
    if live.session is not None:
        cap = gapp_check.capture(live.session)
        why = gapp_check.capture_complete(cap, live.submitted,
                                          len(live.finished))
        out["gapp"] = (cap, why)
    live.engine = live.session = live.tap = None
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


def request_routes(closed: dict, rid: int, slot: int, n: int):
    """The experts the program chose for request ``rid``'s ``n`` tokens:
    (n, expert layers, top_k), from its slot's rows of the steps it
    decoded in."""
    t0 = closed["first_step"][rid]
    return torch.stack([torch.stack([r[slot, 0] for r in step])
                        for step in closed["routes"][t0:t0 + n]])


def wrong_route(logits, route):
    """A fault planted in the routes: each token's last choice moved to
    the expert the reference ranks last."""
    out = route.clone()
    out[..., -1] = logits.argmin(dim=-1)
    return out


def _logits(seq: tuple, routes, mm=ref.plain_mm, **routing):
    """The reference's logits over one checked request (``seq``: the
    arguments of ``decode_logits`` up to the shape), routed by ``routes``
    where the family routes tokens to experts."""
    kw = {} if routes is None else dict(routing, routes=routes)
    return ref.decode_logits(*seq, mm=mm, **kw)


def reference_gaps(cell, seed: int, device, closed: dict, bank, offsets,
                   modes=("program",)) -> dict:
    """The float32 reference's readings over the checked requests, for
    each of ``modes``: ``program``, the program's served tokens; ``control``,
    the tokens the float8 control puts first at each position of the same
    prompts and served tokens; ``wrong_route``, the program's tokens with
    :func:`wrong_route` planted in its routes.

    ``gap``: the widest gap by which such a token's logit lies below the
    reference's best.  Where the family routes tokens to experts, the
    reference (and the control) route each token as the program did
    (``request_routes``), and ``route``: the widest route gap over the
    tokens and expert layers, how far a choice lies below the float32
    router's ``top_k``-th logit: the program's choices (planted with the
    fault under ``wrong_route``), and the control's own, its float8
    router's ``top_k`` over its own residual stream; ``moved``: the
    layer-token pairs whose choices the program made otherwise than the
    reference."""
    ref.no_tf32()
    s = cell.shape
    routed = bool(cell_lib.route_layers(s))
    params = weights.make_params(s, seed, torch.bfloat16, device)
    bk, bv = bank
    layers = range(len(bk))
    gaps = {m: 0.0 for m in modes}
    route = dict(gaps)
    n_tokens = moved = 0
    for rid, out in sample(closed["finished"], seed,
                           cell.traffic["check"]["requests"]):
        slot, r = closed["slot_of"][rid]
        start = r["start"]
        at = torch.arange(start, device=device) + int(offsets[slot])
        ctx = ([bk[i][at % bk[i].shape[0]] for i in layers],
               [bv[i][at % bv[i].shape[0]] for i in layers])
        tokens = torch.tensor([r["last_token"]] + out[:-1], device=device)
        served = torch.tensor(out, device=device)
        seq = (params, tokens, start, *ctx, s)
        routes = request_routes(closed, rid, slot, len(out)) \
            if routed else None
        rg: dict = {m: [] for m in modes}
        with torch.no_grad():
            logits = _logits(seq, routes, route_gaps=rg["program"])
            judged = {"program": (logits, served)}
            if "control" in modes:
                judged["control"] = (logits, _logits(
                    seq, routes, mm=ref.fp8_mm, route_gaps=rg["control"],
                    own_route_gap=True).argmax(dim=-1))
            if "wrong_route" in modes:
                judged["wrong_route"] = (_logits(
                    seq, routes, route_gaps=rg["wrong_route"],
                    reroute=wrong_route), served)
        for m, (want, chosen) in judged.items():
            gaps[m] = max(gaps[m], ref.widest_gap(want, chosen))
            if rg[m]:
                route[m] = max(route[m], float(torch.stack(rg[m]).max()))
        if routed:
            moved += int((torch.stack(rg["program"]) > 0).sum())
        n_tokens += len(out)
    readings = {"gap": gaps, "tokens": n_tokens}
    if routed:
        readings.update(route=route, moved=moved)
    return readings
