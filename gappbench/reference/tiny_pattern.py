"""The plain reference of the ``tiny-pattern`` family, in float32 PyTorch
with TF32 off: blocks of the configured pattern, each pre-norm RMSNorm,
rotary GQA attention (``local``: each position sees the ``window``
positions up to itself; ``moe``: every position up to itself), then a
SwiGLU MLP (``local``) or an expert FFN (``moe``).

The expert FFN routes as the configuration states: softmax over a
float32 router's logits, the top ``top_k`` renormalised, every chosen
expert's SwiGLU weighted by its probability, and no token dropped.  Each
expert is computed here over every token and weighed 0 where it was not
chosen.  The router's auxiliary loss (``aux_weight * E * sum(first
choices' share * mean probability)`` a layer) is added to the training
objective.  In decode the reference can route as the program did instead
(``decode_logits(..., routes=...)``): the program's choices, weighted by
the reference's own probabilities, and beside them how far each choice
lies from one the reference would make.  It imports nothing of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from gappbench.reference.common import f32, plain_mm, rms_norm, rope

def attention(p, h, pos, s, mm, window=None, ctx=None):
    """Causal attention of h (B, S, D) at positions ``pos`` (S,), each
    query over the keys at most ``window - 1`` positions before it
    (``window`` None: all).  ``ctx``: (k, v) of (B, C, KV, hd) rows at
    positions 0 .. C-1, placed before the new rows."""
    b, n, _ = h.shape
    hd, g = s.head_dim, s.heads // s.kv_heads
    q = rope(mm(h, f32(p["wq"])).reshape(b, n, s.heads, hd), pos,
             s.rope_theta)
    k = rope(mm(h, f32(p["wk"])).reshape(b, n, s.kv_heads, hd), pos,
             s.rope_theta)
    v = mm(h, f32(p["wv"])).reshape(b, n, s.kv_heads, hd)
    key_pos = pos
    if ctx is not None:
        c = ctx[0].shape[1]
        k = torch.cat([ctx[0], k], dim=1)
        v = torch.cat([ctx[1], v], dim=1)
        key_pos = torch.cat([torch.arange(c, device=h.device,
                                          dtype=pos.dtype), pos])
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)    # (B, H, C+S, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) * (hd ** -0.5)                 # (B, H, S, hd)
    scores = mm(q, k.transpose(-1, -2))
    back = pos[:, None] - key_pos[None, :]               # (S, C+S)
    allowed = back >= 0
    if window is not None:
        allowed &= back < window
    scores = scores.masked_fill(~allowed, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v)           # (B, H, S, hd)
    out = out.transpose(1, 2).reshape(b, n, s.heads * hd)
    return mm(out, f32(p["wo"]))


def mlp(p, h, mm, names=("gate", "up", "down"), expert=None):
    w = [f32(p[x]) if expert is None else f32(p[x][expert]) for x in names]
    return mm(F.silu(mm(h, w[0])) * mm(h, w[1]), w[2])


def experts(p, h, s, mm, route=None, reroute=None, own_gap=False):
    """The expert FFN of h (B, S, D): its output, the router's auxiliary
    loss, and the route gap (B, S) where ``route`` is given.  ``route``
    (B, S, top_k): the experts to run in place of the reference's own top
    ``top_k``, each weighted by the reference's probability, renormalised
    over them; the route gap is how far the lowest of their float32 router
    logits lies below the float32 router's ``top_k``-th best (0 where the
    two sets agree).  ``reroute(logits, route)`` replaces ``route`` first,
    from the router's logits (B, S, E): a fault planted in the routes.
    ``own_gap``: the route gap reads the ``top_k`` that ``mm``'s own
    router logits would choose here, in place of ``route``'s (a lower
    precision's choices, while the experts run are still ``route``'s)."""
    logits = mm(h, f32(p["router"]))                         # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gap = None
    if route is None:
        top_p, top_e = torch.topk(probs, s.top_k, dim=-1)
    else:
        top_e = route.long()
        if reroute is not None:
            top_e = reroute(logits, top_e)
        top_p = probs.gather(-1, top_e)
        exact = plain_mm(h, f32(p["router"]))
        read = torch.topk(logits, s.top_k, dim=-1).indices if own_gap \
            else top_e
        kth = torch.topk(exact, s.top_k, dim=-1).values[..., -1]
        gap = kth - exact.gather(-1, read).min(dim=-1).values
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    gate = torch.zeros_like(probs).scatter(-1, top_e, top_p)
    out = 0.0
    for e in range(s.experts):
        out = out + gate[..., e:e + 1] * mlp(
            p, h, mm, ("we_gate", "we_up", "we_down"), expert=e)
    first = F.one_hot(top_e[..., 0], s.experts).float().mean(dim=(0, 1))
    aux = s.aux_weight * s.experts * torch.sum(first
                                               * probs.mean(dim=(0, 1)))
    return out, aux, gap


def block(p, x, pos, s, mm, kind: str, ctx=None, route=None,
          reroute=None, own_gap=False):
    """One block: ``(x, aux, gap)``: ``gap`` the route gap of
    :func:`experts` where ``route`` is given (None otherwise, and in a
    block that routes nothing)."""
    window = s.window if kind == "local" else None
    x = x + attention(p["attn"], rms_norm(x, f32(p["ln1"]), s.eps), pos, s,
                      mm, window, ctx)
    h = rms_norm(x, f32(p["ln2"]), s.eps)
    if kind == "moe":
        f, aux, gap = experts(p["ffn"], h, s, mm, route, reroute, own_gap)
        return x + f, aux, gap
    return x + mlp(p["ffn"], h, mm), x.new_zeros(()), None


def _blocks(params, s):
    for path, kind in s.blocks():
        p = params
        for key in path:
            p = p[key]
        yield p, kind


def lm_loss(params, tokens, frontend, s, mm=plain_mm, remat: bool = True,
            keep_rows=None):
    """Mean next-token cross entropy over the tokens (the last of each row
    has no target) plus the expert layers' auxiliary losses; ``frontend``
    is None (the family has no prefix)."""
    if keep_rows is not None:
        tokens = tokens[keep_rows]
    x = f32(params["embed"])[tokens.long()]
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    aux = 0.0
    for p, kind in _blocks(params, s):
        if remat and torch.is_grad_enabled():
            x, a, _ = torch.utils.checkpoint.checkpoint(
                block, p, x, pos, s, mm, kind, use_reentrant=False)
        else:
            x, a, _ = block(p, x, pos, s, mm, kind)
        aux = aux + a
    x = rms_norm(x, f32(params["final_norm"]), s.eps)
    logits = mm(x[:, :-1], f32(params["lm_head"]))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long()) + aux


def decode_logits(params, tokens, start: int, ctx_k, ctx_v, s, mm=plain_mm,
                  routes=None, route_gaps=None, reroute=None,
                  own_route_gap=False):
    """Logits (n, V) at positions start .. start+n-1 of one sequence whose
    tokens there are ``tokens`` (n,), over each attention layer's prompt
    rows ``ctx_k[i]``, ``ctx_v[i]`` at positions 0 .. start-1 (a local
    layer's band leaves out all but its window's).

    ``routes`` (n, expert layers, top_k): each token's experts in each
    expert layer, in the order the layers run, to route by in place of the
    reference's own choice (:func:`experts`); ``route_gaps``, a list, then
    gets each expert layer's route gaps (n,).  ``reroute``, and
    ``own_route_gap`` (``own_gap``): see :func:`experts`."""
    x = f32(params["embed"])[tokens.long()][None]
    pos = start + torch.arange(tokens.shape[0], device=x.device,
                               dtype=torch.float32)
    j = 0
    for i, (p, kind) in enumerate(_blocks(params, s)):
        ctx = (ctx_k[i][None].float(), ctx_v[i][None].float())
        route = None
        if routes is not None and kind == "moe":
            route = routes[None, :, j]
            j += 1
        x, _, gap = block(p, x, pos, s, mm, kind, ctx, route, reroute,
                          own_route_gap)
        if gap is not None and route_gaps is not None:
            route_gaps.append(gap[0])
    x = rms_norm(x[0], f32(params["final_norm"]), s.eps)
    return mm(x, f32(params["lm_head"]))
