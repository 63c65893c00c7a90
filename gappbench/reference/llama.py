"""The plain reference of the ``llama`` family: a llama-style decoder
(pre-norm RMSNorm, rotary attention with grouped K/V, SwiGLU) with an
optional projected patch prefix, in float32 PyTorch with TF32 off.

It follows the configurations' published description, with the port's
parameterisation of the norms (``x / rms(x) * (1 + scale)``, eps from the
configuration file) and the rotary form that rotates the two halves of a
head (``rotate_half``).  It imports nothing of the port: the weights are
the benchmark's, given as a tree of the port's keys, and read here by
path.

``mm`` is the product every matrix multiplication goes through: ``a @ b``
for the reference, a lower-precision emulation for the control
(``common.fp8_mm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from gappbench.reference.common import f32, plain_mm, rms_norm, rope


def attention(p, h, pos, s, mm, ctx=None, rows_from: int = 0):
    """Causal attention of h (B, S, D) at positions ``pos`` (S,).  ``ctx``:
    (k, v) of (B, C, KV, hd) rows that every position sees (a decode
    cache's prompt rows), placed before the new rows; ``rows_from`` the
    position of the first new row."""
    b, n, _ = h.shape
    hd, g = s.head_dim, s.heads // s.kv_heads
    q = rope(mm(h, f32(p["wq"])).reshape(b, n, s.heads, hd), pos,
             s.rope_theta)
    k = rope(mm(h, f32(p["wk"])).reshape(b, n, s.kv_heads, hd), pos,
             s.rope_theta)
    v = mm(h, f32(p["wv"])).reshape(b, n, s.kv_heads, hd)
    c = 0
    if ctx is not None:
        c = ctx[0].shape[1]
        k = torch.cat([ctx[0], k], dim=1)
        v = torch.cat([ctx[1], v], dim=1)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)    # (B, H, C+S, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) * (hd ** -0.5)                 # (B, H, S, hd)
    scores = mm(q, k.transpose(-1, -2))
    cols = torch.arange(c + n, device=h.device)
    allowed = cols[None, :] <= (c + torch.arange(n, device=h.device))[:, None]
    scores = scores.masked_fill(~allowed, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v)           # (B, H, S, hd)
    out = out.transpose(1, 2).reshape(b, n, s.heads * hd)
    return mm(out, f32(p["wo"]))


def mlp(p, h, mm):
    return mm(F.silu(mm(h, f32(p["gate"]))) * mm(h, f32(p["up"])),
              f32(p["down"]))


def layer(p, x, pos, s, mm, ctx=None):
    x = x + attention(p["attn"], rms_norm(x, f32(p["ln1"]), s.eps), pos, s,
                      mm, ctx)
    return x + mlp(p["ffn"], rms_norm(x, f32(p["ln2"]), s.eps), mm)


def _embed(params, tokens, frontend, mm):
    x = f32(params["embed"])[tokens.long()]
    if frontend is not None:
        x = torch.cat([mm(frontend.float(), f32(params["frontend"])), x],
                      dim=1)
    return x


def lm_loss(params, tokens, frontend, s, mm=plain_mm,
            remat: bool = True, keep_rows=None):
    """Mean next-token cross entropy over the tokens (the last of each row
    has no target; the patch prefix has none).  ``remat`` recomputes each
    layer in the backward, so a full-size step fits beside its state.
    ``keep_rows``: the batch rows the loss is averaged over (a fault that
    leaves rows out)."""
    if keep_rows is not None:
        tokens = tokens[keep_rows]
        frontend = None if frontend is None else frontend[keep_rows]
    x = _embed(params, tokens, frontend, mm)
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    for p in params["groups"]:
        blk = p["b0"]
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                layer, blk, x, pos, s, mm, use_reentrant=False)
        else:
            x = layer(blk, x, pos, s, mm)
    x = x[:, -tokens.shape[1]:]
    x = rms_norm(x, f32(params["final_norm"]), s.eps)
    logits = mm(x[:, :-1], f32(params["lm_head"]))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def decode_logits(params, tokens, start: int, ctx_k, ctx_v, s,
                  mm=plain_mm):
    """Logits (n, V) at positions start .. start+n-1 of one sequence whose
    tokens there are ``tokens`` (n,), over prompt rows ``ctx_k[l]``,
    ``ctx_v[l]`` (start, KV, hd) of each layer: a prefill of the new
    tokens against the prompt's cache."""
    x = f32(params["embed"])[tokens.long()][None]
    pos = start + torch.arange(tokens.shape[0], device=x.device,
                               dtype=torch.float32)
    for i, p in enumerate(params["groups"]):
        ctx = (ctx_k[i][None].float(), ctx_v[i][None].float())
        x = layer(p["b0"], x, pos, s, mm, ctx)
    x = rms_norm(x[0], f32(params["final_norm"]), s.eps)
    return mm(x, f32(params["lm_head"]))
