"""What the families' plain references share: the products (the plain
one, and the float8 control's), RMSNorm in the port's ``1 + scale`` form,
the rotary embedding that rotates a head's two halves, and the widest
logit gap the decode check compares.  Float32 PyTorch with TF32 off; it
imports nothing of the port."""
from __future__ import annotations

import math

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def plain_mm(a, b):
    return a @ b


def _q8(t, dim=None):
    """Round to float8 e4m3 with a scale per tensor (``dim`` None) or per
    slice along ``dim``; straight through in the backward."""
    amax = t.detach().abs().amax() if dim is None else \
        t.detach().abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def fp8_mm(a, b):
    """The control's product: both operands rounded to float8 e4m3 (``a``
    per row, ``b`` per column), multiplied in float32."""
    return _q8(a, -1) @ _q8(b, -2)


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, pos, theta: float):
    """x: (..., S, H, hd); pos: (S,) float positions."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = (pos[:, None] * freq)[:, None, :]          # (S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def f32(t):
    return t.float()


def widest_gap(logits, chosen) -> float:
    """The widest gap by which a chosen token's logit lies below the best
    logit of its row."""
    best = logits.max(dim=-1).values
    got = logits.gather(-1, chosen.long()[:, None])[:, 0]
    gap = (best - got).max()
    return float(gap) if math.isfinite(float(gap)) else float("inf")
