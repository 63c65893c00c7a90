"""Recurrent temporal-mix blocks: RG-LRU (recurrentgemma) and RWKV-6.

Both are linear recurrences ``h_t = a_t ⊙ h_{t-1} + b_t`` with
data-dependent decay.  As in the JAX package, the sequence dimension has
no token-level loop: the RG-LRU runs an associative scan over the
sequence, and RWKV-6 the chunked form (intra-chunk products plus an
associative scan over per-chunk state summaries).  The scan is
:func:`associative_scan`, a log-depth scan written in tensor ops (the
reference's ``jax.lax.associative_scan``); it sums in another tree order,
so float32 results agree to rounding, not bit for bit.

Every function builds new tensors (no in-place update), so autograd runs
through all of them.  Casts follow the reference line by line: products
in the compute dtype, decays, gates and the recurrent states in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, rms_norm
from repro_torch.sharding.api import constrain


def associative_scan(combine, elems: tuple, dim: int = 1) -> tuple:
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``combine((left...), (right...)) -> (...)``, for any
    length: ceil(log2(n)) rounds, each combining every element with the
    one ``2^k`` before it (Hillis-Steele).  Out of place."""
    n = elems[0].shape[dim]
    step = 1
    while step < n:
        left = tuple(e.narrow(dim, 0, n - step) for e in elems)
        right = tuple(e.narrow(dim, step, n - step) for e in elems)
        elems = tuple(torch.cat([e.narrow(dim, 0, step), c], dim=dim)
                      for e, c in zip(elems, combine(left, right)))
        step *= 2
    return elems


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma, arXiv:2402.19427)
# ---------------------------------------------------------------------------

_C = 8.0  # the paper's fixed scaling constant


def init_rglru(gen, cfg: ModelConfig, *, device=None) -> dict:
    d, r, w = cfg.d_model, cfg.lru, cfg.conv_width
    pdt = cfg.param_dtype
    dev = gen.device if device is None else device

    def init(shape):
        return dense_init(gen, shape, dtype=pdt, device=device)

    def zeros():
        return torch.zeros((r,), dtype=pdt, device=dev)

    return {
        "wx": init((d, r)),      # recurrence branch
        "wy": init((d, r)),      # gate branch
        "conv_w": init((w, r)),
        "conv_b": zeros(),
        # per-channel (diagonal) gates
        "gate_a_w": init((r,)),
        "gate_a_b": zeros(),
        "gate_x_w": init((r,)),
        "gate_x_b": zeros(),
        # Λ parametrised so that a = exp(-C softplus(Λ)·sigmoid(r_t))
        "log_lambda": torch.linspace(0.1, 0.9, r, dtype=torch.float32,
                                     device=dev).to(pdt),
        "wo": init((r, d)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv along S: x (B,S,R), w (W,R)."""
    width = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(width):
        shifted = F.pad(x, (0, 0, width - 1 - i, 0))[:, : x.shape[1]]
        out = out + shifted * w[i]
    return out + b


def _rglru_scan(a, b):
    """h_t = a_t ⊙ h_{t-1} + b_t via associative scan over S (dim 1)."""
    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 * a2, a2 * b1 + b2
    return associative_scan(combine, (a, b), dim=1)


def _rglru_gates(p, u, cfg: ModelConfig):
    uf = u.float()
    r_t = torch.sigmoid(uf * p["gate_a_w"].float() + p["gate_a_b"].float())
    i_t = torch.sigmoid(uf * p["gate_x_w"].float() + p["gate_x_b"].float())
    log_a = -_C * F.softplus(p["log_lambda"].float()) * r_t
    a = torch.exp(log_a)
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    gated = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a),
                                     log_a.new_tensor(1e-12))) * (i_t * uf)
    return a, gated


def rglru_block(p, x, cfg: ModelConfig, state=None):
    """Full-sequence RG-LRU temporal mix.  x: (B,S,D) -> (B,S,D).

    ``state``: optional (B,R) initial hidden state (chained prefill); the
    final state is returned for decode handoff."""
    cdt = cfg.compute_dtype
    y = F.gelu(x @ p["wy"].to(cdt), approximate="tanh")
    u = x @ p["wx"].to(cdt)
    u = _causal_conv(u, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
    u = constrain(u, "batch", "seq", "lru")
    a, gated = _rglru_gates(p, u, cfg)
    if state is not None:
        # fold the carried state in as a virtual step-0 contribution
        first = gated[:, :1] + a[:, :1] * state.float()[:, None]
        gated = torch.cat([first, gated[:, 1:]], dim=1)
    _, h = _rglru_scan(a, gated)
    h = constrain(h.to(cdt), "batch", "seq", "lru")
    out = (h * y) @ p["wo"].to(cdt)
    return constrain(out, "batch", "seq", "embed"), h[:, -1].float()


def rglru_step(p, x, state, cfg: ModelConfig):
    """One-token decode: x (B,1,D), state {'h': (B,R), 'conv': (B,W-1,R)}."""
    cdt = cfg.compute_dtype
    y = F.gelu(x @ p["wy"].to(cdt), approximate="tanh")
    u = x @ p["wx"].to(cdt)
    hist = torch.cat([state["conv"], u], dim=1)              # (B,W,R)
    w = p["conv_w"].to(cdt)
    u = torch.einsum("bwr,wr->br", hist, w)[:, None] + p["conv_b"].to(cdt)
    a, gated = _rglru_gates(p, u, cfg)
    h = a[:, 0] * state["h"] + gated[:, 0]
    out = (h[:, None].to(cdt) * y) @ p["wo"].to(cdt)
    return out, {"h": h, "conv": hist[:, 1:]}


def init_rglru_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    return {"h": torch.zeros((batch, cfg.lru), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru),
                                dtype=cfg.compute_dtype, device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 "Finch" (arXiv:2404.05892) — data-dependent decay time mix
# ---------------------------------------------------------------------------

def init_rwkv_tmix(gen, cfg: ModelConfig, *, device=None) -> dict:
    d = cfg.d_model
    nh = d // cfg.rwkv_head_dim
    pdt = cfg.param_dtype
    dev = gen.device if device is None else device

    def init(shape):
        return dense_init(gen, shape, dtype=pdt, device=device)

    def full(value):
        return torch.full((d,), value, dtype=pdt, device=dev)

    return {
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "wr": init((d, d)), "wk": init((d, d)), "wv": init((d, d)),
        "wg": init((d, d)),
        # data-dependent decay: w_t = exp(-exp(ω + tanh(x W1) W2))
        "decay_base": full(-6.0),
        "decay_w1": init((d, 64)),
        "decay_w2": init((64, d)),
        "bonus_u": init((nh, cfg.rwkv_head_dim)),
        "ln_x": full(0.0),
        "wo": init((d, d)),
    }


def _token_shift(x, prev):
    """x_{t-1} stream; ``prev`` (B,1,D) is the carried last token (decode/
    chained prefill) or zeros."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_project(p, x, prev, cfg: ModelConfig):
    cdt = cfg.compute_dtype
    xs = _token_shift(x, prev)

    def mix(m):
        return x + (xs - x) * m.to(cdt)
    r = mix(p["mix_r"]) @ p["wr"].to(cdt)
    k = mix(p["mix_k"]) @ p["wk"].to(cdt)
    v = mix(p["mix_v"]) @ p["wv"].to(cdt)
    g = mix(p["mix_g"]) @ p["wg"].to(cdt)
    dx = mix(p["mix_w"]).float()
    logw = -torch.exp(p["decay_base"].float()
                      + torch.tanh(dx @ p["decay_w1"].float())
                      @ p["decay_w2"].float())               # (B,S,D) ≤ 0
    return r, k, v, g, logw


def _heads(x, nh, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, nh, hd)


def rwkv_tmix(p, x, cfg: ModelConfig, state=None):
    """Chunked RWKV-6 time mix.  x: (B,S,D) -> (B,S,D).

    Per chunk of length c: intra-chunk attention-like products with decay
    weights (exact, float32 exponents masked to i ≤ t so they never
    overflow), inter-chunk via an associative scan over per-chunk
    (decay-product, state-update) summaries.  state: optional
    {'s': (B,NH,hd,hd), 'prev': (B,1,D)} carried across calls."""
    b, s, d = x.shape
    c = min(cfg.chunk_size, s)
    if s % c:
        raise ValueError(f"rwkv_tmix: sequence {s} is not a multiple of "
                         f"the chunk {c}")
    nc = s // c
    nh = d // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    f32 = torch.float32
    prev = state["prev"] if state is not None else x.new_zeros((b, 1, d))
    s0 = state["s"] if state is not None else torch.zeros(
        (b, nh, hd, hd), dtype=f32, device=x.device)

    r, k, v, g, logw = _rwkv_project(p, x, prev, cfg)
    rh = _heads(r, nh, hd).float().reshape(b, nc, c, nh, hd)
    kh = _heads(k, nh, hd).float().reshape(b, nc, c, nh, hd)
    vh = _heads(v, nh, hd).float().reshape(b, nc, c, nh, hd)
    lw = logw.reshape(b, nc, c, nh, hd)
    if cfg.opt_level >= 1:
        def hx(t):
            return constrain(t, "batch", None, None, "rwkv_heads", None)
        rh, kh, vh, lw = hx(rh), hx(kh), hx(vh), hx(lw)

    lsum = torch.cumsum(lw, dim=2)                  # L_t inclusive, ≤ 0, ↓
    ltot = lsum[:, :, -1]                           # (B,nc,NH,hd)
    lprev = lsum - lw                               # L_{t-1} (exclusive)
    # ----- intra-chunk: o_t += Σ_{i<t} (r_t · e^{L_{t-1}-L_i} ⊙ k_i) v_i,
    # assembled from sub-chunk blocks of m (see the reference): blocks
    # above the diagonal are zero, those below factor exactly through the
    # key sub-chunk's boundary decay M (both exponents ≤ 0), and diagonal
    # blocks apply the i<t mask before exp (argument ≤ 0).
    m = min(16, c)
    nsc = c // m
    shp = (b, nc, nsc, m, nh, hd)
    rs, ks_ = rh.reshape(shp), kh.reshape(shp)
    lps, lss = lprev.reshape(shp), lsum.reshape(shp)
    mbound = lss[:, :, :, -1]                       # (B,nc,nsc,NH,hd)
    tri_m = torch.tril(torch.ones((m, m), dtype=torch.bool, device=x.device),
                       diagonal=-1)[None, None, :, :, None, None]
    zero = lw.new_tensor(0.0)
    blocks = []
    for ti in range(nsc):
        row = []
        for si in range(nsc):
            if si > ti:
                row.append(torch.zeros((b, nc, nh, m, m), dtype=f32,
                                       device=x.device))
            elif si == ti:
                diff = lps[:, :, ti, :, None] - lss[:, :, si, None, :]
                w_pair = torch.where(
                    tri_m, torch.exp(torch.minimum(diff, zero)), 0.0)
                row.append(torch.einsum(
                    "btihd,bihd->bhti",
                    (w_pair * rs[:, :, ti, :, None]).reshape(
                        b * nc, m, m, nh, hd),
                    ks_[:, :, si].reshape(b * nc, m, nh, hd),
                ).reshape(b, nc, nh, m, m))
            else:
                mb = mbound[:, :, si]               # (B,nc,NH,hd)
                qt = rs[:, :, ti] * torch.exp(lps[:, :, ti] - mb[:, :, None])
                kt = ks_[:, :, si] * torch.exp(mb[:, :, None]
                                               - lss[:, :, si])
                row.append(torch.einsum("bnthd,bnihd->bnhti", qt, kt))
        blocks.append(torch.cat(row, dim=-1))
    att = torch.cat(blocks, dim=-2)                 # (B,nc,NH,c,c)
    if cfg.opt_level >= 1:
        att = constrain(att, "batch", None, "rwkv_heads", None, None)
    # bonus (u) diagonal term: i == t
    bonus = torch.einsum("bnthd,bnthd->bnht",
                         rh * p["bonus_u"].float(), kh)
    intra = torch.einsum("bnhti,bnihd->bnthd", att, vh) \
        + bonus.permute(0, 1, 3, 2)[..., None] * vh
    # ----- inter-chunk: per-chunk state summary then associative scan
    # chunk update: S_end = e^{ltot} ⊙_rows S_start + Σ_i e^{ltot-L_i} k_i v_iᵀ
    kdec = kh * torch.exp(ltot[:, :, None] - lsum)  # (B,nc,c,NH,hd)
    upd = torch.einsum("bnchk,bnchv->bnhkv", kdec,
                       vh)                          # (B,nc,NH,hd,hd)
    adec = torch.exp(ltot)                          # (B,nc,NH,hd)

    def combine(left, right):
        a1, u1 = left
        a2, u2 = right
        return a1 * a2, a2[..., None] * u1 + u2

    a_pfx, u_pfx = associative_scan(combine, (adec, upd), dim=1)
    # state at the *start* of each chunk (exclusive prefix, seeded with s0)
    s_starts = torch.cat([
        s0[:, None],
        a_pfx[:, :-1, :, :, None] * s0[:, None] + u_pfx[:, :-1]], dim=1)
    rdec = rh * torch.exp(lprev)                    # r̃_t = r_t e^{L_{t-1}}
    inter = torch.einsum("bnchk,bnhkv->bnchv", rdec, s_starts)
    o = (intra + inter).reshape(b, s, nh, hd)
    s_final = a_pfx[:, -1, :, :, None] * s0 + u_pfx[:, -1]
    # group norm per head + gate
    o = rms_norm(o, p["ln_x"].reshape(nh, hd)).reshape(b, s, d)
    cdt = cfg.compute_dtype
    out = (o.to(cdt) * F.silu(g)) @ p["wo"].to(cdt)
    out = constrain(out, "batch", "seq", "embed")
    return out, {"s": s_final, "prev": x[:, -1:]}


def rwkv_tmix_step(p, x, state, cfg: ModelConfig):
    """One-token decode.  x: (B,1,D)."""
    b, _, d = x.shape
    nh = d // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    r, k, v, g, logw = _rwkv_project(p, x, state["prev"], cfg)
    rh = _heads(r, nh, hd)[:, 0].float()
    kh = _heads(k, nh, hd)[:, 0].float()
    vh = _heads(v, nh, hd)[:, 0].float()
    w = torch.exp(logw[:, 0].reshape(b, nh, hd))
    s_prev = state["s"]
    kv = kh[..., :, None] * vh[..., None, :]          # (B,NH,hd,hd)
    o = torch.einsum("bhk,bhkv->bhv", rh,
                     s_prev + p["bonus_u"].float()[..., None] * kv)
    s_new = w[..., None] * s_prev + kv
    o = rms_norm(o, p["ln_x"].reshape(nh, hd)).reshape(b, 1, d)
    cdt = cfg.compute_dtype
    out = (o.to(cdt) * F.silu(g)) @ p["wo"].to(cdt)
    return out, {"s": s_new, "prev": x}


def init_rwkv_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    d = cfg.d_model
    nh = d // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    return {"s": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                             device=device),
            "prev": torch.zeros((batch, 1, d), dtype=cfg.compute_dtype,
                                device=device)}


def init_rwkv_cmix(gen, cfg: ModelConfig, *, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pdt = cfg.param_dtype
    dev = gen.device if device is None else device
    return {
        "mix_k": torch.full((d,), 0.5, dtype=pdt, device=dev),
        "mix_r": torch.full((d,), 0.5, dtype=pdt, device=dev),
        "wk": dense_init(gen, (d, f), dtype=pdt, device=device),
        "wv": dense_init(gen, (f, d), dtype=pdt, device=device),
        "wr": dense_init(gen, (d, d), dtype=pdt, device=device),
    }


def rwkv_cmix(p, x, cfg: ModelConfig, prev=None):
    """Channel mix (the RWKV FFN) with token shift."""
    cdt = cfg.compute_dtype
    prev = prev if prev is not None else torch.zeros_like(x[:, :1])
    xs = _token_shift(x, prev)

    def mix(m):
        return x + (xs - x) * m.to(cdt)
    k = torch.square(torch.relu(mix(p["mix_k"]) @ p["wk"].to(cdt)))
    k = constrain(k, "batch", "seq", "mlp")
    r = torch.sigmoid(mix(p["mix_r"]) @ p["wr"].to(cdt))
    out = r * (k @ p["wv"].to(cdt))
    return constrain(out, "batch", "seq", "embed"), x[:, -1:]
