"""The port's recurrent blocks (RG-LRU, RWKV-6) against the JAX package, on
the CPU.

The same parameters (the reference's init, carried across with
``convert.params_from_numpy``) and the same inputs (numpy, from a seed) go
through the jitted ``repro.models.recurrent`` functions and the port's.
Tolerances: float32 compute rtol/atol 1e-4 (the same float32 operations,
summed in another order; the associative scan combines in another tree
order), gradients too; bfloat16 compute 0.15 / 0.15, the reference's own
bound for its bf16 paths (tests/test_models.py).  The port's own
chunked-against-sequential and block-against-step checks mirror the
reference's (tests/test_models.py) at its 3e-2.  The serving copy decodes
bit for bit as the masters do, and the engine's tokens equal the
reference engine's exactly.  The recurrent archs' ``lm_loss`` gradients
against ``jax.grad`` are in tests/test_torch_train.py with the other
archs'.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_lm as jinit_lm
from repro.models import recurrent as jrec
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.examples import serve_engine
from repro_torch.models import cross_memory, decode_step, init_decode_state
from repro_torch.models import init_lm as tinit_lm
from repro_torch.models import recurrent as trec
from repro_torch.models.common import tree_items, tree_map
from repro_torch.serve import engine as tengine

RG, RWKV = "recurrentgemma-2b", "rwkv6-1.6b"
F32 = (1e-4, 1e-4)
BF16 = (0.15, 0.15)
ORACLE = (3e-2, 3e-2)      # tests/test_models.py's recurrent oracles
B = 2
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def cfg_pair(arch: str, dtype: str = "f32"):
    jdt, tdt = _DT[dtype]
    return (dataclasses.replace(jconfigs.get_tiny(arch), compute_dtype=jdt),
            dataclasses.replace(tconfigs.get_tiny(arch), compute_dtype=tdt))


@functools.lru_cache(maxsize=None)
def ref_params(which: str):
    """The reference's float32 parameters of one mix, as numpy."""
    init, arch, seed = {"rglru": (jrec.init_rglru, RG, 1),
                        "tmix": (jrec.init_rwkv_tmix, RWKV, 1),
                        "cmix": (jrec.init_rwkv_cmix, RWKV, 2)}[which]
    return jax.tree.map(np.asarray,
                        init(jax.random.PRNGKey(seed),
                             jconfigs.get_tiny(arch)))


def pair(which: str):
    """(reference params as JAX arrays, port params as CPU tensors)."""
    p = ref_params(which)
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")


def inputs(shape, dtype: str, seed: int = 0, scale: float = 0.5):
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    jdt, tdt = _DT[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32),
                               rtol=tol[0], atol=tol[1])


def trees_close(t_tree, j_tree, tol):
    jt = dict(tree_items(jax.tree.map(np.asarray, j_tree)))
    tt = dict(tree_items(t_tree))
    assert list(tt) == list(jt)
    for path, t in tt.items():
        np.testing.assert_allclose(
            t.detach().float().numpy(), np.asarray(jt[path], np.float32),
            rtol=tol[0], atol=tol[1], err_msg=str(path))


def jitted(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg=cfg, **kw))


TOL = {"f32": F32, "bf16": BF16}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["rglru", "tmix", "cmix"])
def test_init_has_the_reference_structure(which):
    """Keys, shapes and dtypes; the constant leaves (gate biases, mixes,
    decay base, Λ) equal; the drawn ones at dense_init's fan-in scale."""
    arch = RG if which == "rglru" else RWKV
    cfg = tconfigs.get_tiny(arch)
    init = {"rglru": trec.init_rglru, "tmix": trec.init_rwkv_tmix,
            "cmix": trec.init_rwkv_cmix}[which]
    tp = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = ref_params(which)
    assert sorted(tp) == sorted(ref)
    for k, v in ref.items():
        assert tuple(tp[k].shape) == v.shape and \
            str(tp[k].dtype).removeprefix("torch.") == v.dtype.name, k
        if not k.startswith("w") and k not in ("conv_w", "decay_w1",
                                                "decay_w2", "bonus_u",
                                                "gate_a_w", "gate_x_w"):
            np.testing.assert_allclose(tp[k].numpy(), v, rtol=1e-6,
                                       err_msg=k)
    w = tp["wo" if "wo" in tp else "wr"].numpy()
    assert abs(w.std() * np.sqrt(w.shape[0]) - 1.0) < 0.1


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_and_gates_match_the_reference(dtype):
    jc, tc = cfg_pair(RG, dtype)
    jp, tp = pair("rglru")
    ju, tu = inputs((B, 9, tc.lru), dtype)
    jdt, tdt = _DT[dtype]
    jconv = jrec._causal_conv(ju, jp["conv_w"].astype(jdt),
                              jp["conv_b"].astype(jdt))
    tconv = trec._causal_conv(tu, tp["conv_w"].to(tdt), tp["conv_b"].to(tdt))
    assert tconv.dtype == tdt
    close(tconv, jconv, TOL[dtype])
    ja, jg = jax.jit(functools.partial(jrec._rglru_gates, cfg=jc))(jp, ju)
    ta, tg = trec._rglru_gates(tp, tu, tc)
    assert ta.dtype == tg.dtype == torch.float32
    close(ta, ja, TOL[dtype])
    close(tg, jg, TOL[dtype])


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_block_matches_the_reference(dtype, carried):
    jc, tc = cfg_pair(RG, dtype)
    jp, tp = pair("rglru")
    jx, tx = inputs((B, 12, tc.d_model), dtype)
    js = ts = None
    if carried:
        js, ts = inputs((B, tc.lru), "f32", seed=1)
    jy, jh = jitted(jrec.rglru_block, jc)(jp, jx, state=js)
    ty, th = trec.rglru_block(tp, tx, tc, state=ts)
    assert ty.dtype == tc.compute_dtype and th.dtype == torch.float32
    close(ty, jy, TOL[dtype])
    close(th, jh, TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_step_matches_the_reference(dtype):
    """Six steps from a non-zero state; state dtypes as the reference's."""
    jc, tc = cfg_pair(RG, dtype)
    jp, tp = pair("rglru")
    js = jrec.init_rglru_state(jc, B)
    ts = trec.init_rglru_state(tc, B, device="cpu")
    assert ts["h"].dtype == torch.float32 and ts["conv"].dtype == \
        tc.compute_dtype
    assert tuple(ts["conv"].shape) == js["conv"].shape
    jh, th = inputs((B, tc.lru), "f32", seed=3)
    js, ts = dict(js, h=jh), dict(ts, h=th)
    step = jitted(jrec.rglru_step, jc)
    for t in range(6):
        jx, tx = inputs((B, 1, tc.d_model), dtype, seed=10 + t)
        jy, js = step(jp, jx, js)
        ty, ts = trec.rglru_step(tp, tx, ts, tc)
        close(ty, jy, TOL[dtype])
        close(ts["h"], js["h"], TOL[dtype])
        close(ts["conv"], js["conv"], TOL[dtype])


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_token_shift_and_projection_match_the_reference(dtype):
    jc, tc = cfg_pair(RWKV, dtype)
    jp, tp = pair("tmix")
    jx, tx = inputs((B, 8, tc.d_model), dtype)
    jprev, tprev = inputs((B, 1, tc.d_model), dtype, seed=1)
    assert torch.equal(trec._token_shift(tx, tprev).float(), torch.tensor(
        np.asarray(jrec._token_shift(jx, jprev), np.float32)))
    j = jax.jit(functools.partial(jrec._rwkv_project, cfg=jc))(jp, jx, jprev)
    t = trec._rwkv_project(tp, tx, tprev, tc)
    for name, a, b in zip("rkvg", t, j):
        assert a.dtype == tc.compute_dtype, name
        close(a, b, TOL[dtype])
    assert t[4].dtype == torch.float32
    close(t[4], j[4], TOL[dtype])


def _rwkv_state(cfg, dtype, seed):
    """A non-zero carried RWKV state: (reference, port)."""
    nh, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    js, ts = inputs((B, nh, hd, hd), "f32", seed=seed)
    jprev, tprev = inputs((B, 1, cfg.d_model), dtype, seed=seed + 1)
    return {"s": js, "prev": jprev}, {"s": ts, "prev": tprev}


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rwkv_tmix_matches_the_reference(dtype, carried):
    """Three chunks of 8 (the tiny chunk size), from zeros or a carried
    state."""
    jc, tc = cfg_pair(RWKV, dtype)
    jp, tp = pair("tmix")
    jx, tx = inputs((B, 24, tc.d_model), dtype)
    js, ts = _rwkv_state(tc, dtype, 5) if carried else (None, None)
    jy, jst = jitted(jrec.rwkv_tmix, jc)(jp, jx, state=js)
    ty, tst = trec.rwkv_tmix(tp, tx, tc, state=ts)
    assert ty.dtype == tc.compute_dtype and tst["s"].dtype == torch.float32
    close(ty, jy, TOL[dtype])
    close(tst["s"], jst["s"], TOL[dtype])
    assert torch.equal(tst["prev"], tx[:, -1:])


def test_rwkv_tmix_refuses_a_partial_chunk():
    _, tc = cfg_pair(RWKV)
    _, tp = pair("tmix")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        trec.rwkv_tmix(tp, torch.zeros(1, 12, tc.d_model), tc)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rwkv_tmix_step_and_cmix_match_the_reference(dtype):
    jc, tc = cfg_pair(RWKV, dtype)
    jp, tp = pair("tmix")
    jcp, tcp = pair("cmix")
    js, ts = _rwkv_state(tc, dtype, 7)
    init = trec.init_rwkv_state(tc, B, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        "s": ((B, 4, 16, 16), torch.float32),
        "prev": ((B, 1, tc.d_model), tc.compute_dtype)}
    step = jitted(jrec.rwkv_tmix_step, jc)
    cmix = jitted(jrec.rwkv_cmix, jc)
    jprev, tprev = inputs((B, 1, tc.d_model), dtype, seed=8)
    for t in range(5):
        jx, tx = inputs((B, 1, tc.d_model), dtype, seed=20 + t)
        jy, js = step(jp, jx, js)
        ty, ts = trec.rwkv_tmix_step(tp, tx, ts, tc)
        close(ty, jy, TOL[dtype])
        close(ts["s"], js["s"], TOL[dtype])
        jf, jprev = cmix(jcp, jx, prev=jprev)
        tf, tprev = trec.rwkv_cmix(tcp, tx, tc, prev=tprev)
        close(tf, jf, TOL[dtype])
    jx, tx = inputs((B, 6, tc.d_model), dtype, seed=30)
    close(trec.rwkv_cmix(tcp, tx, tc)[0], cmix(jcp, jx)[0], TOL[dtype])


# ---------------------------------------------------------------------------
# within the port: chained calls, the chunked form, the step forms
# ---------------------------------------------------------------------------

def test_rglru_chained_calls_equal_one_call():
    """A chained prefill carries ``h`` alone (the reference's contract),
    so the conv keeps only its current tap here: then the second call,
    seeded with the first's final state, continues the one call."""
    _, tc = cfg_pair(RG)
    _, tp = pair("rglru")
    tp = dict(tp, conv_w=torch.cat([torch.zeros_like(tp["conv_w"][:-1]),
                                    tp["conv_w"][-1:]]))
    _, tx = inputs((B, 16, tc.d_model), "f32")
    y, h = trec.rglru_block(tp, tx, tc)
    y1, h1 = trec.rglru_block(tp, tx[:, :8], tc)
    y2, h2 = trec.rglru_block(tp, tx[:, 8:], tc, state=h1)
    close(torch.cat([y1, y2], 1), y.numpy(), F32)
    close(h2, h.numpy(), F32)


def test_rwkv_chained_calls_equal_one_call():
    _, tc = cfg_pair(RWKV)
    _, tp = pair("tmix")
    _, tx = inputs((B, 32, tc.d_model), "f32")
    y, st = trec.rwkv_tmix(tp, tx, tc)
    y1, st1 = trec.rwkv_tmix(tp, tx[:, :16], tc)
    y2, st2 = trec.rwkv_tmix(tp, tx[:, 16:], tc, state=st1)
    close(torch.cat([y1, y2], 1), y.numpy(), F32)
    close(st2["s"], st["s"].numpy(), F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rwkv_chunked_equals_sequential(dtype):
    """The chunked time mix equals the token-by-token recurrence (the
    reference's own oracle, tests/test_models.py)."""
    _, tc = cfg_pair(RWKV, dtype)
    p = trec.init_rwkv_tmix(torch.Generator().manual_seed(1), tc,
                            device="cpu")
    _, x = inputs((B, 24, tc.d_model), dtype, seed=2)
    y_chunk, st_chunk = trec.rwkv_tmix(p, x, tc)
    st = trec.init_rwkv_state(tc, B, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y, st = trec.rwkv_tmix_step(p, x[:, t:t + 1], st, tc)
        ys.append(y)
    tol = F32 if dtype == "f32" else ORACLE
    close(y_chunk, torch.cat(ys, 1).float().numpy(), tol)
    close(st_chunk["s"], st["s"].numpy(), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_block_equals_step(dtype):
    _, tc = cfg_pair(RG, dtype)
    p = trec.init_rglru(torch.Generator().manual_seed(1), tc, device="cpu")
    _, x = inputs((B, 12, tc.d_model), dtype, seed=2)
    y_full, h_last = trec.rglru_block(p, x, tc)
    st = trec.init_rglru_state(tc, B, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y, st = trec.rglru_step(p, x[:, t:t + 1], st, tc)
        ys.append(y)
    tol = F32 if dtype == "f32" else ORACLE
    close(y_full, torch.cat(ys, 1).float().numpy(), tol)
    close(h_last, st["h"].numpy(), tol)


# ---------------------------------------------------------------------------
# the associative scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 33])
def test_scan_matches_a_float64_loop_and_the_reference(s):
    """Both combines: the RG-LRU's elementwise pair and RWKV's
    (decay, state) pair with the decay broadcast over the state's last
    axis, at lengths that are and are not powers of two."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.3, 1.0, (2, s, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, s, 3, 4)).astype(np.float32)
    u = rng.standard_normal((2, s, 3, 4, 4)).astype(np.float32)
    h = np.zeros((2, 3, 4))
    st = np.zeros((2, 3, 4, 4))
    want_h, want_s = [], []
    for t in range(s):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        st = a[:, t, ..., None].astype(np.float64) * st + u[:, t]
        want_h.append(h)
        want_s.append(st)
    want_h, want_s = np.stack(want_h, 1), np.stack(want_s, 1)
    _, got_h = trec._rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=1e-4, atol=1e-6)
    _, jh = jax.jit(jrec._rglru_scan)(jnp.asarray(a), jnp.asarray(b))
    close(got_h, jh, F32)

    def combine(left, right):
        a1, u1 = left
        a2, u2 = right
        return a1 * a2, a2[..., None] * u1 + u2
    got_a, got_s = trec.associative_scan(
        combine, (torch.from_numpy(a), torch.from_numpy(u)), dim=1)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.cumprod(
        a.astype(np.float64), axis=1), rtol=1e-4, atol=1e-7)
    _, js = jax.jit(lambda a, u: jax.lax.associative_scan(
        combine, (a, u), axis=1))(jnp.asarray(a), jnp.asarray(u))
    close(got_s, js, F32)


@pytest.mark.parametrize("which", ["rglru", "tmix"])
def test_block_gradients_match_jax_grad(which):
    """Float32 gradients of ``sum(y * c)`` for a fixed ``c``, with respect
    to every parameter, the input and the carried state, against
    ``jax.grad`` of the reference's block: the backward runs through the
    out-of-place folds (the virtual step 0, the scan, the chunk blocks)."""
    arch = RG if which == "rglru" else RWKV
    jc, tc = cfg_pair(arch)
    jp, tp = pair(which)
    s = 12 if which == "rglru" else 16
    jx, tx = inputs((B, s, tc.d_model), "f32")
    _, tcot = inputs((B, s, tc.d_model), "f32", seed=9, scale=1.0)
    if which == "rglru":
        js, ts = inputs((B, tc.lru), "f32", seed=1)
        jfn, tfn = jrec.rglru_block, trec.rglru_block
    else:
        js, ts = _rwkv_state(tc, "f32", 5)
        jfn, tfn = jrec.rwkv_tmix, trec.rwkv_tmix
    cot = jnp.asarray(tcot.numpy())

    def jloss(p, x, state):
        return jnp.sum(jfn(p, x, jc, state=state)[0] * cot)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jp, jx, js)
    leaves = tree_map(lambda t: t.clone().requires_grad_(), (tp, tx, ts))
    torch.sum(tfn(leaves[0], leaves[1], tc, state=leaves[2])[0]
              * tcot).backward()
    trees_close(tree_map(lambda t: t.grad, leaves), jg, F32)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_serving_copy_decodes_bit_equal_to_the_masters(arch):
    """The engine's serving copy (every matrix in bf16 except the ones the
    model reads in float32: the router, RWKV's decay projections and
    bonus) gives ``decode_step`` on the float32 masters' logits exactly,
    bf16 compute, four steps."""
    cfg = tconfigs.get_tiny(arch)
    assert cfg.compute_dtype == torch.bfloat16
    masters = tinit_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    served = tengine._serving_params(masters, cfg)
    for path, leaf in tree_items(served):
        keep = path[-1] in tengine.FLOAT32_MATRICES or leaf.ndim < 2
        assert leaf.dtype == (torch.float32 if keep else torch.bfloat16), \
            path
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 4)).astype(
        np.int32))
    mem = {}
    if cfg.enc_layers:
        feats = torch.from_numpy(rng.standard_normal(
            (B, 6, cfg.frontend_dim)).astype(np.float32))
        mem = {id(p): cross_memory(p, cfg, feats) for p in (masters, served)}
    states = {id(p): init_decode_state(cfg, B, 8, device="cpu")
              for p in (masters, served)}
    for t in range(tokens.shape[1]):
        pos = torch.full((B,), t, dtype=torch.int32)
        out = []
        for p in (masters, served):
            lg, states[id(p)] = decode_step(p, tokens[:, t], pos,
                                            states[id(p)], cfg,
                                            memory=mem.get(id(p)))
            out.append(lg)
        assert torch.equal(out[0], out[1]), (arch, t)


@functools.lru_cache(maxsize=None)
def _jax_lm(arch: str):
    jp = jinit_lm(jax.random.PRNGKey(0), jconfigs.get_tiny(arch))
    return jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_engine_gives_the_reference_engines_tokens(arch):
    """float32, 8 slots, cache 128, the serve_engine example's 16 requests:
    every token equal.  Neither engine resets a slot's recurrent state when
    a new request takes the slot (ROADMAP.md §3)."""
    jc, tc = cfg_pair(arch)
    jp, np_tree = _jax_lm(arch)
    want = jengine.Engine(jc, jp, 8, 128).run(
        [jengine.Request(r.rid, r.prompt, r.max_new)
         for r in serve_engine.make_requests(jc.vocab_size)])
    eng = tengine.Engine(tc, params_from_numpy(np_tree, device="cpu"), 8,
                         128, device="cpu")
    got = eng.run(serve_engine.make_requests(tc.vocab_size))
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        assert len(a.out) == a.max_new
        assert a.out == b.out, a.rid
