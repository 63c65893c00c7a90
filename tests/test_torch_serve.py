"""The port's decode path and serving engine against the JAX package, on
the CPU, and the two examples of the slice.

Teacher-forced ``decode_step`` logits at every position against the
reference's (float32 compute rtol/atol 1e-4; bfloat16 0.15 / 0.15, the
reference's own bf16 bound), the ``Engine``'s output tokens equal to the
reference ``Engine``'s on the serve_engine example's requests (float32),
the in-place cache update against the functional one (exact), and the
``moe_imbalance`` what-if projection within 15% of its re-measured ground
truth (``benchmarks/bench_whatif.py``'s bound).
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import cross_memory as jcross_memory
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_lm as jinit_lm
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.examples import moe_imbalance, serve_engine
from repro_torch.models import attention as tattn
from repro_torch.models import cross_memory as tcross_memory
from repro_torch.models import decode_step as tdecode_step
from repro_torch.models import forward as tforward
from repro_torch.models import init_decode_state as tinit_decode_state
from repro_torch.models import init_lm as tinit_lm
from repro_torch.models.common import tree_map
from repro_torch.serve import engine as tengine

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = jconfigs.ARCHS
F32 = (1e-4, 1e-4)
BF16 = (0.15, 0.15)


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    jp = jinit_lm(jax.random.PRNGKey(0), jconfigs.get_tiny(arch))
    return jp, jax.tree.map(np.asarray, jp)


def cfg_pair(arch: str, dtype: str, **updates):
    jc, tc = jconfigs.get_tiny(arch), tconfigs.get_tiny(arch)
    if dtype == "f32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    return (dataclasses.replace(jc, **updates),
            dataclasses.replace(tc, **updates))


def close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_reference(arch, dtype):
    """Teacher-forced decode over 8 tokens, logits at every position (the
    MoE archs at capacity 8, the drop-free regime the reference's own
    decode test uses; the VLM decodes its tokens without the prefix)."""
    updates = {"capacity_factor": 8.0} if "grok" in arch or "arctic" in arch \
        else {}
    _check_decode(arch, *cfg_pair(arch, dtype, **updates), t_len=8,
                  cache_len=8, tol=F32 if dtype == "f32" else BF16)


def test_decode_past_the_local_window_matches_the_reference():
    """gemma3's local layers past their 8-slot ring: the port keeps the
    reference's linear-fill validity mask (ROADMAP.md §3)."""
    _check_decode("gemma3-1b", *cfg_pair("gemma3-1b", "f32"), t_len=12,
                  cache_len=16, tol=F32)


def _check_decode(arch, jc, tc, *, t_len, cache_len, tol):
    jp, np_tree = jax_params(arch)
    tp = params_from_numpy(np_tree, device="cpu")
    rng = np.random.default_rng(1)
    b = 2
    tokens = rng.integers(0, jc.vocab_size, (b, t_len)).astype(np.int32)
    jmem = tmem = None
    if jc.enc_layers:
        feats = rng.standard_normal((b, 12, jc.frontend_dim)).astype(
            np.float32)
        jmem = jcross_memory(jp, jc, jnp.asarray(feats))
        tmem = tcross_memory(tp, tc, torch.from_numpy(feats))
    jstate = jinit_decode_state(jc, b, cache_len)
    tstate = tinit_decode_state(tc, b, cache_len, device="cpu")
    jstep = jax.jit(functools.partial(jdecode_step, cfg=jc))
    for t in range(t_len):
        jl, jstate = jstep(jp, jnp.asarray(tokens[:, t]),
                           jnp.full((b,), t, jnp.int32), jstate, memory=jmem)
        tl, tstate = tdecode_step(tp, torch.from_numpy(tokens[:, t]),
                                  torch.full((b,), t, dtype=torch.int32),
                                  tstate, tc, memory=tmem)
        assert tl.dtype == torch.float32
        close(tl, jl, tol)


def test_decode_equals_forward_and_prefill_step():
    """Within the port: teacher-forced decode reproduces the forward
    logits at every position, and the prefill step's last-token logits."""
    _, tc = cfg_pair("qwen3-32b", "f32")
    tp = tinit_lm(torch.Generator().manual_seed(0), tc, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, 12)).astype(np.int32))
    full, _ = tforward(tp, {"tokens": tokens}, tc)
    state = tinit_decode_state(tc, 2, 16, device="cpu")
    for t in range(12):
        lg, state = tdecode_step(tp, tokens[:, t],
                                 torch.full((2,), t, dtype=torch.int32),
                                 state, tc)
        close(lg, full[:, t].numpy(), F32)
    last = tengine.make_prefill_step(tc)(tp, {"tokens": tokens})
    close(last, full[:, -1].numpy(), (1e-6, 1e-6))


def test_cache_update_in_place_equals_the_functional_update():
    """``decode_attention`` writes into the cache it was given and returns
    it; the values equal a write into a copy (the reference's functional
    ``.at[].set``), wrapped ring slots included."""
    _, tc = cfg_pair("gemma3-1b", "f32")
    tp = tinit_lm(torch.Generator().manual_seed(0), tc, device="cpu")
    p = tp["groups"][0]["b0"]["attn"]
    rng = np.random.default_rng(4)
    cache = tattn.init_kv_cache(tc, 3, 8, device="cpu")
    for step in range(11):          # past the 8-slot ring
        x = torch.from_numpy(rng.standard_normal(
            (3, 1, tc.d_model)).astype(np.float32))
        pos = torch.tensor([step, step + 2, 5], dtype=torch.int32)
        k_new, v_new = tattn._project_kv(p, x, tc, pos[:, None])
        want = {n: t.clone() for n, t in cache.items()}
        slot = (pos % 8).long()
        want["k"][torch.arange(3), slot] = k_new[:, 0]
        want["v"][torch.arange(3), slot] = v_new[:, 0]
        ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
        y, out = tattn.decode_attention(p, x, pos, cache, tc,
                                        window=tc.window)
        assert out is cache
        assert (out["k"].data_ptr(), out["v"].data_ptr()) == ptrs
        assert torch.equal(out["k"], want["k"])
        assert torch.equal(out["v"], want["v"])
        assert y.shape == (3, 1, tc.d_model)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-32b", "gemma3-1b",
                                  "grok-1-314b"])
def test_decode_attention_on_a_plain_cache_goes_through_the_kernel_wrapper(
        arch, monkeypatch):
    """``decode_attention`` on a cache that is not a DTensor calls
    ``kernels.ops.decode_attention`` once a step (its plain version on the
    CPU) and gives what the validity mask over the whole cache gave
    through ``_sdpa``: 20 steps over an 8-row cache, slots 0, 3 and 9 rows
    apart (gemma3's local ring wraps and then leaves its window; grok's
    softcap).  Float32, rtol/atol 1e-5: the same float32 arithmetic summed
    in another order."""
    _, tc = cfg_pair(arch, "f32")
    p = tinit_lm(torch.Generator().manual_seed(0), tc,
                 device="cpu")["groups"][0]["b0"]["attn"]
    window = tc.window if arch == "gemma3-1b" else None
    calls = []
    real = tattn.kernel_ops.decode_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(tattn.kernel_ops, "decode_attention", spy)
    rng = np.random.default_rng(5)
    cache = tattn.init_kv_cache(tc, 3, 8, device="cpu")
    rows = torch.arange(3)
    for step in range(20):
        x = torch.from_numpy(rng.standard_normal(
            (3, 1, tc.d_model)).astype(np.float32))
        pos = torch.tensor([step, step + 3, step + 9], dtype=torch.int32)
        q = tattn._project_q(p, x, tc, pos[:, None])
        k_new, v_new = tattn._project_kv(p, x, tc, pos[:, None])
        k, v = cache["k"].clone(), cache["v"].clone()
        k[rows, (pos % 8).long()] = k_new[:, 0]
        v[rows, (pos % 8).long()] = v_new[:, 0]
        slots = torch.arange(8)[None, :]
        written = slots <= pos[:, None]
        if window is not None:
            written &= slots > pos[:, None] - window
        want = tattn._project_out(tattn._sdpa(
            q, k, v, written[:, None, None, None, :], tc,
            kv_seq="cache_seq"), p, tc)
        y, _ = tattn.decode_attention(p, x, pos, cache, tc, window=window)
        close(y, want.numpy(), (1e-5, 1e-5))
    assert len(calls) == 20
    assert all(c == {"window": window, "softcap": tc.logits_softcap}
               for c in calls)


def test_engine_gives_the_reference_engines_tokens():
    """deepseek-7b tiny in float32, 8 slots, cache 128, the serve_engine
    example's 16 requests (two of 192 tokens wrap the 128-slot ring)."""
    jc, tc = cfg_pair("deepseek-7b", "f32")
    jp, np_tree = jax_params("deepseek-7b")
    tp = params_from_numpy(np_tree, device="cpu")
    want = jengine.Engine(jc, jp, 8, 128).run(
        [jengine.Request(r.rid, r.prompt, r.max_new)
         for r in serve_engine.make_requests(jc.vocab_size)])
    eng = tengine.Engine(tc, tp, 8, 128, device="cpu")
    got = eng.run(serve_engine.make_requests(tc.vocab_size))
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        assert len(a.out) == a.max_new
        assert a.out == b.out, a.rid


def test_engine_keeps_a_compute_dtype_copy_and_checks_the_device():
    cfg = tconfigs.get_tiny("arctic-480b")             # bf16 compute
    tp = tinit_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = tengine.Engine(cfg, tp, 2, 16, device="cpu")
    blk = eng.params["groups"][0]["b0"]
    assert eng.params["embed"].dtype == torch.bfloat16
    assert blk["ffn"]["we_gate"].dtype == torch.bfloat16
    assert blk["ffn"]["router"].dtype == torch.float32
    assert blk["ln1"].dtype == torch.float32
    assert torch.equal(blk["attn"]["wq"],
                       tp["groups"][0]["b0"]["attn"]["wq"].bfloat16())
    # the copy gives the per-call casts' logits exactly
    tokens = torch.tensor([[3, 7, 11]], dtype=torch.int32)
    a, _ = tforward(tp, {"tokens": tokens}, cfg)
    b, _ = tforward(eng.params, {"tokens": tokens}, cfg)
    assert torch.equal(a, b)
    meta = tree_map(lambda x: x.to("meta"), tp)
    with pytest.raises(ValueError, match="parameters on"):
        tengine.Engine(cfg, meta, 2, 16, device="cpu")


def test_serve_engine_example_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_engine",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 16 requests, 552 tokens" in out.stdout
    top = [ln for ln in out.stdout.splitlines()
           if ln.startswith("top critical path:")]
    assert top and ("req3" in top[0] or "req7" in top[0]), out.stdout[-2000:]


def test_moe_imbalance_what_if_within_15_percent():
    acc = moe_imbalance.what_if_accuracy(device="cpu")
    assert acc["matched_slices"] > 0
    assert acc["rel_err"] <= 0.15, acc
    loads, ne = moe_imbalance.expert_loads(2.5, device="cpu")
    balanced, _ = moe_imbalance.expert_loads(0.0, device="cpu")
    assert ne == 8 and int(loads.sum()) == int(balanced.sum()) == 4 * 64 * 2
    assert loads.max() > 2 * balanced.max()      # the skew finds a hot expert
