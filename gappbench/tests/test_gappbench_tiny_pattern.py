"""The test-only ``tiny-pattern`` family, which touches every part of the
family interface: its shapes, leaves and cache layout against the port's,
its plain reference against the port at float32 on the CPU, its counts,
and its three tiny cells run whole through ``run.run_cell``."""
import dataclasses
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench import control, run, weights, yardstick  # noqa: E402
from gappbench.reference import model as ref  # noqa: E402
from gappbench.reference import tiny_pattern as tp_ref  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 65_537
WINDOWED, MOE = "tiny-pattern-train-gapp", "tiny-pattern-decode-moe"
RING = "tiny-pattern-decode-ring"


def _shape(cell: str):
    return cell_lib.load(cell).shape


def _port_cfg(s):
    cfg = cell_lib.model_config(s, "tiny")
    return dataclasses.replace(cfg, compute_dtype=torch.float32)


@pytest.mark.parametrize("cell", [WINDOWED, MOE])
def test_the_family_lays_out_the_ports_tree_and_caches(cell):
    from repro_torch.models import init_decode_state, init_lm
    from repro_torch.models.common import tree_leaves
    s = _shape(cell)
    assert s.family == "tiny-pattern"
    cfg = _port_cfg(s)
    port = init_lm(torch.Generator().manual_seed(0), cfg, device=CPU)
    mine = weights.make_params(s, SEED, torch.bfloat16, CPU)
    specs = weights.leaf_specs(s)
    for path, shape, _ in specs:
        assert tuple(weights.get(port, path).shape) == shape, path
        leaf = weights.get(mine, path)
        want = torch.float32 if path[-1] == "router" or len(shape) == 1 \
            else torch.bfloat16
        assert leaf.dtype == want, path
    assert sum(x.numel() for x in tree_leaves(port)) == sum(
        int(np.prod(shape)) for _, shape, _ in specs)
    # the port's analytic count leaves out the final norm's scale
    assert yardstick.param_count(s) - s.d == cfg.param_count()
    state = init_decode_state(cfg, 3, 20, device=CPU)
    layout = cell_lib.family_of(s).cache_layers(s, 20)
    assert len(layout) == s.layers
    for c in layout:
        assert state[c.group][c.block]["kv"]["k"].shape[1] == c.rows
    bk, bv = weights.make_bank(s, SEED, 20, CPU)
    assert [x.shape[0] for x in bk] == [c.rows for c in layout]
    assert [x.shape for x in bk] == [x.shape for x in bv]


def test_reference_loss_and_gradients_match_the_port():
    from repro_torch.models import lm_loss
    s = _shape(WINDOWED)
    params = weights.make_params(s, SEED, torch.float32, CPU)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, s.vocab, (2, 20)))
    leaves = [weights.get(params, p) for p, _, _ in weights.leaf_specs(s)]
    for x in leaves:
        x.requires_grad_(True)
    mine = ref.lm_loss(params, tokens, None, s)
    g_mine = torch.autograd.grad(mine, leaves)
    port, metrics = lm_loss(params, {"tokens": tokens.int()}, _port_cfg(s))
    g_port = torch.autograd.grad(port, leaves)
    assert "moe_aux" in metrics and int(metrics["moe_dropped"]) == 0
    assert torch.allclose(mine, port, rtol=1e-5, atol=1e-6)
    for (path, _, _), a, b in zip(weights.leaf_specs(s), g_mine, g_port):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6), path


@pytest.mark.parametrize("cell,start", [(WINDOWED, 2), (MOE, 20)])
def test_reference_decode_matches_the_port_where_the_ring_is_sound(cell,
                                                                  start):
    # the windowed pattern decodes within its first window here: past it
    # the port reads its ring as linear rows (the ring cell's fault)
    from repro_torch.models import decode_step, init_decode_state
    s = _shape(cell)
    cfg = _port_cfg(s)
    params = weights.make_params(s, SEED, torch.float32, CPU)
    layout = cell_lib.family_of(s).cache_layers(s, 32)
    bk, bv = weights.make_bank(s, SEED, 32, CPU)
    state = init_decode_state(cfg, 1, 32, device=CPU)
    for i, c in enumerate(layout):
        kv = state[c.group][c.block]["kv"]
        kv["k"], kv["v"] = kv["k"].float(), kv["v"].float()
        kv["k"][0, :start] = bk[i][:start].float()
        kv["v"][0, :start] = bv[i][:start].float()
    tokens = torch.tensor([5, 17, 200, 3, 99])
    port = []
    with torch.no_grad():
        for j in range(len(tokens)):
            logits, state = decode_step(params, tokens[j:j + 1],
                                        torch.tensor([start + j]), state, cfg)
            port.append(logits[0])
        ties: list = []
        mine = ref.decode_logits(params, tokens, start,
                                 [x[:start].float() for x in bk],
                                 [x[:start].float() for x in bv], s,
                                 ties=ties)
    assert torch.allclose(mine, torch.stack(port), rtol=1e-4, atol=1e-5)
    assert all(0 <= t < len(tokens) for t in ties)


def test_the_windowed_reference_is_a_band_masked_softmax_past_two_windows():
    s = _shape(RING)
    w = s.window
    p = weights.make_params(s, SEED, torch.float32, CPU)["groups"][0]["b0"]
    gen = torch.Generator().manual_seed(1)
    start, n = 2 * w + 5, 4
    ctx = (torch.randn(1, start, s.kv_heads, s.head_dim, generator=gen),
           torch.randn(1, start, s.kv_heads, s.head_dim, generator=gen))
    h = torch.randn(1, n, s.d, generator=gen)
    pos = start + torch.arange(n, dtype=torch.float32)
    with torch.no_grad():
        got = tp_ref.attention(p["attn"], h, pos, s, ref.plain_mm,
                               window=w, ctx=ctx)
        # every key of the whole prompt and the new rows, each query's
        # softmax over the w positions up to its own and nothing else
        hd, g = s.head_dim, s.heads // s.kv_heads
        q = ref.rope((h @ p["attn"]["wq"]).reshape(1, n, s.heads, hd), pos,
                     s.rope_theta)[0]
        k_new = ref.rope((h @ p["attn"]["wk"]).reshape(
            1, n, s.kv_heads, hd), pos, s.rope_theta)[0]
        v_new = (h @ p["attn"]["wv"]).reshape(n, s.kv_heads, hd)
        k = torch.cat([ctx[0][0], k_new])
        v = torch.cat([ctx[1][0], v_new])
        rows = []
        for i in range(n):
            at = start + i
            band = torch.arange(at - w + 1, at + 1)
            heads = []
            for head in range(s.heads):
                sc = k[band, head // g] @ q[i, head] * hd ** -0.5
                heads.append(torch.softmax(sc, 0) @ v[band, head // g])
            rows.append(torch.cat(heads))
        want = torch.stack(rows) @ p["attn"]["wo"]
    assert torch.allclose(got[0], want, rtol=1e-5, atol=1e-6)


def test_counts_read_each_layers_own_rows():
    s = _shape(RING)
    pos = [3, 20, 40]
    rows = sum(p + 1 for p in pos)
    d = yardstick.decode_step(s, 3, rows, pos)
    local = sum(min(p + 1, s.window) for p in pos)
    kinds = [k for _, k in s.blocks()]
    attended = kinds.count("local") * local + kinds.count("moe") * rows
    assert d["qk_flops"] == 2 * s.heads * s.head_dim * attended
    assert d["qk_bytes"] == 2 * s.kv_heads * s.head_dim * attended
    assert d["bound_s"] == max(d["flops"] / yardstick.BF16_FLOPS,
                               d["bytes"] / yardstick.HBM_BYTES)
    t = yardstick.train_step(s, 2, 16)
    assert t["positions"] == 32 and 0 < t["w_flops"] < t["model_flops"]
    # a batch of one token reads its top-k experts' weights and no more
    one = yardstick.decode_step(s, 1, 1, [0])
    assert one["w_bytes"] == one["w_flops"] + 2 * s.d


def _run(name: str, controls=(), seconds: float = 2.0):
    return run.run_cell(cell_lib.load(name), SEED, seconds, False, CPU,
                        time.perf_counter(), controls=controls)


def test_the_train_cell_is_correct_and_its_controls_fail():
    wanted = control.controls_for(cell_lib.load(WINDOWED))
    result, lines, rec = _run(WINDOWED, wanted)
    assert result["correct"], lines
    assert rec["steps"] >= 1 and rec["positions"] == 2 * 64
    verdicts = {m: c["correct"] for m, c in result["controls"].items()}
    assert verdicts.pop("program")
    assert not any(verdicts.values()), verdicts


def test_the_expert_decode_cell_is_correct_and_its_fp8_control_fails():
    result, lines, rec = _run(MOE, ("control",))
    assert result["correct"], lines
    assert set(result["checks"]) == {"logit_gap_untied", "gapp_cm_err"}
    assert not result["controls"]["control"]["correct"]
    assert all(len(p) == n for p, n in zip(rec["positions"], rec["tokens"]))


@pytest.mark.xfail(strict=True, reason=(
    "the port reads a ring cache of w rows as linear rows: "
    "kernels/decode_attn.py::written_interval and "
    "models/attention.py::decode_attention read rows [pos-w+1, w-1] for "
    "w <= pos < 2w-1 and none (the mean of v) from 2w-1 on"))
def test_the_windowed_decode_cell_past_two_windows_is_correct():
    result, lines, _ = _run(RING)
    assert result["correct"], lines
