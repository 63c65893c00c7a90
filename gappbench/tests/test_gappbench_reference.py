"""The plain reference against the port at the tiny configurations on the
CPU (both in float32), and the yardstick's counts against the port's."""
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench import weights, yardstick  # noqa: E402
from gappbench.reference import adamw as ref_adamw  # noqa: E402
from gappbench.reference import gapp_fold  # noqa: E402
from gappbench.reference import model as ref  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 4099


def _port_cfg(cell):
    import dataclasses
    cfg = cell_lib.model_config(cell.shape, cell.config_name)
    return dataclasses.replace(cfg, compute_dtype=torch.float32)


def test_loss_and_gradients_match_the_port():
    from repro_torch.models import lm_loss
    cell = cell_lib.load("tiny-train-gapp")
    s = cell.shape
    params = weights.make_params(s, SEED, torch.float32, CPU)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, s.vocab, (2, 12)))
    front = torch.from_numpy(rng.standard_normal(
        (2, s.prefix, s.frontend_dim)).astype(np.float32))
    leaves = [weights.get(params, p) for p, _, _ in weights.leaf_specs(s)]
    for x in leaves:
        x.requires_grad_(True)
    mine = ref.lm_loss(params, tokens, front, s)
    g_mine = torch.autograd.grad(mine, leaves)
    port, _ = lm_loss(params, {"tokens": tokens.int(), "frontend": front},
                      _port_cfg(cell))
    g_port = torch.autograd.grad(port, leaves)
    assert torch.allclose(mine, port, rtol=1e-5, atol=1e-6)
    for a, b in zip(g_mine, g_port):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)


def test_decode_over_prompt_rows_matches_the_port():
    from repro_torch.models import decode_step, init_decode_state
    cell = cell_lib.load("tiny-decode-gapp")
    s = cell.shape
    params = weights.make_params(s, SEED, torch.float32, CPU)
    cfg = _port_cfg(cell)
    bk, bv = weights.make_bank(s, SEED, 32, CPU)
    bk, bv = bk.float(), bv.float()
    start, n = 9, 6
    state = init_decode_state(cfg, 1, 32, device=CPU)
    for layer in range(s.layers):
        kv = state[layer]["b0"]["kv"]
        kv["k"] = kv["k"].float()
        kv["v"] = kv["v"].float()
        kv["k"][0, :start] = bk[layer, :start]
        kv["v"][0, :start] = bv[layer, :start]
    tokens = torch.tensor([5, 17, 200, 3, 99, 42])
    port = []
    with torch.no_grad():
        for j in range(n):
            logits, state = decode_step(
                params, tokens[j:j + 1], torch.tensor([start + j]), state,
                cfg)
            port.append(logits[0])
        mine = ref.decode_logits(params, tokens, start, bk[:, :start],
                                 bv[:, :start], s)
    assert torch.allclose(mine, torch.stack(port), rtol=1e-4, atol=1e-5)
    assert ref.widest_gap(mine, mine.argmax(-1)) == 0.0


def test_fp8_control_is_coarser_than_the_reference():
    cell = cell_lib.load("tiny-decode-gapp")
    s = cell.shape
    params = weights.make_params(s, SEED, torch.float32, CPU)
    bk, bv = weights.make_bank(s, SEED, 32, CPU)
    tokens = torch.arange(20) * 7
    with torch.no_grad():
        a = ref.decode_logits(params, tokens, 8, bk[:, :8], bv[:, :8], s)
        b = ref.decode_logits(params, tokens, 8, bk[:, :8], bv[:, :8], s,
                              mm=ref.fp8_mm)
    err = float((a - b).abs().max())
    assert 1e-3 < err < 1.0


def test_fold_matches_the_ports_float64_oracle():
    from repro_torch.core.cmetric import compute_numpy
    from repro_torch.core.events import synthetic_log
    log = synthetic_log(np.random.default_rng(5), 6, 40)
    port = compute_numpy(log)
    mine = gapp_fold.fold(np.asarray(log.times), np.asarray(log.workers),
                          np.asarray(log.deltas), np.asarray(log.tags),
                          log.num_workers)
    assert np.allclose(mine["per_worker"], port.per_worker, rtol=1e-12,
                       atol=0)
    assert len(mine["slices"]) == port.num_slices
    assert np.allclose([r[3] for r in mine["slices"]],
                       np.asarray(port.slice_threads_av), rtol=1e-12)


def test_sanitize_drops_what_the_tolerance_rules_drop():
    w = np.array([0, 0, 0, 1, 0, 1, 1])
    d = np.array([1, 1, -1, -1, -1, 1, -1])
    keep = gapp_fold.sanitize(w, d, 2)
    assert keep.tolist() == [True, False, True, False, False, True, True]


def test_adamw_matches_the_port():
    from repro_torch.optim import adamw
    cfg = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 20,
           "total_steps": 10000, "min_lr_ratio": 0.1}
    gen = torch.Generator().manual_seed(1)
    p = {"w": torch.randn(8, 4, generator=gen),
         "b": torch.randn(4, generator=gen)}
    mine = [p["b"].clone(), p["w"].clone()]
    mu = [torch.zeros_like(x) for x in mine]
    nu = [torch.zeros_like(x) for x in mine]
    state = adamw.init(p)
    for t in range(1, 4):
        g = {"w": torch.randn(8, 4, generator=gen) * 3,
             "b": torch.randn(4, generator=gen) * 3}
        ref_adamw.step(cfg, t, mine, [g["b"].clone(), g["w"].clone()],
                       mu, nu)
        p, state, _ = adamw.update(adamw.AdamWConfig(**cfg), g, state, p)
    assert torch.allclose(mine[0], p["b"], rtol=1e-5, atol=1e-7)
    assert torch.allclose(mine[1], p["w"], rtol=1e-5, atol=1e-7)


def test_yardstick_counts_the_ports_parameters():
    for name in ("ds7b8-decode-c4k-gapp", "ivl2-train-s4k-gapp",
                 "tiny-train-gapp"):
        cell = cell_lib.load(name)
        cfg = cell_lib.model_config(cell.shape, cell.config_name)
        # the port's analytic count leaves out the final norm's scale
        assert yardstick.param_count(cell.shape) - cell.shape.d \
            == cfg.param_count()
    ds = cell_lib.load("ds7b8-decode-c4k-gapp").shape
    assert yardstick.param_count(ds) == 2_457_931_776
    step = yardstick.train_step(ds, 1, 4096)
    assert step["positions"] == 4096
    d = yardstick.decode_step(ds, 96, 96 * 2000)
    assert d["bound_s"] == max(d["flops"] / yardstick.BF16_FLOPS,
                               d["bytes"] / yardstick.HBM_BYTES)
    # the product kernels' bound counts the weight products alone
    assert d["w_bound_s"] == max(d["w_flops"] / yardstick.BF16_FLOPS,
                                 d["w_bytes"] / yardstick.HBM_BYTES)
    assert step["w_bound_s"] == step["w_flops"] / yardstick.BF16_FLOPS
    assert step["w_flops"] < step["model_flops"]


def _trainer_log(rng, cycles: int, step_s: float):
    """A trainer's steps and a loader's short batches that start a little
    before each step (a third of the batch alone, about), so that their
    threads_av lies near n_min = 1.5 of three workers."""
    t, ev = 0.0, []
    for _ in range(cycles):
        gen = rng.uniform(20e-6, 60e-6)
        ev += [(t, 1, 1, 1), (t + gen, 1, -1, 1)]
        ts = t + gen * rng.uniform(0.25, 0.42)
        ev += [(ts, 0, 1, 0), (ts + step_s, 0, -1, 0)]
        t = ts + step_s + 1e-4
    ev.sort()
    a = np.asarray(ev)
    return (np.round(a[:, 0] * 1e9).astype(np.int64),
            a[:, 1].astype(np.int32), a[:, 2].astype(np.int8),
            a[:, 3].astype(np.int32))


def _float32_report(times, w, d, tags, backend):
    """The port's float32 chunk fold, an event at a time as the session
    drains them: per-worker CMetric and the critical slices' columns."""
    from repro_torch import device as device_lib
    from repro_torch.core import backends
    from repro_torch.core.cmetric import FoldCarry
    from repro_torch.core.events import EventLog
    carry, rows = FoldCarry.init(3), []
    with device_lib.use_device("cpu"):
        for i in range(len(times)):
            part = EventLog(times[i:i + 1], w[i:i + 1], d[i:i + 1],
                            tags[i:i + 1], np.full(1, -1, np.int32), 3)
            carry, tbl = backends.fold_chunk(carry, part, backend=backend)
            rows += [(int(a), int(b), float(c)) for a, b, c, tav in
                     zip(tbl.worker, tbl.end_ns, tbl.cm, tbl.threads_av)
                     if tav < 1.5]
    return np.asarray(carry.cm_hash, np.float64), rows


@pytest.mark.parametrize("backend", ["stream", "vector"])
def test_a_float32_fold_flips_only_the_slices_the_band_leaves_out(backend):
    # the port's float32 folds over a minute: each slice critical on one
    # side only lies in the reference's float32 band, and some do
    times, w, d, tags = _trainer_log(np.random.default_rng(7), 150, 0.4)
    ref = gapp_fold.fold(times, w.astype(np.int64), d.astype(np.int64),
                         tags.astype(np.int64), 3)
    loose = gapp_fold.float32_ambiguous(ref, 1.5)
    _, rows = _float32_report(times, w, d, tags, backend)
    flips = {r[:2] for r in rows} ^ gapp_fold.critical_keys(ref, 1.5)
    assert flips and flips <= loose
    # the trainer's steps, critical by far, are never in the band
    assert not {k for k in loose if k[0] == 0}


def test_the_check_passes_a_float32_report_and_fails_its_faults():
    from gappbench import gapp_check
    times, w, d, tags = _trainer_log(np.random.default_rng(8), 150, 0.4)
    per_worker, rows = _float32_report(times, w, d, tags, "stream")
    cap = {"per_worker": per_worker,
           "crit_worker": np.asarray([r[0] for r in rows], np.int64),
           "crit_end": np.asarray([r[1] for r in rows], np.int64),
           "crit_cm": np.asarray([r[2] for r in rows], np.float64),
           "top_tag": 0, "times": times, "workers": w.astype(np.int64),
           "deltas": d.astype(np.int64), "tags": tags.astype(np.int64),
           "num_workers": 3}
    got = gapp_check.readings(cap)
    assert got["gapp_crit_flips"] == 0 and got["gapp_path_gap"] == 0
    assert got["gapp_cm_err"] < 1e-6
    dropped = gapp_check.readings(gapp_check.drop_critical(cap))
    assert dropped["gapp_crit_flips"] == 1
    permuted = gapp_check.readings(gapp_check.permute_tags(cap))
    assert permuted["gapp_path_gap"] > 0.9
