"""The check sees faults planted in the timed path: whole tiny runs on the
CPU, past the harness's look for a card, with the port broken underneath,
each of which has to come out not correct."""
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench import run  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 7_919


def _correct(name: str) -> bool:
    result, _, _ = run.run_cell(cell_lib.load(name), SEED, 1.0, False,
                                    CPU, time.perf_counter())
    return result["correct"]


def _decode_fault(kind: str):
    from repro_torch.models.common import tree_map
    from repro_torch.serve import engine as engine_mod
    real = engine_mod.make_decode_step

    def broken(cfg):
        step = real(cfg)
        calls = []

        def f(params, tokens, pos, state, memory=None):
            if kind == "state_unchanged":
                scratch = tree_map(torch.clone, state)
                nxt, logits, _ = step(params, tokens, pos, scratch, memory)
                return nxt, logits, state
            # a token altered: each step, one slot's, in turn
            nxt, logits, state = step(params, tokens, pos, state, memory)
            nxt = nxt.clone()
            calls.append(None)
            i = len(calls) % nxt.shape[0]
            nxt[i] = (nxt[i] + 1) % cfg.vocab_size
            return nxt, logits, state
        return f
    return engine_mod, broken


def _train_fault(kind: str):
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import step as step_mod
    real = step_mod.make_train_step

    def broken(cfg, opt_cfg, *a, **k):
        step = real(cfg, opt_cfg, *a, **k)

        def f(params, opt_state, batch, err):
            if kind == "half_batch":
                half = next(iter(batch.values())).shape[0] // 2
                return step(params, opt_state,
                            {n: v[:half] for n, v in batch.items()}, err)
            if kind == "state_unchanged":
                before = [x.clone() for x in tree_leaves(params)
                          + tree_leaves(opt_state)]
                out = step(params, opt_state, batch, err)
                for x, y in zip(tree_leaves(params) + tree_leaves(opt_state),
                                before):
                    x.copy_(y)
                return params, opt_state, out[2], out[3]
            p, o, metrics, e = step(params, opt_state, batch, err)
            with torch.no_grad():
                tree_leaves(p)[0].mul_(1.01)        # an update altered
            return p, o, metrics, e
        return f
    return step_mod, broken


@pytest.mark.parametrize("kind", ["state_unchanged", "token_altered"])
def test_decode_faults_are_not_correct(kind, monkeypatch):
    mod, broken = _decode_fault(kind)
    monkeypatch.setattr(mod, "make_decode_step", broken)
    assert not _correct("tiny-decode-gapp")


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "update_altered"])
def test_train_faults_are_not_correct(kind, monkeypatch):
    mod, broken = _train_fault(kind)
    monkeypatch.setattr(mod, "make_train_step", broken)
    assert not _correct("tiny-train-gapp")


def test_a_gapp_fold_altered_is_not_correct(monkeypatch):
    from gappbench import gapp_check
    real = gapp_check.capture

    def altered(session):
        cap = real(session)
        cap["per_worker"] = cap["per_worker"] * 1.001
        return cap
    monkeypatch.setattr(gapp_check, "capture", altered)
    assert not _correct("tiny-decode-gapp")


@pytest.mark.parametrize("kind", ["drop_critical", "permute_tags"])
def test_a_ranking_altered_is_not_correct(kind, monkeypatch):
    from gappbench import gapp_check
    real, fault = gapp_check.capture, gapp_check.FAULTS[kind]
    monkeypatch.setattr(gapp_check, "capture",
                        lambda session: fault(real(session)))
    assert not _correct("tiny-train-gapp")
