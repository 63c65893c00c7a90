"""Whole runs of the tiny cells on the CPU: the harness's path past its
look for a card, the check passing on the sound program, the control
failing it, and what a run may not hold or do."""
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench import control, run  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 104_729


def _run(name: str, trace: bool = False, seconds: float = 1.0,
         controls=()):
    import time
    result, lines, rec = run.run_cell(cell_lib.load(name), SEED, seconds,
                                      trace, CPU, time.perf_counter(),
                                      controls=controls)
    return result, lines, rec


def test_tiny_decode_cell_is_correct_and_reports_its_metrics():
    result, lines, rec = _run("tiny-decode-gapp")
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"logit_gap", "gapp_cm_err"}
    assert lines[-1].startswith("check ")
    assert set(result["metrics"]) == {"setup_s", "decode_tokens_per_s",
                                      "decode_itl_p95_ms"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert abs(sum(rec["step_s"]) - rec["window_s"]) < 1e-9
    assert all(n == 4 for n in rec["tokens"])


def test_tiny_train_cell_traced_reports_its_per_layer_metrics():
    # long enough that the session's drains fold events inside the window
    # on a loaded host
    result, lines, rec = _run("tiny-train-gapp", trace=True, seconds=3.0)
    assert result["correct"], lines
    assert {"train_issue_ms", "loader_wait_ms", "gapp_drain_ms.train",
            "train_mfu", "device_idle.train"} <= set(result["metrics"])
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert rec["steps"] >= 1


def test_the_controls_fail_the_check_the_program_passes():
    for name in ("tiny-decode-gapp", "tiny-train-gapp"):
        wanted = control.controls_for(cell_lib.load(name))
        result, lines, _ = _run(name, controls=wanted)
        assert result["correct"], lines
        verdicts = {m: c["correct"] for m, c in result["controls"].items()}
        assert verdicts.pop("program")
        assert set(verdicts) == set(wanted)
        if name == "tiny-decode-gapp":
            # with every slot busy a slice is rarely critical, so the
            # ranking's faults may have nothing to change there
            assert not verdicts["control"], verdicts
        else:
            assert not any(verdicts.values()), verdicts
        assert list(result)[-1] == "checks"


def test_a_run_holds_no_jax_and_no_reference_package():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from gappbench import cell, run\n"
        "r, _, _ = run.run_cell(cell.load('tiny-decode-gapp'), 5, 0.5, "
        "False, torch.device('cpu'), time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1].replace(
        "'", '"')) == ["repro_torch"]


def test_forbidden_names_are_compared_whole():
    held = ["repro_torch.models", "reprox", "jax_like", "torch", "flaxen"]
    assert run.forbidden_modules(held) == []
    assert run.forbidden_modules(held + ["jax.numpy", "repro.core"]) == \
        ["jax", "repro"]


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "gappbench/run.py", "--workload",
         "ds7b8-decode-c4k-gapp", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0", *extra], capture_output=True, text=True,
        timeout=120, cwd=cwd)


def test_without_a_card_it_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the look for one passes")
    out = _cli(ROOT)
    assert out.returncode == 2
    assert out.stdout == ""


def test_with_only_the_benchmark_files_it_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gappbench", tmp_path / "gappbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
