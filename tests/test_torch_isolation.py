"""The port stands alone and runs where it is told to.

* Importing the port pulls in neither ``jax`` nor the JAX package.
* No source of the port, and not ``chip_smoke.py``, imports either.
* Device work goes to CUDA unless the caller asks for the CPU; asking for
  CUDA without a card raises instead of running elsewhere.
* ``chip_smoke.py`` fails, and prints no result, without a card.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import device as device_lib
from repro_torch.core import ProfileSession, cmetric, synthetic_log

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.convert, "
            "repro_torch.device, repro_torch.spans, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, repro_torch.core.session, "
            "repro_torch.fleet, repro_torch.obs, repro_torch.models, "
            "repro_torch.configs, repro_torch.sharding, repro_torch.serve, "
            "repro_torch.examples.serve_engine, "
            "repro_torch.examples.moe_imbalance, repro_torch.data, "
            "repro_torch.ft, repro_torch.pipeline, repro_torch.optim, "
            "repro_torch.train, repro_torch.train.trainer, "
            "repro_torch.ckpt, repro_torch.examples.train_lm, "
            "repro_torch.examples.straggler_hunt, "
            "repro_torch.examples.pipeline_bubbles, "
            "repro_torch.examples.fleet_profile, "
            "repro_torch.models.recurrent, repro_torch.lint, "
            "repro_torch.lint.watchdog, repro_torch.lint.runner, "
            "repro_torch.launch, repro_torch.launch.mesh, "
            "repro_torch.launch.rules, repro_torch.launch.train, "
            "repro_torch.launch.cost, repro_torch.launch.specs, "
            "repro_torch.launch.roofline, repro_torch.launch.dryrun, "
            "repro_torch.launch.perf, repro_torch.launch.tabulate, "
            "repro_torch.sharding.api, repro_torch.sharding.params, "
            "repro_torch.serve.decode_sharded, repro_torch.pipeline.gpipe\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert "import jax" not in path.read_text()


def test_default_device_is_cuda_and_use_device_nests():
    assert device_lib.default_device() == torch.device("cuda")
    with device_lib.use_device("cpu") as dev:
        assert dev == torch.device("cpu")
        assert device_lib.resolve() == torch.device("cpu")
        with device_lib.use_device(None):
            assert device_lib.default_device() == torch.device("cpu")
    assert device_lib.default_device() == torch.device("cuda")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = synthetic_log(np.random.default_rng(0), 3, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        cmetric.compute(log)
    with pytest.raises(RuntimeError, match="CUDA"):
        cmetric.compute(log, backend="vector")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_lib.resolve("cuda")
    assert cmetric.compute(log, device="cpu").num_slices == 15
    assert cmetric.compute(log, backend="numpy").num_slices == 15
    with pytest.raises(RuntimeError, match="CUDA"):
        ProfileSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        ProfileSession.offline(log)
    assert ProfileSession(device="cpu").device == torch.device("cpu")
    assert ProfileSession.offline(log, device="cpu").result().total_slices \
        == 15


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: the script would run")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_training_path_without_a_card_raises(monkeypatch, tmp_path):
    """The trainer, the straggler monitor, checkpoint restore and the new
    examples ask for CUDA by default and raise without a card, before any
    thread starts; with ``device="cpu"`` they run."""
    from repro_torch import configs
    from repro_torch.ckpt import checkpoint
    from repro_torch.examples import (fleet_profile, pipeline_bubbles,
                                      straggler_hunt, train_lm)
    from repro_torch.ft import StragglerMonitor
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = TrainerConfig(steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(configs.get_tiny("deepseek-7b"), adamw.AdamWConfig(), tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        StragglerMonitor(4)
    assert StragglerMonitor(4, device="cpu").session.device.type == "cpu"
    checkpoint.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.restore(str(tmp_path), 1, {"x": torch.zeros(2)})
    for example in (train_lm, straggler_hunt, pipeline_bubbles,
                    fleet_profile):
        with pytest.raises(RuntimeError, match="CUDA"):
            example.main([])
