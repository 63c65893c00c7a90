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
from repro_torch.core import cmetric, synthetic_log

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.convert, "
            "repro_torch.device, repro_torch.kernels.ops, "
            "repro_torch.kernels.build\n"
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
