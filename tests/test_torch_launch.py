"""The port's training launcher against the JAX package's, on the CPU.

``build_trainer`` must configure what the reference's does (the model
config, the trainer's and the optimizer's settings) with the port's eager
step; ``main`` runs the tiny arch on the CPU and prints the GAPP profile;
without ``--device cpu`` it asks for the card, and raises without one.
"""
import dataclasses
import os
import tempfile

import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain

CFG_FIELDS = [f.name for f in dataclasses.fields(jtrain.configs.get_tiny(
    "deepseek-7b")) if f.name not in ("compute_dtype", "param_dtype")]


def _build(module, arch, **kw):
    trainer = module.build_trainer(arch, **kw)
    trainer.loader.stop()
    if trainer.gapp is not None:
        trainer.gapp.stop()
    return trainer


@pytest.mark.parametrize("arch, kw", [
    ("deepseek-7b", {}),
    ("grok-1-314b", {"steps": 7, "batch": 4, "seq": 32,
                     "loader_delay_s": 0.01, "profile": False}),
    ("seamless-m4t-large-v2", {"tiny": False, "steps": 1,
                               "ckpt_dir": "ckpts", "compress": "int8"}),
])
def test_build_trainer_fields_equal_the_reference(arch, kw):
    ref = _build(jtrain, arch, **kw)
    port = _build(ttrain, arch, device="cpu", **kw)
    assert port.device == torch.device("cpu")
    for name in CFG_FIELDS:
        assert getattr(port.cfg, name) == getattr(ref.cfg, name), name
    assert dataclasses.asdict(port.opt_cfg) == dataclasses.asdict(
        ref.opt_cfg)
    want = dataclasses.asdict(ref.tcfg)
    got = dataclasses.asdict(port.tcfg)
    # the reference writes under /tmp; the port under the temporary
    # directory the process was given
    assert os.path.basename(got.pop("ckpt_dir")) == \
        os.path.basename(want.pop("ckpt_dir"))
    assert got == want
    assert (port.gapp is None) == (ref.gapp is None)


def test_main_trains_the_tiny_arch_on_the_cpu_and_prints_the_profile(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert ttrain.main(["--arch", "deepseek-7b", "--steps", "4",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step     0 loss" in out
    assert "GAPP bottleneck profile" in out and "train/step" in out
    assert "per-worker CMetric" in out and "trainer" in out
    ckpts = sorted(os.listdir(tmp_path / "repro_ckpt_deepseek-7b"))
    assert ckpts == ["step_000002", "step_000004"]


def test_main_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh((1,), ("model",))


def test_hardware_constants_are_the_h100s():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.ICI_BW == 450e9
