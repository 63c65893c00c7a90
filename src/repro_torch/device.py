"""Where the port's device work runs.

Device backends and kernel wrappers run on :func:`default_device` — CUDA —
unless the caller passes ``device=`` or selects another device with
:func:`use_device`.  Asking for CUDA where ``torch.cuda.is_available()`` is
False raises ``RuntimeError``: nothing silently falls back to the CPU.  The
CPU tests ask for the CPU explicitly (``use_device("cpu")`` or
``device="cpu"``), and there every kernel wrapper runs its plain PyTorch
version.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

_CURRENT: contextvars.ContextVar[torch.device] = contextvars.ContextVar(
    "repro_torch_device", default=torch.device("cuda"))


def default_device() -> torch.device:
    """The device device work runs on when no ``device=`` is passed."""
    return _CURRENT.get()


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``device`` (or the default device) as a ``torch.device``, checked:
    CUDA without a usable card raises rather than running elsewhere."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' or use use_device('cpu') to run the "
            "plain PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def use_device(device: str | torch.device | None) -> Iterator[torch.device]:
    """Run the enclosed calls on ``device`` (``None`` keeps the current
    default)."""
    if device is None:
        yield default_device()
        return
    token = _CURRENT.set(torch.device(device))
    try:
        yield _CURRENT.get()
    finally:
        _CURRENT.reset(token)
