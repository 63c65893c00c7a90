"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries go to ``_build/`` beside this file, named by a
hash of the source, the headers under ``csrc/`` (``*.cuh``) and the flags,
so an edited source or header is rebuilt and an unchanged one is loaded as
it is.  Nothing here runs when the package is
imported: :func:`load` builds on the first kernel launch, and
:func:`build_all` builds every library at once, one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = {"cmetric_fold": "cmetric_fold.cu", "tag_hist": "tag_hist.cu",
           "stream_scan": "stream_scan.cu", "decode_attn": "decode_attn.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C signatures: every pointer and the stream as c_void_p, so ctypes never
# narrows a 64-bit address.
SIGNATURES = {
    "cmetric_fold": {
        "gapp_tile_size": [],
        "gapp_fold": [_P, _P, _LL, _P, _F, _F, _F, _P, _P, _P, _P, _I, _P],
        "gapp_carry_cumsum": [_P, _P, _LL, _P, _F, _F, _P, _P, _P, _I, _P],
    },
    "tag_hist": {
        "gapp_tag_hist": [_P, _P, _LL, _I, _P, _P, _P, _I, _P],
        "gapp_tag_hist_path": [_I, _I],
    },
    "stream_scan": {
        "gapp_stream_tile": [],
        "gapp_stream_segment": [],
        "gapp_stream_prepass": [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _P],
        "gapp_stream_chain": [_P, _P, _LL, _P, _P, _P],
        "gapp_stream_expand": [_P, _P, _LL, _P, _P],
        "gapp_stream_pair": [_P, _P, _P, _P, _LL, _I, _P, _P, _P, _P],
        "gapp_stream_rows": [_P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P, _P,
                             _P, _P],
        "gapp_stream_cm": [_P, _P, _I, _P, _P],
    },
    "decode_attn": {
        "gapp_decode_attn": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _F, _F, _I, _I, _I, _I, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}     # guarded-by: _LOCK
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(pathlib.Path(home) / "bin" / "nvcc")


def library_path(name: str) -> pathlib.Path:
    """Where library ``name`` lives once built: keyed by its source, the
    shared headers and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: pathlib.Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / SOURCES[name])]


def build_all(names=None) -> dict[str, str]:
    """Compile every library of ``names`` (default: all) that is not built
    yet, one ``nvcc`` process per source, all running at once.  Returns
    each compiled library's compiler output (``-Xptxas -v``: registers,
    shared memory, spills); raises ``RuntimeError`` if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names or SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs = {}
    for name, (proc, tmp, out) in running.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {SOURCES[name]} (exit {proc.returncode}):\n"
                f"{text}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with its C
    signatures declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
