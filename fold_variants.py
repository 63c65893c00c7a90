#!/usr/bin/env python3
"""Where the fold kernel's time goes, on one NVIDIA GPU.

    python3 fold_variants.py

Each variant is the committed ``src/repro_torch/kernels/csrc/cmetric_fold.cu``
with one piece changed by a text substitution (the script stops if a
substitution no longer applies).  The variants are built by ``nvcc`` with the
port's flags into ``src/repro_torch/kernels/_build/variants/``, all at once,
and called through ctypes, as the wrapper calls the kernel, on
``chip_smoke.py``'s 2^24-event capture: every variant in turn, then again in
reverse order.  Each prints its eager and CUDA-graph times (ms), the
registers and spills ``ptxas`` reports for the fold kernel, and whether its
``n`` equals the plain version's.  The variants that drop a look-back or the
exact division are timing probes: their results are wrong by design.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

LAUNCH = "__launch_bounds__(kThreads, 3)\nfold_lookback"
WAIT_ALL = """        wait |= (w[x] & kStatusMask) == kStatusInvalid;
      }
    } while (__any_sync(kFullMask, wait));"""
WAIT_NEAREST = """        const unsigned inv = __ballot_sync(
            kFullMask, (w[x] & kStatusMask) == kStatusInvalid);
        const unsigned inc = __ballot_sync(
            kFullMask, (w[x] & kStatusMask) == kStatusInclusive && p >= 0);
        wait |= (inv & (inc ? (inc & (0u - inc)) - 1u : ~0u)) != 0;
      }
    } while (wait);"""
SMEM = "kTile * (int)(sizeof(float) + sizeof(int));"
COUNT_LOOK_BACK = "      look_back(tile, count_words, pre);\n"
SUM_LOOK_BACK = "    look_back(tile, words, pre);\n"

# name -> [(text in the committed source, its replacement)]
VARIANTS = {
    "committed": [],
    # the occupancy of a tile held in registers (64 a thread): 40 KB more
    # shared memory a block, so that two blocks fit an SM and three do not
    "two blocks an SM": [(SMEM, SMEM[:-1] + " + 40 * 1024;")],
    "no count look-back": [(COUNT_LOOK_BACK, "")],
    "no sum look-back": [(SUM_LOOK_BACK, "")],
    "no look-back": [(COUNT_LOOK_BACK, ""), (SUM_LOOK_BACK, "")],
    "approximate division": [("dt / (float)n", "__fdividef(dt, (float)n)")],
    "256-thread blocks": [("constexpr int kThreads = 512;",
                           "constexpr int kThreads = 256;"),
                          (LAUNCH, "__launch_bounds__(kThreads, 6)\n"
                                   "fold_lookback")],
    "look-back waits only up to the nearest inclusive word": [
        (WAIT_ALL, WAIT_NEAREST)],
}


def build_variants(build) -> dict:
    """Compile every variant at once; returns name -> (library path,
    ptxas lines of the fold kernel)."""
    src = (build.CSRC / build.SOURCES["cmetric_fold"]).read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"fold_variants: {name!r} no longer applies")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        running[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"fold_variants: nvcc failed on {name!r}:\n{log}")
        fold = log[log.find("fold_lookback"):].split("Compiling entry")[0]
        ptxas = [line.strip() for line in fold.splitlines()
                 if "registers" in line or "spill" in line]
        built[name] = (so, ptxas)
    return built


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fold_variants: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import convert
    from repro_torch.kernels import build, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[setup] card: {smi}")
    built = build_variants(build)
    libs = {}
    for name, (so, ptxas) in built.items():
        lib = ctypes.CDLL(str(so))
        lib.gapp_fold.argtypes = build.SIGNATURES["cmetric_fold"]["gapp_fold"]
        lib.gapp_fold.restype = ctypes.c_int
        libs[name] = lib
        print(f"[ptxas] {name}: {'; '.join(ptxas)}")

    dev = torch.device("cuda")
    fields, tag_names, tag_locs, paths, sample_fields, _ = \
        chip_smoke.make_capture(chip_smoke.SEED)
    log, *_ = convert.capture_from_numpy(fields, tag_names, tag_locs, paths,
                                         sample_fields)
    t32 = torch.from_numpy(log.slice_seconds().astype(np.float32)).to(dev)
    dt = torch.empty_like(t32)
    dt[:-1] = t32[1:] - t32[:-1]
    dt[-1] = 0.0
    deltas = torch.from_numpy(log.deltas.astype(np.int32)).to(dev)
    del t32
    e = dt.shape[0]
    n_p, g_p, *_ = ref.fold_ref(dt, deltas)
    n = torch.empty_like(deltas)
    gcm = torch.empty_like(dt)
    scalars = torch.empty(3, device=dev)

    def call(lib):
        tile = lib.gapp_tile_size()
        status = torch.empty(3 * ((e + tile - 1) // tile) + 1,
                             dtype=torch.int64, device=dev)
        rc = lib.gapp_fold(dt.data_ptr(), deltas.data_ptr(), e, None, 0.0,
                           0.0, 0.0, n.data_ptr(), gcm.data_ptr(),
                           scalars.data_ptr(), status.data_ptr(), 1,
                           torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gapp_fold failed to launch: CUDA error {rc}")

    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        run = functools.partial(call, libs[name])
        run()
        torch.cuda.synchronize()
        same = bool(torch.equal(n, n_p))
        ms = chip_smoke.time_ms(run, 50)
        g_ms = chip_smoke.graph_ms(run, 50)
        times[name].append({"ms": ms, "graph_ms": g_ms, "n_equal": same})
        print(f"[variant] {name}: {ms:.4f} ms, graph {g_ms:.4f} ms, n equal "
              f"to the plain version: {same}, gcm max diff "
              f"{float((gcm - g_p).abs().max()):.3e}")
    print(smi)
    print(json.dumps({"E": e, "variants": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
