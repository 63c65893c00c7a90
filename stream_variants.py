#!/usr/bin/env python3
"""Where the stream scan's chain launch spends its time, on one NVIDIA GPU.

    python3 stream_variants.py

Each variant is the committed ``src/repro_torch/kernels/csrc/stream_scan.cu``
with one piece of its chain launch (``stream_chain``) changed by a text
substitution (the script stops if a substitution no longer applies).  The
variants are built by ``nvcc`` with the port's flags into
``src/repro_torch/kernels/_build/variants/``, all at once, and their chain
launches called through ctypes, as the wrapper calls them, on the shares and
idle terms of ``chip_smoke.py``'s 2^24-event capture (from the committed
prepass): every variant in turn, then again in reverse order.  Each prints
its time (CUDA events over 25 calls), its cycles per event at the card's
maximum SM clock and at the SM clock ``nvidia-smi`` read while the
committed variant ran, the registers ``ptxas`` reports for the chain, and
whether its checkpoints and totals equal the committed ones.  The variants
that drop a load or the idle walk, or that store other values, are timing
probes: their results differ by design.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

LOAD = "      for (int b = 0; b < kBlk; ++b) nxt[b] = ring[jn + b];"
IDLE_INIT = "      mbar_init(empty + s, 2);"
ROLES = "  const bool walks_gcm = warp == 0;"
ADDS = """        sum = __fadd_rn(sum, cur[b].x);
        sum = __fadd_rn(sum, cur[b].y);
        sum = __fadd_rn(sum, cur[b].z);
        sum = __fadd_rn(sum, cur[b].w);
      }"""
CKPT = "    if (kOut) ckpt[g] = sum;\n"
CALL = "walk_stage<true>(r, ckpt + 1 + s * (kStage / kSeg), sum);"
# the walk's first design: every sum stored, four at a time (16-byte
# stores into the script's checkpoint buffer, which is E floats long)
EVERY_SUM = [(ADDS, """        float4 o;
        o.x = sum = __fadd_rn(sum, cur[b].x);
        o.y = sum = __fadd_rn(sum, cur[b].y);
        o.z = sum = __fadd_rn(sum, cur[b].z);
        o.w = sum = __fadd_rn(sum, cur[b].w);
        if (kOut) reinterpret_cast<float4*>(ckpt)[j + b] = o;
      }"""), (CKPT, ""),
             (CALL, "walk_stage<true>(r, ckpt + 4 + s * kStage, sum);")]
STAGES_2048 = [("constexpr int kStage = 4096;", "constexpr int kStage = 2048;"),
               ("constexpr int kStages = 3;", "constexpr int kStages = 4;")]

# name -> [(text in the committed source, its replacement)]
VARIANTS = {
    "committed": [],
    # the adds alone: constant shares, no shared loads (the chain bound as
    # this card runs it, with one barrier wait a stage)
    "adds only": [(LOAD, "      for (int b = 0; b < kBlk; ++b)\n"
                         "        nxt[b] = make_float4(0.5f, 0.25f, 0.125f, "
                         "0.0625f);")],
    # global_cm summed but no checkpoint stored
    "no checkpoint stores": [(CKPT, "")],
    "a checkpoint every 32 events": [("constexpr int kSeg = 256;",
                                      "constexpr int kSeg = 32;")],
    # global_cm walked alone: the idle warp leaves at once
    "no idle walk": [(IDLE_INIT, "      mbar_init(empty + s, 1);"),
                     (ROLES, "  if (warp == 1) return;\n" + ROLES)],
    "every sum stored": EVERY_SUM,
    "steps of 8 float4s": [("constexpr int kBlk = 4;",
                            "constexpr int kBlk = 8;")],
    "2,048-event stages, 4 deep": STAGES_2048,
    "2,048-event stages, 4 deep, every sum stored": STAGES_2048 + EVERY_SUM,
}


def build_variants(build) -> dict:
    """Compile every variant at once; returns name -> (library path,
    ptxas lines of the chain kernel)."""
    src = (build.CSRC / build.SOURCES["stream_scan"]).read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"stream_variants: {name!r} no longer "
                                 "applies")
            text = text.replace(old, new)
        cu, so = out_dir / f"s{i}.cu", out_dir / f"s{i}.so"
        cu.write_text(text)
        running[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"stream_variants: nvcc failed on {name!r}:\n"
                             f"{log}")
        chain = log[log.find("stream_chain"):].split("Compiling entry")[0]
        ptxas = [line.strip() for line in chain.splitlines()
                 if "registers" in line or "spill" in line]
        built[name] = (so, ptxas)
    return built


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stream_variants: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import convert
    from repro_torch.kernels import build
    from repro_torch.kernels import stream_scan as stream_k

    card = smi("name,power.limit")
    print(f"[setup] card: {card}")
    built = build_variants(build)
    libs = {}
    for name, (so, ptxas) in built.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.gapp_stream_chain
        fn.argtypes = build.SIGNATURES["stream_scan"]["gapp_stream_chain"]
        fn.restype = ctypes.c_int
        libs[name] = lib
        print(f"[ptxas] {name}: {'; '.join(ptxas)}")

    dev = torch.device("cuda")
    fields, tag_names, tag_locs, paths, sample_fields, _ = \
        chip_smoke.make_capture(chip_smoke.SEED)
    log, *_ = convert.capture_from_numpy(fields, tag_names, tag_locs, paths,
                                         sample_fields)
    t, _, d = chip_smoke.stream_columns(log, dev)
    e = t.shape[0]
    share, idle, _, _ = stream_k.prepass_stage(t, d)
    bufs = stream_k.chain_buffers(share, idle)
    del share, idle, t, d
    bufs[2] = torch.zeros(bufs[0].shape[0] + 8, device=dev)   # any layout
    scalars = torch.empty(2, dtype=torch.float32, device=dev)
    stream_k.chain_launch(e, bufs, scalars)
    want_c, want_s = bufs[2].clone(), scalars.clone()
    max_hz = float(smi("clocks.max.sm")) * 1e6

    def call(lib):
        rc = lib.gapp_stream_chain(
            bufs[0].data_ptr(), bufs[1].data_ptr(), e, bufs[2].data_ptr(),
            scalars.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gapp_stream_chain failed: CUDA error {rc}")

    clocks = []

    def sample_clock():             # while the committed variant runs
        for _ in range(4):
            threading.Event().wait(0.1)
            clocks.append(float(smi("clocks.sm")) * 1e6)

    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        bufs[2].zero_()
        scalars.zero_()
        call(libs[name])
        torch.cuda.synchronize()
        same = bool(torch.equal(bufs[2], want_c)
                    and torch.equal(scalars, want_s))
        sampler = (threading.Thread(target=sample_clock)
                   if name == "committed" else None)
        if sampler:
            sampler.start()
        ms = chip_smoke.time_ms(lambda lib=libs[name]: call(lib), 25)
        if sampler:
            sampler.join()
        results[name].append({"ms": ms, "equal": same})
        print(f"[variant] {name}: {ms:.4f} ms, "
              f"{ms * 1e-3 * max_hz / e:.3f} cycles/event at the maximum "
              f"clock, equal to the committed results: {same}")
    hz = float(np.median(clocks)) if clocks else max_hz
    print(f"[clock] SM clock while the committed chain ran: "
          f"{[c / 1e6 for c in clocks]} MHz (maximum {max_hz / 1e6:.0f})")
    for name, runs in results.items():
        ms = min(r["ms"] for r in runs)
        print(f"[cycles] {name}: {ms * 1e-3 * hz / e:.3f} cycles/event at "
              f"{hz / 1e6:.0f} MHz")
    print(card)
    print(json.dumps({"E": e, "sm_clock_hz": clocks, "max_hz": max_hz,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
