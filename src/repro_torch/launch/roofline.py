"""Roofline accounting from a traced dry-run step.

Three terms per (arch × shape × mesh), all in seconds-per-step on the
NVIDIA H100 SXM data sheet's rates (``launch/mesh.py``; modelled, not
measured):

    compute    = flops_per_chip / peak_FLOP/s (bf16, dense)
    memory     = bytes_per_chip / HBM_bw
    collective = collective_wire_bytes_per_chip / NVLink_bw

The counts come from :mod:`repro_torch.launch.cost`, which runs the step
once on fake tensors (the reference compiles it and asks XLA):

* **flops**: per-chip FLOPs of the local operations, by
  ``torch.utils.flop_counter``'s formulas (the reference:
  ``cost_analysis()["flops"]``).
* **bytes**: the eager program's reads and writes, every non-view local
  operation's operand and result bytes, with no fusion (the reference:
  ``"bytes accessed"`` of the fused program, so this term runs higher).
* **collective**: the wire bytes of the functional collectives DTensor
  issues.  Each is recorded with its result bytes and group size and
  scaled per op type as the reference scales the HLO's (all-reduce moves
  ~2·(N-1)/N× its buffer in a ring; all-gather and reduce-scatter
  (N-1)/N×; permute 1×).  A 16-wide ``model`` axis spans two 8-GPU
  NVLink domains, so this term is a lower bound on H100s.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.launch import mesh as mesh_lib

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}


def _wire_factor(op: str, group_size: int) -> float:
    n = max(group_size, 1)
    if op.startswith("all-reduce"):
        return 2.0 * (n - 1) / n
    if op.startswith(("all-gather", "reduce-scatter")):
        return (n - 1) / n
    if op.startswith("all-to-all"):
        return (n - 1) / n
    return 1.0  # collective-permute


def collective_bytes(collectives) -> dict:
    """Per-op-kind wire bytes (per chip) summed over the step, from its
    recorded collectives: ``(op, result bytes, group size)`` each, with
    the HLO op names (``all-gather``, ...)."""
    out: dict[str, float] = {}
    total = 0.0
    for op, result_bytes, group in collectives:
        b = result_bytes * _wire_factor(op, group)
        out[op] = out.get(op, 0.0) + b
        total += b
    out["total"] = total
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float               # 6·N·D (dense) / 6·N_active·D (MoE)
    peak_mem_bytes: float            # traced temp+args+output
    n_chips: int

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global traced FLOPs — remat/dispatch waste
        detector."""
        hlo_global = self.flops_per_chip * self.n_chips
        return self.model_flops / hlo_global if hlo_global > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: the score we hillclimb."""
        t_useful = self.model_flops / (self.n_chips
                                       * mesh_lib.PEAK_FLOPS_BF16)
        return t_useful / self.t_bound if self.t_bound > 0 else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(bottleneck=self.bottleneck, useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction,
                 t_bound=self.t_bound)
        return d


def memory_dict(trace) -> dict:
    """The reference's ``memory_analysis()`` fields from a
    :class:`~repro_torch.launch.cost.CostTrace`."""
    return {
        "argument_size": trace.argument_bytes,
        "output_size": trace.output_bytes,
        "temp_size": trace.temp_bytes,
        "generated_code_size": 0,
        "per_chip_total": (trace.argument_bytes + trace.output_bytes
                           + trace.temp_bytes),
    }


def analyze(trace, *, arch: str, shape: str, mesh_name: str, n_chips: int,
            model_flops: float) -> Roofline:
    """The :class:`Roofline` of a traced step
    (:class:`~repro_torch.launch.cost.CostTrace`)."""
    flops = float(trace.flops)
    byts = float(trace.bytes)
    coll = collective_bytes(trace.collectives)
    mem = memory_dict(trace)
    peak = (mem["argument_size"] + mem["output_size"] + mem["temp_size"])
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_chip=flops, bytes_per_chip=byts,
        coll_bytes_per_chip=coll["total"], coll_breakdown=coll,
        t_compute=flops / mesh_lib.PEAK_FLOPS_BF16,
        t_memory=byts / mesh_lib.HBM_BW,
        t_collective=coll["total"] / mesh_lib.ICI_BW,
        model_flops=model_flops, peak_mem_bytes=float(peak),
        n_chips=n_chips,
    )


def model_flops_train(cfg, tokens: int) -> float:
    """6·N·D with N = active params (MoE: top-k experts + shared)."""
    n = active_param_count(cfg)
    return 6.0 * n * tokens


def model_flops_prefill(cfg, tokens: int) -> float:
    """Forward only: 2·N·D."""
    return 2.0 * active_param_count(cfg) * tokens


def model_flops_decode(cfg, batch: int) -> float:
    """Per decode step: 2·N_active per generated token (fwd only) — plus the
    KV-cache read is memory, not FLOPs."""
    return 2.0 * active_param_count(cfg) * batch


def active_param_count(cfg) -> float:
    """Params touched per token (MoE counts top_k of num_experts)."""
    total = cfg.param_count()
    if cfg.num_experts:
        d, f, e, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
        expert_params = 3 * d * f
        n_moe_layers = (cfg.block_pattern * cfg.num_groups
                        + cfg.tail_pattern).count("moe")
        total = total - n_moe_layers * e * expert_params \
            + n_moe_layers * k * expert_params
    return float(total)


def render_table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':9s} {'flops/chip':>11s} "
           f"{'bytes/chip':>11s} {'coll B/chip':>11s} {'t_comp':>9s} "
           f"{'t_mem':>9s} {'t_coll':>9s} {'bound':>10s} {'useful':>7s} "
           f"{'roofline':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:9s} "
            f"{r.flops_per_chip:11.3e} {r.bytes_per_chip:11.3e} "
            f"{r.coll_bytes_per_chip:11.3e} {r.t_compute:9.2e} "
            f"{r.t_memory:9.2e} {r.t_collective:9.2e} "
            f"{r.bottleneck:>10s} {r.useful_ratio:7.3f} "
            f"{r.roofline_fraction:8.3f}")
    return "\n".join(lines)


def save_json(rows: list[Roofline], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in rows], f, indent=2)
