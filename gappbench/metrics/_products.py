"""The device time of the matrix-product kernels in a traced window,
matched by name (cuBLAS's kernels on this toolkit: nvjet_*, *gemm*,
*gemv*, cutlass and xmma kernels).  A hand-written product kernel that
takes the weight products over has to carry one of these names, or the
share it feeds reads too high."""
PATTERNS = ("nvjet", "gemm", "gemv", "xmma", "cutlass")


def seconds(trace: dict) -> float:
    return sum(v[0] for k, v in trace["kernels"].items()
               if any(p in k.lower() for p in PATTERNS))
