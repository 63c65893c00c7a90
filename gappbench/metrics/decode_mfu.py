"""Model step: the decode steps' share of the card's roof, each step's
bound (the larger of its FLOPs over the bf16 peak and its bytes over the
HBM rate, counted from shapes: the weights once and each slot's written
cache rows) summed over the window, over the window."""
from gappbench import yardstick as ys

KIND = "per_layer"
UNIT = "%"


def read(rec):
    if rec["entry"] != "decode" or rec["trace"] is None:
        return None
    bound = sum(d["bound_s"] for d in ys.decode_steps(rec))
    return 100.0 * bound / rec["window_s"]
