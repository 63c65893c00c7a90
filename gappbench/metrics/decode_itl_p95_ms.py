"""The 95th percentile (nearest rank) of every inter-token gap in the
window: each step's end to the next one's, from the window's start."""
import math

KIND = "end_to_end"
UNIT = "ms"


def read(rec):
    if rec["entry"] != "decode":
        return None
    gaps = sorted(rec["step_s"])
    return gaps[math.ceil(0.95 * len(gaps)) - 1] * 1e3
