"""Device: the share of the traced window with nothing running on the
card (the union of its kernels, copies and sets), in the train cells."""
KIND = "per_layer"
UNIT = "%"


def read(rec):
    tr = rec["trace"]
    if rec["entry"] != "train" or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
