"""Every token the engine emitted in the window over the window."""
KIND = "end_to_end"
UNIT = "tokens/s"


def read(rec):
    if rec["entry"] != "decode":
        return None
    return sum(rec["tokens"]) / rec["window_s"]
