"""Positions trained in the window's completed steps (the patch prefix
counted) over the window."""
KIND = "end_to_end"
UNIT = "tokens/s"


def read(rec):
    if rec["entry"] != "train":
        return None
    return rec["steps"] * rec["positions"] / rec["window_s"]
