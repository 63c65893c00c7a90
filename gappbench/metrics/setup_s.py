"""Set-up: process start to the window's first timed step (weights made
on the card, the engine or trainer built, the kernels' libraries loaded or
built, warm-up and the checked steps)."""
KIND = "end_to_end"
UNIT = "s"


def read(rec):
    return rec["setup_s"]
