"""Trainer loop: the host's mean time in the step call, before the
trainer reads the loss (forward, backward and AdamW issued)."""
KIND = "per_layer"
UNIT = "ms"


def read(rec):
    if rec["entry"] != "train" or not rec["issue_s"]:
        return None
    return sum(rec["issue_s"]) / len(rec["issue_s"]) * 1e3
