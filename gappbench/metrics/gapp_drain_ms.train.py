"""GAPP session: the mean host time of a drain that folded events (the
tracer's sync: merge, tolerance rules and the fold's prefix on the card,
read back), in the train cells."""
KIND = "per_layer"
UNIT = "ms"


def read(rec):
    if rec["entry"] != "train" or not rec["drain_s"]:
        return None
    return sum(rec["drain_s"]) / len(rec["drain_s"]) * 1e3
