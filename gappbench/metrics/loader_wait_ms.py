"""Trainer loop: the mean time the trainer blocked in the prefetching
loader's ``get`` for a batch."""
KIND = "per_layer"
UNIT = "ms"


def read(rec):
    if rec["entry"] != "train" or not rec["loader_wait_s"]:
        return None
    return sum(rec["loader_wait_s"]) / len(rec["loader_wait_s"]) * 1e3
