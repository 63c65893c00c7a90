"""Engine loop: the host's mean time to issue a decode step (the model
call, which returns before the device is done; the token read follows)."""
KIND = "per_layer"
UNIT = "ms"


def read(rec):
    if rec["entry"] != "decode" or not rec["issue_s"]:
        return None
    return sum(rec["issue_s"]) / len(rec["issue_s"]) * 1e3
