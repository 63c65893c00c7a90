"""The program's spans in a traced window, as ``spanrun.py`` reduces them
(``spantrace.py``): device and host seconds and counts by span, and the
drains, ``[begin, device_begin, device_end, end, events]`` in seconds
from the window's start (the device pair None where the fold used no
device)."""


def reduction(rec, entry: str, device: bool = True):
    """The record's span reduction, or None: another entry, a window not
    reduced by span, or (for a ``device`` reading) no device work traced."""
    sp = (rec.get("trace") or {}).get("spans")
    if rec["entry"] != entry or not sp or (device and not sp["busy_s"]):
        return None
    return sp


def per_step_ms(rec, entry: str, span: str, kind: str = "device_s"):
    """Milliseconds a step in ``span`` (``device_s`` or ``host_s``), or
    None where the window holds no such span."""
    sp = reduction(rec, entry, device=kind == "device_s")
    if sp is None or not sp["count"].get(span):
        return None
    steps = len(rec["step_s"]) if entry == "decode" else rec["steps"]
    return sp[kind].get(span, 0.0) / steps * 1e3 if steps else None


def drain_device_ms(rec, entry: str):
    """Mean milliseconds of a folding drain's device segment: the fold
    prefix's upload through its read-back, queued behind whatever the
    device's stream already holds."""
    sp = reduction(rec, entry)
    segs = [d[2] - d[1] for d in sp["drains"] if d[1] is not None] \
        if sp is not None else []
    return sum(segs) / len(segs) * 1e3 if segs else None
