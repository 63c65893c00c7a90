"""The GAPP layer's check: the session's report against the plain fold of
the event log the session captured.

The capture itself (the timestamps of each span's begin and end) is the
program's own state; the reference can only fold it again.  So the
capture is checked apart: the log must hold one ACTIVATE and one
DEACTIVATE for every span the harness saw begin and end, and nothing was
dropped.  The fold, the critical set and the ranking are then held to the
float64 fold of that log.  The session keeps the running global CMetric
in float32, so a slice whose threads_av lies within that rounding of
``n_min`` may fall on either side: such slices (a rule on the reference's
own numbers, :func:`gapp_fold.float32_ambiguous`) are not counted as
flips.  Two faults planted in the report stand for a ranking that goes
wrong: its heaviest critical slice left out, and the report's tags
permuted.
"""
from __future__ import annotations

import time

import numpy as np

from gappbench.reference import gapp_fold


def time_drains(session, out: list) -> None:
    """Append to ``out`` the host seconds of every drain of the session
    that folded events (the tracer's ``sync``, which the drain loop
    calls)."""
    tracer = session.tracer
    real = tracer.sync
    folded: list = []

    def sync(*a, **k):
        n = len(folded)
        t = time.perf_counter()
        result = real(*a, **k)
        if len(folded) > n:
            out.append(time.perf_counter() - t)
        return result
    tracer.sync = sync
    tracer.on_drain.append(folded.append)


def capture(session) -> dict:
    """What the check reads from a closed session: its report and its
    frozen log, as plain columns."""
    rep = session.result()
    log = session.freeze()
    crit = rep.critical_table
    top = rep.paths[0] if rep.paths else None
    return {
        "per_worker": np.asarray(rep.per_worker, np.float64),
        "crit_worker": np.asarray(crit.worker if crit is not None else [],
                                  np.int64),
        "crit_end": np.asarray(crit.end_ns if crit is not None else [],
                               np.int64),
        "crit_cm": np.asarray(crit.cm if crit is not None else [],
                              np.float64),
        "top_tag": None if top is None or not top.stack else top.stack[-1],
        "times": np.asarray(log.times, np.int64),
        "workers": np.asarray(log.workers, np.int64),
        "deltas": np.asarray(log.deltas, np.int64),
        "tags": np.asarray(log.tags, np.int64),
        "num_workers": int(log.num_workers),
        "stats": session.stats(),
    }


def _flips(cap: dict, ref: dict, n_min: float, loose: set) -> int:
    """Slices critical on one side only, leaving out those in ``loose``:
    a program slice matches the reference slice of its worker that ends
    within a microsecond of it."""
    ends: dict = {}
    crit = gapp_fold.critical_keys(ref, n_min)
    for w, end, *_ in ref["slices"]:
        ends.setdefault(w, []).append(end)
    flips = 0
    for w, end in zip(cap["crit_worker"].tolist(), cap["crit_end"].tolist()):
        cand = ends.get(w, [])
        j = int(np.argmin(np.abs(np.asarray(cand) - end))) if cand else -1
        if j < 0 or abs(cand[j] - end) > 1000:
            flips += 1
            continue
        key = (w, cand.pop(j))
        if key in crit:
            crit.discard(key)
        elif key not in loose:
            flips += 1
    return flips + len(crit - loose)


def drop_critical(cap: dict) -> dict:
    """A fault: the report without its heaviest critical slice."""
    if cap["crit_cm"].size == 0:
        return cap
    keep = np.arange(cap["crit_cm"].size) != int(np.argmax(cap["crit_cm"]))
    return dict(cap, crit_worker=cap["crit_worker"][keep],
                crit_end=cap["crit_end"][keep], crit_cm=cap["crit_cm"][keep])


def permute_tags(cap: dict) -> dict:
    """A fault: the report's tags permuted, each to the next tag its log's
    spans carry (a tag of its own where they carry one), so its top path
    names another tag."""
    top = cap["top_tag"]
    if top is None:
        return cap
    tags = np.unique(cap["tags"][cap["deltas"] == gapp_fold.ACTIVATE])
    if tags.size < 2:
        return dict(cap, top_tag=int(tags.max(initial=top)) + 1)
    i = int(np.searchsorted(tags, top))
    return dict(cap, top_tag=int(tags[(i + 1) % tags.size]))


FAULTS = {"drop_critical": drop_critical, "permute_tags": permute_tags}


def readings(cap: dict, dtype=np.float64) -> dict:
    """The three compared numbers of the session ``cap`` against the fold
    of its log in ``dtype`` (float64: the reference; float16: the
    control, which is read as if it were the program): the largest
    per-worker CMetric gap over the largest worker's CMetric, the count of
    slices critical on one side only, and how far the top path's summed
    CMetric lies below the best path's, as a share of the best's.  Slices
    that float32 rounding of the global CMetric could put on either side
    of ``n_min`` are not counted as flips."""
    args = (cap["times"], cap["workers"], cap["deltas"], cap["tags"],
            cap["num_workers"])
    ref = gapp_fold.fold(*args)
    n_min = cap["num_workers"] / 2
    loose = gapp_fold.float32_ambiguous(ref, n_min)
    if dtype is np.float64:
        pw = cap["per_worker"]
        flips = _flips(cap, ref, n_min, loose)
        top = cap["top_tag"]
    else:
        low = gapp_fold.fold(*args, dtype=dtype)
        pw = low["per_worker"]
        flips = len((gapp_fold.critical_keys(low, n_min)
                     ^ gapp_fold.critical_keys(ref, n_min)) - loose)
        lp = gapp_fold.paths(low, n_min)
        top = max(lp, key=lp.get) if lp else None
    rp = gapp_fold.paths(ref, n_min)
    best = max(rp.values()) if rp else 0.0
    if best > 0:
        path_gap = (best - rp.get(top, 0.0)) / best
    else:
        path_gap = 0.0 if top is None else 1.0
    pr = ref["per_worker"]
    scale = max(float(np.max(np.abs(pr))) if pr.size else 0.0, 1e-12)
    n = min(len(pw), len(pr))
    err = float(np.max(np.abs(pw[:n] - pr[:n]))) / scale if n else 0.0
    if len(pw) != len(pr):
        err = max(err, 1.0)
    return {"gapp_cm_err": err, "gapp_crit_flips": float(flips),
            "gapp_path_gap": path_gap}


def capture_complete(cap: dict, spans_opened: int, spans_closed: int) -> str:
    """'' when the log holds what the harness saw (``spans_opened`` begins
    and ``spans_closed`` ends) and the capture dropped nothing, else why
    not."""
    act = int(np.sum(cap["deltas"] == gapp_fold.ACTIVATE))
    deact = int(cap["deltas"].size) - act
    st = cap["stats"]
    if st.get("ring_dropped") or st.get("tolerance_dropped"):
        return (f"capture dropped {st.get('ring_dropped')} events and "
                f"rejected {st.get('tolerance_dropped')}")
    if act < spans_opened or deact < spans_closed:
        return (f"capture holds {act} begins and {deact} ends, the harness "
                f"saw at least {spans_opened} and {spans_closed}")
    return ""
