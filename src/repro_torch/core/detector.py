"""Bottleneck detection & post-processing (paper §4.4).

Inputs: critical timeslices (from the live tracer or recomputed offline from
an :class:`EventLog`), and conditional samples from the sampling probe.

Pipeline (exactly the paper's user-space probe):
  1. attach each sample to the enclosing critical timeslice of its worker;
  2. *merge* timeslices that share a call path — CMetrics are summed and the
     sampled tags folded into one frequency table per path;
  3. rank call paths by cumulative CMetric and keep the top N;
  4. if a critical slice has no samples and its exit-time active count was
     ≤ n_min, attach the top-of-stack tag labelled ``stack_top`` (§4.4
     "Critical timeslices with no samples").

Two merge implementations:

* :func:`merge_table` — the production path, fully vectorised over the
  columnar :class:`~repro_torch.core.slices.SliceTable`: one ``searchsorted`` per
  worker group for sample attachment (instead of two per slice), path merge
  via grouped ``bincount`` keyed on stack id, and tag frequency tables via a
  flat (path, tag) histogram that runs through the CUDA ``tag_hist``
  kernel on the fused backend.
* :func:`_merge_python` — the original per-slice Python loop, retained as
  the equivalence oracle for tests and as the reference semantics.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import backends as backends_lib
from repro_torch.core.events import EventLog
from repro_torch.core.sampler import SampleBuffer, simulate_samples
from repro_torch.core.slices import CriticalSlice, SliceTable
from repro_torch.core.tracer import StackRegistry, TagRegistry, Tracer


@dataclasses.dataclass
class PathProfile:
    """One merged call path (the unit of the final ranking)."""

    stack: tuple[int, ...]                 # interned tag ids, caller->callee
    cmetric: float = 0.0
    slices: int = 0
    tag_counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    stack_top_counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)   # fallback samples (§4.4)

    def top_tags(self, k: int = 5):
        merged = collections.Counter(self.tag_counts)
        return merged.most_common(k)


@dataclasses.dataclass
class BottleneckReport:
    paths: list[PathProfile]               # sorted by cmetric, desc, top-N
    per_worker: np.ndarray                 # cumulative CMetric per worker
    worker_names: list[str]
    tag_names: list[str]
    tag_locations: list[str]
    total_critical: int
    total_slices: int
    idle_time: float
    total_time: float
    critical_table: SliceTable | None = None   # the merged slices, columnar
    # host provenance (fleet ingest): worker_hosts[wid] names the host that
    # produced worker ``wid``; None for single-host sessions
    worker_hosts: list[str] | None = None
    # counterfactual replay handle (repro_torch.core.whatif.ReplaySpec) attached
    # by detect()/detect_offline()/offline snapshots; None when the capture
    # is not recoverable (e.g. build_report() called directly)
    replay: object | None = dataclasses.field(default=None, repr=False)

    @property
    def critical_ratio(self) -> float:     # paper Table 2 "CR" column
        return self.total_critical / max(self.total_slices, 1)

    # -- causal what-if (repro_torch.core.whatif) -----------------------------------
    def what_if(self, tag=None, *, shrink: float = 0.0, host=None,
                worker=None, path=None, top_n: int = 10):
        """Counterfactual projection: replay the fold with the target's
        critical slices shrunk by ``shrink`` (0.0 == removed) and report
        projected speedup, the new ranking, and per-worker load shift.
        See :func:`repro_torch.core.whatif.what_if`."""
        from repro_torch.core import whatif as whatif_lib
        return whatif_lib.what_if(self, tag, shrink=shrink, host=host,
                                  worker=worker, path=path, top_n=top_n)

    def sensitivity(self, params: dict | None = None, *, top_k: int = 5):
        """Perturbation sweep over detection parameters (``n_min`` /
        sampling cadence) reporting rank stability.  See
        :func:`repro_torch.core.whatif.sensitivity`."""
        from repro_torch.core import whatif as whatif_lib
        return whatif_lib.sensitivity(self, params, top_k=top_k)

    def tag_name(self, tid: int) -> str:
        if 0 <= tid < len(self.tag_names):
            return self.tag_names[tid]
        return "<unknown>"

    def path_str(self, p: PathProfile) -> str:
        return " > ".join(self.tag_name(t) for t in p.stack) or "<no-path>"

    # -- host-provenance views (fleet reports) -------------------------------
    @property
    def hosts(self) -> list[str]:
        """Distinct host names in worker order ([] for single-host)."""
        if not self.worker_hosts:
            return []
        return list(dict.fromkeys(self.worker_hosts))

    def host_of_worker(self, wid: int) -> str | None:
        if self.worker_hosts and 0 <= wid < len(self.worker_hosts):
            return self.worker_hosts[wid]
        return None

    def per_host(self) -> dict[str, dict]:
        """Group the fleet-wide numbers per host: cumulative CMetric,
        worker count, and the critical-slice share (count / summed CMetric
        / mean ``threads_av``) of each host's workers.  Empty for
        single-host reports — everything is already 'this host'."""
        if not self.worker_hosts:
            return {}
        hosts = self.hosts
        idx = {h: i for i, h in enumerate(hosts)}
        wh = np.asarray([idx[h] for h in self.worker_hosts], np.int64)
        out = {}
        pw = self.per_worker
        ct = self.critical_table
        for h in hosts:
            mask = wh == idx[h]
            wids = np.flatnonzero(mask)
            row = {
                "workers": int(mask.sum()),
                "cmetric_s": float(pw[wids[wids < pw.shape[0]]].sum())
                if pw.size else 0.0,
                "critical": 0,
                "critical_cm_s": 0.0,
                "threads_av_mean": None,
            }
            if ct is not None and len(ct):
                cmask = np.isin(ct.worker, wids)
                row["critical"] = int(cmask.sum())
                if cmask.any():
                    row["critical_cm_s"] = float(ct.cm[cmask].sum())
                    row["threads_av_mean"] = float(
                        np.mean(ct.threads_av[cmask]))
            out[h] = row
        return out


# ---------------------------------------------------------------------------
# merge: vectorised table pipeline (production) + Python loop (oracle)
# ---------------------------------------------------------------------------

def _path_groups(stack_ids: np.ndarray, stacks: StackRegistry):
    """Group slice rows by call path, preserving first-seen order.

    Distinct stack ids can resolve to the same path key (NO_STACK and any
    out-of-range id both mean "no path"), so grouping goes through the path
    tuple.  Work is O(unique ids), not O(slices).
    """
    sid_vals, first_idx, inv = np.unique(stack_ids, return_index=True,
                                         return_inverse=True)
    paths = stacks.paths
    gid_of_val = np.zeros(len(sid_vals), np.int64)
    path_by_gid: list[tuple] = []
    seen: dict[tuple, int] = {}
    for k in np.argsort(first_idx, kind="stable"):
        sid = int(sid_vals[k])
        path = paths[sid] if 0 <= sid < len(paths) else ()
        g = seen.get(path)
        if g is None:
            g = seen[path] = len(path_by_gid)
            path_by_gid.append(path)
        gid_of_val[k] = g
    return gid_of_val[inv], path_by_gid


def _attach_samples(crit: SliceTable, samples: SampleBuffer | None):
    """Vectorised step 1: map every sample to its enclosing critical slices.

    Slices are sorted by (worker, start); per *worker group* (not per slice)
    two ``searchsorted`` calls bound the contiguous run of slices whose
    inclusive ``[start, end]`` window contains each sample — a worker's
    slices are time-disjoint, so starts *and* ends are non-decreasing within
    a group, and a sample on a shared boundary (end of one slice == start of
    the next) lands in both, exactly like the per-slice oracle's two-sided
    range check.  Returns (slice row indices, sample tags) of the attached
    samples, one entry per (sample, slice) match.
    """
    if samples is None or len(samples) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    st, sw, stag = samples.frozen_sorted()
    order = np.lexsort((crit.start_ns, crit.worker))
    cw = crit.worker[order]
    cs = crit.start_ns[order]
    ce = crit.end_ns[order]
    grp_w, grp_lo = np.unique(cw, return_index=True)
    grp_hi = np.append(grp_lo[1:], len(cw))
    rows, tags = [], []
    for g in range(len(grp_w)):
        lo = np.searchsorted(sw, grp_w[g], side="left")
        hi = np.searchsorted(sw, grp_w[g], side="right")
        if lo == hi:
            continue
        tw = st[lo:hi]
        a, b = grp_lo[g], grp_hi[g]
        j_lo = np.searchsorted(ce[a:b], tw, side="left")
        j_hi = np.searchsorted(cs[a:b], tw, side="right")
        counts = np.maximum(j_hi - j_lo, 0)
        total = int(counts.sum())
        if total == 0:
            continue
        # expand each sample to its [j_lo, j_hi) run of enclosing slices
        base = np.repeat(j_lo, counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        rows.append(order[a + base + offs])
        tags.append(np.repeat(stag[lo:hi], counts))
    if not rows:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    return np.concatenate(rows), np.concatenate(tags)


def _key_hist(keys: np.ndarray, num_bins: int,
              device: torch.device | None = None) -> np.ndarray:
    """Histogram of flat (group, tag) keys: on the ``tag_hist`` kernel when
    a ``device`` is given (the fused backend on CUDA), ``bincount``
    otherwise."""
    if device is not None and num_bins <= (1 << 20):
        from repro_torch.kernels import ops
        counts, _ = ops.tag_histogram(
            torch.from_numpy(np.asarray(keys, np.int32)).to(device),
            num_bins=num_bins)
        return counts.cpu().numpy()
    return np.bincount(keys, minlength=num_bins)


def merge_table(
    crit: SliceTable,
    samples: SampleBuffer | None,
    stacks: StackRegistry,
    n_min: float,
    *,
    hist_device: torch.device | None = None,
) -> tuple[list[PathProfile], int]:
    """Steps 1/2/4 over the columnar IR.  Returns the merged profiles in
    first-seen path order (the seed dict-insertion order, so downstream
    ranking tie-breaks identically) and the attached-sample count."""
    s = len(crit)
    if s == 0:
        return [], 0
    gids, path_by_gid = _path_groups(crit.stack_id, stacks)
    ngroups = len(path_by_gid)
    cm_sum = np.bincount(gids, weights=crit.cm, minlength=ngroups)
    n_slices = np.bincount(gids, minlength=ngroups)

    rows, tags = _attach_samples(crit, samples)
    attached = int(rows.size)
    per_slice_hits = np.bincount(rows, minlength=s)

    # per-(path, tag) frequency tables via one flat histogram; the +1 offset
    # admits NO_TAG (-1) samples, which the per-slice Counter also recorded
    tag_tables: list[collections.Counter] = [collections.Counter()
                                             for _ in range(ngroups)]
    if attached:
        k = int(tags.max()) + 2
        counts = _key_hist(gids[rows] * k + (tags.astype(np.int64) + 1),
                           ngroups * k, hist_device)
        for key in np.flatnonzero(counts):
            tag_tables[key // k][int(key % k) - 1] = int(counts[key])

    # stack-top fallback (§4.4): sampleless slice, low exit parallelism
    path_len = np.asarray([len(p) for p in path_by_gid])
    fb_mask = ((per_slice_hits == 0) & (crit.n_at_exit <= n_min)
               & (path_len[gids] > 0))
    fallbacks = np.bincount(gids[fb_mask], minlength=ngroups)

    profiles = []
    for g in range(ngroups):
        p = PathProfile(stack=path_by_gid[g], cmetric=float(cm_sum[g]),
                        slices=int(n_slices[g]), tag_counts=tag_tables[g])
        if fallbacks[g]:
            p.stack_top_counts[path_by_gid[g][-1]] = int(fallbacks[g])
        profiles.append(p)
    return profiles, attached


def _merge_python(
    slices: list[CriticalSlice],
    samples: SampleBuffer | None,
    stacks: StackRegistry,
    n_min: float,
) -> tuple[dict[tuple, PathProfile], int]:
    """Seed per-slice merge loop — the equivalence oracle for
    :func:`merge_table` (two searchsorted per slice, Counter updates)."""
    by_path: dict[tuple, PathProfile] = {}
    if not slices:
        return by_path, 0
    if samples is not None and len(samples):
        st, sw, stag = samples.frozen()
        order = np.lexsort((st, sw))
        st, sw, stag = st[order], sw[order], stag[order]
    else:
        st = np.zeros(0, np.int64)
        sw = np.zeros(0, np.int32)
        stag = np.zeros(0, np.int32)
    attached = 0
    for cs in slices:
        path = stacks.paths[cs.stack_id] if 0 <= cs.stack_id < len(stacks.paths) \
            else ()
        prof = by_path.get(path)
        if prof is None:
            prof = by_path[path] = PathProfile(stack=path)
        prof.cmetric += cs.cm
        prof.slices += 1
        # samples of this worker inside [start, end]
        lo = np.searchsorted(sw, cs.worker, side="left")
        hi = np.searchsorted(sw, cs.worker, side="right")
        a = lo + np.searchsorted(st[lo:hi], cs.start_ns, side="left")
        b = lo + np.searchsorted(st[lo:hi], cs.end_ns, side="right")
        if b > a:
            prof.tag_counts.update(stag[a:b].tolist())
            attached += int(b - a)
        elif cs.n_at_exit <= n_min and path:
            # no samples: fall back to the stack top (caller return address)
            prof.stack_top_counts.update([path[-1]])
    return by_path, attached


# Back-compat alias (seed name).
_merge = _merge_python


def build_report(
    crit: SliceTable,
    samples: SampleBuffer | None,
    stacks: StackRegistry,
    n_min: float,
    *,
    per_worker: np.ndarray,
    worker_names: list[str],
    tag_names: list[str],
    tag_locations: list[str],
    total_slices: int,
    idle_time: float,
    total_time: float,
    top_n: int = 10,
    hist_device: torch.device | None = None,
    worker_hosts: list[str] | None = None,
) -> BottleneckReport:
    """Merge + rank a critical-slice table into a :class:`BottleneckReport`.

    The shared tail of every detection path — live :func:`detect`, offline
    :func:`detect_offline`, and the incremental
    :meth:`~repro_torch.core.session.ProfileSession.snapshot`, which calls this
    directly on the carried fold state mid-capture.  ``worker_hosts`` tags
    each worker with its origin host (fleet ingest); ``hist_device`` runs
    the (path, tag) histogram on the ``tag_hist`` kernel there."""
    paths_all, _ = merge_table(crit, samples, stacks, n_min,
                               hist_device=hist_device)
    paths = sorted(paths_all, key=lambda p: -p.cmetric)[:top_n]
    return BottleneckReport(
        paths=paths,
        per_worker=np.asarray(per_worker, np.float64),
        worker_names=worker_names,
        tag_names=tag_names,
        tag_locations=tag_locations,
        total_critical=len(crit),
        total_slices=total_slices,
        idle_time=idle_time,
        total_time=total_time,
        critical_table=crit,
        worker_hosts=worker_hosts,
    )


def detect(
    tracer: Tracer,
    samples: SampleBuffer | None = None,
    top_n: int = 10,
    budgeted: bool = False,
) -> BottleneckReport:
    """Live-mode detection from the tracer's batched online state (one
    ``snapshot()``: pending shard events are drained and folded once, and
    every reported number comes from the same sync point).  ``budgeted``
    caps that flush at the tracer's ``max_rows_per_sync`` decode budget —
    bounded latency, possibly lagging the capture by the backlog."""
    n_min = tracer._resolved_n_min()
    # keyword only when asked: LockedTracer's snapshot has no budget
    snap = tracer.snapshot(budgeted=True) if budgeted else tracer.snapshot()
    crit = snap["critical"]
    rep = build_report(
        crit, samples, tracer.stacks, n_min,
        per_worker=snap["per_worker"],
        worker_names=tracer.worker_names(),
        tag_names=list(tracer.tags.names),
        tag_locations=list(tracer.tags.locations),
        total_slices=snap["total_slices"],
        idle_time=snap["idle_time"],
        total_time=snap["total_time"],
        top_n=top_n,
    )
    from repro_torch.core.whatif import ReplaySpec
    rep.replay = ReplaySpec(
        log_provider=tracer.freeze, tags=tracer.tags, stacks=tracer.stacks,
        n_min=n_min, samples=samples, worker_names=tracer.worker_names())
    return rep


def detect_offline(
    log: EventLog,
    tags: TagRegistry,
    stacks: StackRegistry,
    n_min: float,
    samples: SampleBuffer | None = None,
    sample_dt_ns: int | None = None,
    backend: str = "fused",
    top_n: int = 10,
    worker_names: list[str] | None = None,
    chunk_events: int | None = None,
    device=None,
) -> BottleneckReport:
    """Offline pipeline: recompute CMetric from a raw event log with any
    registered backend (numpy / vector / fused), optionally
    replaying the sampling probe, then run the same merge+rank
    post-processing — all stages over the columnar slice table.

    Raw logs are sanitized first (spurious double-ACTIVATE / unmatched
    DEACTIVATE are dropped exactly as the live tracer would), so adversarial
    streams produce the same report on every backend.

    ``chunk_events`` streams the fold: the log is pushed through the
    backend's carry-resumable ``fold_chunk`` in batches of that many
    events, sanitizing each chunk with carried per-worker state, and only
    the *critical* slice rows are retained between chunks — so arbitrarily
    long logs profile in memory bounded by the chunk size plus the critical
    set.  Results are identical to the whole-log path (bit-equal for the
    float64 ``numpy`` backend).

    Device backends run on ``device`` (default:
    :func:`repro_torch.device.default_device`); the fused backend on CUDA
    also runs the detector's (path, tag) histogram on the card.
    """
    with device_lib.use_device(device):
        raw_log = log
        if chunk_events is not None and len(log):
            from repro_torch.core.cmetric import FoldCarry
            from repro_torch.core.events import sanitize_chunk
            carry = FoldCarry.init(log.num_workers)
            crit_parts = []
            for lo in range(0, len(log), chunk_events):
                part = log.chunk(lo, lo + chunk_events)
                # carry.open is the Table-1 per-worker state: sanitize against
                # it, and the fold advances it after consuming the clean chunk
                part, _, _ = sanitize_chunk(part, carry.open)
                carry, tbl = backends_lib.fold_chunk(carry, part,
                                                     backend=backend)
                ct = tbl.critical(n_min)
                if len(ct):
                    crit_parts.append(ct)
            crit = SliceTable.concat(crit_parts)
            per_worker, idle, total = carry.per_worker, carry.idle, carry.total_time
            num_slices = carry.slices
            if samples is None and sample_dt_ns is not None:
                samples = simulate_samples(log.sanitize(), sample_dt_ns, n_min)
        else:
            log = log.sanitize()
            res = backends_lib.compute(log, backend=backend)
            if samples is None and sample_dt_ns is not None:
                samples = simulate_samples(log, sample_dt_ns, n_min)
            crit = res.critical_table(n_min)
            per_worker, idle, total = res.per_worker, res.idle_time, res.total_time
            num_slices = res.num_slices
        caps = backends_lib.get_backend(backend).capabilities
        hist_device = None
        if "fused" in caps:
            dev = device_lib.resolve()
            hist_device = dev if dev.type == "cuda" else None
        rep = build_report(
            crit, samples, stacks, n_min,
            per_worker=per_worker,
            worker_names=worker_names or [f"w{i}" for i in range(log.num_workers)],
            tag_names=list(tags.names),
            tag_locations=list(tags.locations),
            total_slices=num_slices,
            idle_time=idle,
            total_time=total,
            top_n=top_n,
            hist_device=hist_device,
        )
        from repro_torch.core.whatif import ReplaySpec
        rep.replay = ReplaySpec(
            log_provider=lambda: raw_log, tags=tags, stacks=stacks, n_min=n_min,
            backend=backend, samples=samples, sample_dt_ns=sample_dt_ns,
            worker_names=worker_names, chunk_events=chunk_events, device=device)
        return rep


def critical_slices_from_result(log, res, n_min: float) -> list[CriticalSlice]:
    """Legacy view: critical rows of an offline result as per-slice records
    (the columnar pipeline uses ``res.critical_table(n_min)`` directly)."""
    del log  # times are already on the log's ns clock inside the table
    return res.critical_table(n_min).to_records()
