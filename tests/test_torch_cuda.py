"""The CUDA kernels against their plain PyTorch versions, on the card.

Ragged shapes (a partial last tile, one event, empty input), many-tile
prefixes with a carry by value and one on the device (one an earlier fold
returned), back-to-back calls (stale look-back state), errors against a
float64 prefix, bins on both sides of every threshold of the
histogram's paths and each path reached through K, skewed and
all-in-one-bin keys, and inputs that are not 16-byte aligned.  Tolerances: ``n`` and counts exact; float prefixes rtol 1e-5
(both are float32 scans, summed in another order); weighted histogram
rtol 1e-4 (float atomics in a varying order); the stream scan exact (the
same float32 operations in the same order).  Decode attention against a
float64 oracle of its own arithmetic (q scaled in its dtype, float32
weights): bfloat16 rtol 2^-8, the output's one rounding, atol 1e-5, the
float32 sums; float32 rtol/atol 1e-5; against its plain version, which
rounds the weights to bfloat16 before the product with v, rtol 2^-7 and
atol 2^-9 of the largest |v| besides.  Each test needs a CUDA card
and skips without one; run them there with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import cmetric_fold as fold_k
from repro_torch.kernels import decode_attn as attn_k
from repro_torch.kernels import tag_hist as hist_k


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stream(e, seed):
    """The fold sweep's input: +-1 deltas whose running count stays above
    -5 (so negative counts occur), sorted f32 times."""
    rng = np.random.default_rng(seed)
    deltas = rng.choice([-1, 1], size=e).astype(np.int32)
    deltas = np.abs(deltas) * (np.cumsum(deltas) > -5) * deltas
    t = np.sort(rng.random(e)).astype(np.float32)
    return t, deltas


def _fold_inputs(e, seed, dev, offset=0):
    """dt and deltas of :func:`_stream` on ``dev``; ``offset`` 1 hands over
    views that start one element into their storage."""
    t, deltas = _stream(e + offset, seed)
    dt = np.concatenate([np.diff(t), [0.0]]).astype(np.float32)
    return (torch.from_numpy(dt).to(dev)[offset:],
            torch.from_numpy(deltas).to(dev)[offset:])


def _fold_carry(carry_on, dev):
    """A carry by value, or the 0-d device tensors an earlier fold returns
    (its count, total and idle, in the order a carry takes them)."""
    if carry_on == "host":
        return (3.0, 0.5, 0.25)
    _, _, tot, idle, cnt = fold_k.fold(*_fold_inputs(5_000, 99, dev))
    return (cnt, tot, idle)


def _check_fold(k, p):
    assert torch.equal(k[0], p[0])
    np.testing.assert_allclose(k[1].cpu().numpy(), p[1].cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(k[2:], p[2:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("carry_on", ["host", "fold"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("e", [1, 7, 2047, 2048, 2049, 8191, 8192, 8193,
                               100_003, (1 << 22) + 3])
def test_cuda_fold_matches_plain(cuda_device, e, offset, carry_on):
    """8,191-8,193 events lie on the edge of one look-back tile, 2^22 + 3
    span 513 tiles; ``offset`` 1 hands over views that are not 16-byte
    aligned; ``carry_on`` "fold" resumes from the 0-d device tensors an
    earlier call returned."""
    dt, d = _fold_inputs(e, e + 11, cuda_device, offset)
    carry = _fold_carry(carry_on, cuda_device)
    before = fold_k.LAUNCHES["fold"]
    k = fold_k.fold(dt, d, carry)
    p = ref.fold_ref(dt, d, carry)
    torch.cuda.synchronize()
    assert fold_k.LAUNCHES["fold"] == before + 1
    _check_fold(k, p)


def test_cuda_fold_back_to_back(cuda_device):
    """50 calls queued on one stream without a synchronise, each with its
    own carry (negative counts among them): a status word left over from
    the call before would hand a tile a stale count or prefix."""
    dt, d = _fold_inputs((1 << 20) + 5, 7, cuda_device)
    carries = [(float(r - 25), 0.5 * r, 0.25 * r) for r in range(50)]
    outs = [fold_k.fold(dt, d, c) for c in carries]
    for c, k in zip(carries, outs):
        _check_fold(k, ref.fold_ref(dt, d, c))


def test_cuda_fold_error_vs_float64(cuda_device):
    """Against a float64 prefix of the same float32 contributions the
    kernel's gcm error is no worse than the plain float32 ``torch.cumsum``'s
    (the in-warp scan is float32, the carry across warps and tiles
    float64)."""
    dt, d = _fold_inputs((1 << 22) + 3, 3, cuda_device)
    carry = (2.0, 0.125, 0.0625)
    nk, gk, _, ik, _ = fold_k.fold(dt, d, carry)
    n_p, gp, _, _, _ = ref.fold_ref(dt, d, carry)
    assert torch.equal(nk, n_p)
    c = torch.where(nk > 0, dt / nk.clamp(min=1).float(),
                    torch.zeros_like(dt)).double()
    g64 = float(np.float32(0.125)) + torch.cumsum(c, 0) - c
    err_k = float((gk.double() - g64).abs().max())
    err_p = float((gp.double() - g64).abs().max())
    assert err_k <= err_p, (err_k, err_p)
    i64 = float(np.float32(0.0625)) + float(torch.where(
        (nk <= 0) & (dt > 0), dt, torch.zeros_like(dt)).double().sum())
    assert abs(float(ik) - i64) <= 1e-6 * i64


def _cumsum_inputs(e, seed, dev, offset=0):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.random(e + 1).astype(np.float32)).to(
        dev)[offset:offset + e]
    i = torch.from_numpy(rng.random(e + 1).astype(np.float32)).to(
        dev)[offset:offset + e]
    return c, i


@pytest.mark.parametrize("carry_on", ["host", "device"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("e", [1, 2049, 100_003, 1 << 20, (1 << 22) + 3])
def test_cuda_carry_cumsum_matches_plain(cuda_device, e, offset, carry_on):
    """``offset`` 1 hands over views that are not 16-byte aligned;
    ``carry_on`` "device" passes the carry as 0-d tensors on the card, as
    a carry returned by an earlier call is; 2^20 and 2^22 + 3 events span
    128 and 513 look-back tiles."""
    c, i = _cumsum_inputs(e, e, cuda_device, offset)
    carry = (0.25, 0.5)
    if carry_on == "device":
        carry = tuple(torch.tensor(x, device=cuda_device) for x in carry)
    before = fold_k.LAUNCHES["carry_cumsum"]
    gk, ek, ik = fold_k.carry_cumsum(c, i, carry)
    gp, ep, ip = ref.carry_cumsum_ref(c, i, (0.25, 0.5))
    assert fold_k.LAUNCHES["carry_cumsum"] == before + 1
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(ek), float(ep), rtol=1e-5)
    np.testing.assert_allclose(float(ik), float(ip), rtol=1e-5)


def test_cuda_carry_cumsum_back_to_back(cuda_device):
    """50 calls queued on one stream without a synchronise, each with its
    own carry: a status word left over from the call before would hand a
    tile a stale prefix."""
    e = (1 << 20) + 5
    c, i = _cumsum_inputs(e, 7, cuda_device)
    outs = [fold_k.carry_cumsum(c, i, (float(r), 0.5 * r)) for r in range(50)]
    for r, (gk, ek, ik) in enumerate(outs):
        gp, ep, ip = ref.carry_cumsum_ref(c, i, (float(r), 0.5 * r))
        np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(),
                                   rtol=1e-5, err_msg=f"call {r}")
        np.testing.assert_allclose(float(ek), float(ep), rtol=1e-5)
        np.testing.assert_allclose(float(ik), float(ip), rtol=1e-5)


def test_cuda_carry_cumsum_error_vs_float64(cuda_device):
    """Against a float64 prefix the kernel's error is no worse than the
    plain float32 ``torch.cumsum``'s (the in-tile scan is float32, the
    carry across tiles float64)."""
    e = (1 << 22) + 3
    c, i = _cumsum_inputs(e, 3, cuda_device)
    gk, _, ik = fold_k.carry_cumsum(c, i, (0.125, 0.0625))
    gp, _, _ = ref.carry_cumsum_ref(c, i, (0.125, 0.0625))
    g64 = float(np.float32(0.125)) + torch.cumsum(c.double(), 0)
    err_k = float((gk.double() - g64).abs().max())
    err_p = float((gp.double() - g64).abs().max())
    assert err_k <= err_p, (err_k, err_p)
    i64 = float(np.float32(0.0625)) + float(i.double().sum())
    assert abs(float(ik) - i64) <= 1e-6 * i64


# Bin counts on both sides of each threshold of the path chosen by K
# (csrc/tag_hist.cu, auto_path): 200 KB of shared memory for the shared
# path at 8 bytes a bin with weights and 4 without, then for counts alone
# a cluster of two blocks of at most 200 KB each.
THRESHOLD_PAIRS = [(25_600, 25_601), (51_200, 51_201), (102_400, 102_401)]


def _check_hist(tags, w, k):
    ck, wk = hist_k.hist(tags, w, num_bins=k)
    cp, wp = ref.hist_ref(tags, w, k)
    assert torch.equal(ck, cp)
    if w is None:
        assert torch.equal(wk, ck.float())
    np.testing.assert_allclose(wk.cpu().numpy(), wp.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    return hist_k.bins_path(k, w is not None)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("s,k", [(0, 3), (1, 1), (1000, 100),
                                 (300_001, 6144), (300_001, 6145),
                                 (100_000, 1 << 20),
                                 *[(200_003, k) for pair in THRESHOLD_PAIRS
                                   for k in pair]])
def test_cuda_hist_matches_plain(cuda_device, s, k, weighted):
    rng = np.random.default_rng(s + k)
    tags = torch.from_numpy(rng.integers(-3, k + 3, s).astype(np.int32)).to(
        cuda_device)
    w = (torch.from_numpy(rng.random(s, dtype=np.float32)).to(cuda_device)
         if weighted else None)
    _check_hist(tags, w, k)


@pytest.mark.parametrize("weighted", [True, False])
def test_cuda_hist_path_changes_at_each_threshold(cuda_device, weighted):
    tags = torch.arange(-2, 110_000, dtype=torch.int32, device=cuda_device)
    w = torch.ones(tags.shape[0], device=cuda_device) if weighted else None
    ks = [1000] + [k for pair in THRESHOLD_PAIRS for k in pair] + [1 << 20]
    paths = [_check_hist(tags, w, k) for k in ks]
    if weighted:
        assert paths == ["shared"] * 2 + ["global"] * 6
    else:
        assert paths == (["shared"] * 4 + ["cluster"] * 2
                         + ["global"] * 2)


# A K that puts the bins in each place (csrc/tag_hist.cu, bins_path); a
# cluster holds counts alone.
PATH_BINS = {("shared", True): 5_000, ("shared", False): 5_000,
             ("cluster", False): 60_000, ("global", True): 60_000,
             ("global", False): 200_000}


@pytest.mark.parametrize("path,weighted", sorted(PATH_BINS))
@pytest.mark.parametrize("pattern", ["one-bin", "32-distinct", "skewed"])
def test_cuda_hist_warp_aggregation(cuda_device, path, pattern, weighted):
    """Every sample in one bin, 32 distinct keys in every warp, and the
    detector's kind of skew (90% of samples in 64 bins), through each
    place the bins can live; counts exact, weighted sums rtol 1e-4."""
    s, k = 300_007, PATH_BINS[path, weighted]
    rng = np.random.default_rng(11)
    if pattern == "one-bin":
        tags = np.full(s, 17, np.int32)
    elif pattern == "32-distinct":
        tags = (((np.arange(s) // 4) % 32) * 131 + np.arange(s) // 4096) % k
    else:
        hot = rng.integers(0, k, 64)
        tags = np.where(rng.random(s) < 0.9, hot[rng.integers(0, 64, s)],
                        rng.integers(-1, k + 1, s))
    t = torch.from_numpy(tags.astype(np.int32)).to(cuda_device)
    w = (torch.from_numpy(rng.random(s, dtype=np.float32)).to(cuda_device)
         if weighted else None)
    assert _check_hist(t, w, k) == path


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("k", [4, 200_000])
def test_cuda_hist_counts_stay_exact_past_2_24_samples(cuda_device, k,
                                                        weighted):
    """Past 2^24 samples the global records count in int32 (a float32
    count stops growing at 2^24 in a bin that holds them all); K = 4 keeps
    the bins in shared memory, K = 200,000 in global memory."""
    s = (1 << 24) + 100
    tags = torch.full((s,), 3, dtype=torch.int32, device=cuda_device)
    tags[:50] = 1
    w = torch.ones(s, device=cuda_device) if weighted else None
    counts, _ = hist_k.hist(tags, w, num_bins=k)
    assert counts[:4].tolist() == [0, 50, 0, s - 50]
    assert int(counts[4:].sum()) == 0


@pytest.mark.parametrize("chunk_events", [None, 777])
def test_cuda_fused_detect_offline_matches_oracle(cuda_device, chunk_events):
    """The fused backend on the card goes through all three kernels and
    agrees with the float64 oracle (per-worker rtol 1e-4, the reference's
    float32 tolerance; slice counts and ranking exact)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from repro_torch import convert
    from repro_torch.core import detect_offline
    from repro_torch.kernels import ops
    log, tags, stacks, samples = convert.capture_from_numpy(
        *chip_smoke.make_capture(2, num_workers=64, rounds=64, group=4)[:5])
    ref_rep = detect_offline(log, tags, stacks, 8.0, samples=samples,
                             backend="numpy", chunk_events=chunk_events)
    ops.reset_launch_counts()
    rep = detect_offline(log, tags, stacks, 8.0, samples=samples,
                         backend="fused", chunk_events=chunk_events,
                         device=cuda_device)
    counts = ops.launch_counts()
    kernel = "fold" if chunk_events is None else "carry_cumsum"
    assert counts[kernel] >= 1 and counts["hist"] == 1, counts
    assert rep.total_slices == ref_rep.total_slices
    assert rep.total_critical == ref_rep.total_critical
    np.testing.assert_allclose(rep.per_worker, ref_rep.per_worker, rtol=1e-4,
                               atol=1e-6)
    assert [p.stack for p in rep.paths] == [p.stack for p in ref_rep.paths]
    assert rep.paths[0].stack == chip_smoke.INJECTED_PATH
    assert [dict(p.tag_counts) for p in rep.paths] == [
        dict(p.tag_counts) for p in ref_rep.paths]


def _stream_inputs(num_workers, slices, seed, dev):
    """A sanitized synthetic log's columns for ``stream_scan`` on ``dev``,
    and the log."""
    from repro_torch.core.events import synthetic_log
    log = synthetic_log(np.random.default_rng(seed), num_workers,
                        slices).sanitize()
    cols = (torch.from_numpy(log.slice_seconds().astype(np.float32)),
            torch.from_numpy(log.workers.astype(np.int32)),
            torch.from_numpy(log.deltas.astype(np.int32)))
    return [c.to(dev) for c in cols], log


def _check_stream(k, p):
    """The kernel and its plain version do the same float32 operations in
    the same order: every output is equal, not merely close."""
    assert torch.equal(k[0].cpu(), p[0].cpu())
    assert float(k[1]) == float(p[1]) and float(k[2]) == float(p[2])
    for a, b in zip(k[3], p[3]):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("num_workers,slices", [
    (1, 1), (3, 682), (1, 2048), (2, 1025), (4, 513), (64, 40), (1000, 9),
    (8, 4097), (1024, 2048)])
def test_cuda_stream_matches_plain(cuda_device, num_workers, slices):
    """4,092-4,104 events lie on both sides of one chain ring stage
    (4,096 events), 65,552 span 9 prepass tiles; 1,000 workers; 1,024 x
    2,048 is 2^22 events, 512 tiles."""
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), log = _stream_inputs(num_workers, slices, slices, cuda_device)
    before = stream_k.LAUNCHES["stream"]
    k = stream_k.stream_scan(t, w, d, num_workers)
    assert stream_k.LAUNCHES["stream"] == before + 1
    p = ref.stream_ref(t.cpu(), w.cpu(), d.cpu(), num_workers)
    torch.cuda.synchronize()
    assert k[3][0].shape[0] == int((log.deltas <= 0).sum())
    _check_stream(k, p)


def _dirty(seed, e=None, w=None):
    """Columns of a log the sanitizer would reject (a numpy copy of
    tests/test_torch_stream.py's ``_dirty``): switch-outs with no
    switch-in, repeated switch-ins, zero deltas (switch-outs to the scan),
    equal times and counts that go negative; ``e`` events and ``w``
    workers when given."""
    rng = np.random.default_rng(seed)
    e = int(rng.integers(1, 300)) if e is None else e
    w = int(rng.integers(1, 9)) if w is None else w
    t = np.sort(rng.integers(0, 50, e)).astype(np.float32) * np.float32(
        rng.choice([1e-3, 0.37, 1e3]))
    return (t.astype(np.float32), rng.integers(0, w, e).astype(np.int32),
            rng.choice([1, -1, 0], e).astype(np.int32), w)


def _dirty_on(dev, seed, e=None, w=None):
    t, wk, d, nw = _dirty(seed, e, w)
    return [torch.from_numpy(x).to(dev) for x in (t, wk, d)], nw


@pytest.mark.parametrize("seed", range(8))
def test_cuda_stream_matches_plain_on_dirty_logs(cuda_device, seed):
    """Logs no sanitizer touched: the pairing (the last switch-in at or
    before a switch-out, -1 without one) and the negative counts agree
    with the plain version bit for bit."""
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), nw = _dirty_on(cuda_device, seed)
    k = stream_k.stream_scan(t, w, d, nw)
    _check_stream(k, ref.stream_ref(t.cpu(), w.cpu(), d.cpu(), nw))


@pytest.mark.parametrize("e", [1, 2, 255, 256, 257, 4095, 4096, 4097,
                               8191, 8192, 8193, 3 * 8192 + 5])
def test_cuda_stream_at_the_edges_of_a_stage_and_a_tile(cuda_device, e):
    """E = 1, and E on both sides of a checkpoint of the walk (256
    events), of a chain ring stage (4,096) and of a prepass tile (8,192),
    on dirty logs of 5 workers."""
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), nw = _dirty_on(cuda_device, e, e, 5)
    k = stream_k.stream_scan(t, w, d, nw)
    _check_stream(k, ref.stream_ref(t.cpu(), w.cpu(), d.cpu(), nw))


def test_cuda_stream_one_worker_over_many_ring_stages(cuda_device):
    """One worker, 420,000 events: the chain walks 103 ring stages of
    4,096 events (each of the three ring slots reused 34 times) and the
    worker's CMetric is one chain of 210,000 slices."""
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), _ = _stream_inputs(1, 210_000, 9, cuda_device)
    assert t.shape[0] > 100 * 4096
    k = stream_k.stream_scan(t, w, d, 1)
    _check_stream(k, ref.stream_ref(t.cpu(), w.cpu(), d.cpu(), 1))


def test_cuda_stream_many_workers(cuda_device):
    """20,000 workers (the walk keeps no per-worker state: the pairing and
    the per-worker sums take any count), a few slices each."""
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), _ = _stream_inputs(20_000, 3, 7, cuda_device)
    k = stream_k.stream_scan(t, w, d, 20_000)
    _check_stream(k, ref.stream_ref(t.cpu(), w.cpu(), d.cpu(), 20_000))


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


# Each stage of the pipeline alone against its plain stage, on a dirty log
# of 50,000 events (7 tiles) and 7 workers, from the plain version of the
# stage before.
def _stage_log(dev):
    return _dirty_on(dev, 77, 50_000, 7)


def test_cuda_stream_prepass_stage_matches_plain(cuda_device):
    from repro_torch.kernels import stream_scan as stream_k
    (t, _, d), _ = _stage_log(cuda_device)
    for a, b in zip(stream_k.prepass_stage(t, d),
                    ref.stream_prepass_ref(t.cpu(), d.cpu())):
        _equal(a, b)


def test_cuda_stream_chain_stage_matches_plain(cuda_device):
    from repro_torch.kernels import stream_scan as stream_k
    (t, _, d), _ = _stage_log(cuda_device)
    share, idle, _, _ = ref.stream_prepass_ref(t.cpu(), d.cpu())
    k = stream_k.chain_stage(share.to(cuda_device), idle.to(cuda_device))
    for a, b in zip(k, ref.stream_chain_ref(share, idle)):
        _equal(a, b)


def test_cuda_stream_pair_stage_matches_plain(cuda_device):
    from repro_torch.kernels import stream_scan as stream_k
    (_, w, d), nw = _stage_log(cuda_device)
    k = stream_k.pair_stage(w, d, nw + 2)      # two workers without events
    for a, b in zip(k, ref.stream_pair_ref(w.cpu(), d.cpu(), nw + 2)):
        _equal(a, b)


def test_cuda_stream_rows_stage_matches_plain(cuda_device):
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), nw = _stage_log(cuda_device)
    tc, wc, dc = t.cpu(), w.cpu(), d.cpu()
    share, idle, out_idx, n_at_exit = ref.stream_prepass_ref(tc, dc)
    gcm, _, _ = ref.stream_chain_ref(share, idle)
    src, place, _ = ref.stream_pair_ref(wc, dc, nw)
    args = (tc, wc, gcm, out_idx, src, place, n_at_exit)
    rows_k, by_place_k = stream_k.rows_stage(
        *(x.to(cuda_device) for x in args))
    rows_p, by_place_p = ref.stream_rows_ref(*args)
    for a, b in zip((*rows_k, by_place_k), (*rows_p, by_place_p)):
        _equal(a, b)


def test_cuda_stream_cm_stage_matches_plain(cuda_device):
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), nw = _stage_log(cuda_device)
    tc, wc, dc = t.cpu(), w.cpu(), d.cpu()
    share, idle, out_idx, n_at_exit = ref.stream_prepass_ref(tc, dc)
    gcm, _, _ = ref.stream_chain_ref(share, idle)
    src, place, wrange = ref.stream_pair_ref(wc, dc, nw + 2)
    _, by_place = ref.stream_rows_ref(tc, wc, gcm, out_idx, src, place,
                                      n_at_exit)
    _equal(stream_k.cm_stage(by_place.to(cuda_device),
                             wrange.to(cuda_device)),
           ref.stream_cm_ref(by_place, wrange))


def test_cuda_stream_back_to_back(cuda_device):
    """Calls queued on one stream without a synchronise, on different logs
    and worker counts, each with its own outputs and state."""
    from repro_torch.kernels import stream_scan as stream_k
    inputs = [_stream_inputs(nw, 50, nw, cuda_device)[0]
              for nw in (2, 5, 17, 5, 2)]
    outs = [stream_k.stream_scan(t, w, d, nw)
            for (t, w, d), nw in zip(inputs, (2, 5, 17, 5, 2))]
    torch.cuda.synchronize()
    for (t, w, d), nw, k in zip(inputs, (2, 5, 17, 5, 2), outs):
        _check_stream(k, ref.stream_ref(t.cpu(), w.cpu(), d.cpu(), nw))


def test_cuda_stream_launch_replays_from_a_cuda_graph(cuda_device):
    """``launch`` (the kernel alone, into outputs ``stream_scan``
    allocated) captured in a CUDA graph gives the plain version's results
    on replay."""
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), _ = _stream_inputs(64, 300, 4, cuda_device)
    out = stream_k.stream_scan(t, w, d, 64)
    for x in (out[0], out[1], *out[3]):
        x.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):   # the eager call above was the warm-up
        stream_k.launch(t, w, d, 64, out)
    graph.replay()
    torch.cuda.synchronize()
    _check_stream(out, ref.stream_ref(t.cpu(), w.cpu(), d.cpu(), 64))


@pytest.mark.parametrize("bad_id", [-1, 5])
def test_cuda_stream_rejects_worker_ids_outside_the_range(cuda_device,
                                                          bad_id):
    """A worker id outside ``[0, num_workers)`` raises before the launch
    (the kernel would index its state with it)."""
    from repro_torch.kernels import stream_scan as stream_k
    (t, w, d), _ = _stream_inputs(5, 20, 1, cuda_device)
    w[7] = bad_id
    before = stream_k.LAUNCHES["stream"]
    with pytest.raises(ValueError, match="worker ids"):
        stream_k.stream_scan(t, w, d, 5)
    assert stream_k.LAUNCHES["stream"] == before


def test_cuda_stream_backend_matches_the_plain_backend(cuda_device):
    """``compute(backend="stream")`` on the card is one launch and gives
    the CPU result of the same backend, bit for bit."""
    from repro_torch.core import cmetric
    from repro_torch.core.events import synthetic_log
    from repro_torch.kernels import ops
    log = synthetic_log(np.random.default_rng(3), 12, 300).sanitize()
    ops.reset_launch_counts()
    a = cmetric.compute(log, backend="stream", device=cuda_device)
    assert ops.launch_counts()["stream"] == 1
    b = cmetric.compute(log, backend="stream", device="cpu")
    np.testing.assert_array_equal(a.per_worker, b.per_worker)
    for col in ("worker", "start_ns", "end_ns", "cm", "threads_av",
                "n_at_exit"):
        np.testing.assert_array_equal(getattr(a.table, col),
                                      getattr(b.table, col), err_msg=col)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_cuda_session_routes_the_histogram_to_the_card(cuda_device, backend):
    """An offline session on the card, under either name of the fused
    backend, folds on ``carry_cumsum`` and histograms on ``tag_hist``, and
    agrees with the float64 oracle (per-worker rtol 1e-4)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from repro_torch import convert
    from repro_torch.core import ProfileSession, detect_offline
    from repro_torch.kernels import ops
    log, tags, stacks, samples = convert.capture_from_numpy(
        *chip_smoke.make_capture(3, num_workers=64, rounds=64, group=4)[:5])
    oracle = detect_offline(log, tags, stacks, 8.0, samples=samples,
                            backend="numpy")
    ops.reset_launch_counts()
    sess = ProfileSession.offline(log, tags, stacks, n_min=8.0,
                                  samples=samples, backend=backend,
                                  chunk_events=999, device=cuda_device)
    rep = sess.result()
    counts = ops.launch_counts()
    assert counts["carry_cumsum"] >= 1 and counts["hist"] == 1, counts
    assert sess.device == cuda_device
    assert rep.total_slices == oracle.total_slices
    np.testing.assert_allclose(rep.per_worker, oracle.per_worker, rtol=1e-4,
                               atol=1e-6)
    assert rep.paths[0].stack == chip_smoke.INJECTED_PATH


def _attn_tensor(shape, gen, dev, dtype, offset, scale=1.0):
    """A contiguous normal tensor of ``shape``; ``offset`` 1 starts it one
    element into its storage (not 16-byte aligned)."""
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=gen, device=dev) * scale
    return flat.to(dtype)[offset:].view(shape)


def _attn_inputs(b, length, kv, h, hd, pos, dtype, dev, seed, offset=0):
    gen = torch.Generator(dev).manual_seed(seed)
    q = _attn_tensor((b, 1, h, hd), gen, dev, dtype, offset)
    k = _attn_tensor((b, length, kv, hd), gen, dev, dtype, offset, 2.0)
    v = _attn_tensor((b, length, kv, hd), gen, dev, dtype, offset)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=dev)


def _attn_oracle(q, k, v, pos, window, softcap):
    """The kernel's arithmetic in float64, eight slots at a time: q scaled
    in its dtype, the written rows' softmax, float64 weights against v."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    lo, hi, flat = attn_k.written_interval(pos, k.shape[1], window)
    rows = torch.arange(k.shape[1], device=q.device)
    outs = []
    for i in range(0, b, 8):
        sl = slice(i, i + 8)
        n = q[sl].shape[0]
        qs = (q[sl] * (hd ** -0.5)).double().reshape(n, kv, h // kv, hd)
        s = torch.einsum("bkgd,bskd->bkgs", qs, k[sl].double())
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(flat[sl, None, None, None], 0.0, s)
        keep = (rows >= lo[sl, None]) & (rows <= hi[sl, None])
        s = s.masked_fill(~keep[:, None, None, :], -np.inf)
        w = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgs,bskd->bkgd", w, v[sl].double())
                    .reshape(n, 1, h, hd))
    return torch.cat(outs)


def _check_attn(got, q, k, v, pos, window, softcap):
    want = _attn_oracle(q, k, v, pos, window, softcap)
    assert got.dtype == q.dtype and got.shape == q.shape and got.is_cuda
    rtol, atol = (2.0 ** -8, 1e-5) if q.dtype == torch.bfloat16 else \
        (1e-5, 1e-5)
    torch.testing.assert_close(got.double(), want, rtol=rtol, atol=atol)


def test_cuda_decode_attn_matches_plain_at_the_cells_shape(cuda_device):
    """The decode cells' attention: 96 slots, a 4,096-row cache, 32 MHA
    heads of 128, bfloat16, ragged pos over 0..4,095 (the first and last
    rows included), against the float64 oracle and the plain version."""
    rng = np.random.default_rng(28)
    pos = rng.integers(0, 4096, size=96)
    pos[:2] = (0, 4095)
    q, k, v, pos = _attn_inputs(96, 4096, 32, 32, 128, pos.tolist(),
                                torch.bfloat16, cuda_device, 28)
    before = attn_k.LAUNCHES["decode_attn"]
    got = attn_k.decode_attn(q, k, v, pos)
    assert attn_k.LAUNCHES["decode_attn"] == before + 2
    _check_attn(got, q, k, v, pos, None, 0.0)
    plain = attn_k.decode_attn_ref(q, k, v, pos)
    torch.testing.assert_close(
        got.float(), plain.float(), rtol=2.0 ** -7,
        atol=2.0 ** -9 * float(v.abs().max()))


#: (slots, cache rows, kv heads, heads, head dim, window, softcap, pos):
#: the tiny configs that the card runs (hd 16) and every family's widths
#: (seamless hd 64 MHA; qwen3 g 8, grok g 6 with its softcap, arctic g 7;
#: gemma3 and recurrentgemma hd 256, one kv head, local rings; MQA g 16).
ATTN_CASES = {
    "deepseek-tiny": (2, 8, 4, 4, 16, None, 0.0, [0, 5]),
    "qwen3-tiny": (3, 16, 2, 8, 16, None, 0.0, [15, 16, 40]),
    "gemma3-tiny-ring": (4, 8, 1, 4, 16, 8, 0.0, [3, 10, 14, 15]),
    "grok-tiny": (2, 8, 2, 4, 16, None, 30.0, [2, 7]),
    "seamless-64": (4, 300, 16, 16, 64, None, 0.0, [0, 77, 299, 1000]),
    "qwen3-128": (3, 1024, 8, 64, 128, None, 0.0, [1, 600, 1023]),
    "grok-128": (3, 512, 8, 48, 128, None, 30.0, [511, 100, 7]),
    "arctic-128": (2, 1000, 8, 56, 128, None, 0.0, [999, 333]),
    "gemma3-256-ring": (3, 512, 1, 4, 256, 512, 0.0, [100, 700, 1100]),
    "rgemma-256-ring": (2, 2048, 1, 10, 256, 2048, 0.0, [2047, 3000]),
    "mqa16-128": (4, 700, 1, 16, 128, None, 0.0, [0, 64, 65, 699]),
    "window-128": (4, 1024, 4, 8, 128, 100, 0.0, [50, 500, 1100, 1200]),
}


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_cuda_decode_attn_matches_the_oracle(cuda_device, case, dtype,
                                             offset):
    """``offset`` 1 hands over q, k and v one element into their storage
    (not 16-byte aligned); pos covers row 0, rings before and after they
    wrap, and intervals left empty (every row weighs alike)."""
    b, length, kv, h, hd, window, softcap, pos = ATTN_CASES[case]
    q, k, v, pos = _attn_inputs(b, length, kv, h, hd, pos, dtype,
                                cuda_device, len(case), offset)
    got = attn_k.decode_attn(q, k, v, pos, window=window, softcap=softcap)
    torch.cuda.synchronize()
    _check_attn(got, q, k, v, pos, window, softcap)


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-1b",
                                  "recurrentgemma-2b"])
def test_cuda_engine_step_launches_decode_attn_twice_a_layer(cuda_device,
                                                             arch):
    """Every attention layer of an ``Engine.step`` on the card goes
    through the kernel: two launches a layer with a K/V cache."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm
    from repro_torch.serve.engine import Engine, Request
    cfg = _tiny_f32(arch)
    p = init_lm(torch.Generator(cuda_device).manual_seed(0), cfg,
                device=cuda_device)
    engine = Engine(cfg, p, batch_slots=4, cache_len=16, device=cuda_device)
    for rid in range(4):
        engine.submit(Request(rid, np.arange(rid + 2), max_new=4))
    layers = sum("kv" in blk for group in engine.state
                 for blk in group.values())
    assert layers > 0
    for _ in range(3):
        ops.reset_launch_counts()
        engine.step()
        assert ops.launch_counts()["decode_attn"] == 2 * layers


def _tiny_f32(arch):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_tiny(arch),
                               compute_dtype=torch.float32)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-32b", "gemma3-1b",
                                  "grok-1-314b", "recurrentgemma-2b",
                                  "rwkv6-1.6b"])
def test_cuda_tiny_arch_matches_cpu(cuda_device, arch):
    """The model on the card against the same model on the CPU: tiny
    archs in float32, the same parameters (drawn on the CPU from a seed,
    then copied), forward over 8 tokens and 8 teacher-forced decode steps.
    rtol/atol 1e-4: the same float32 products without TF32, summed in
    another order."""
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_lm)
    from repro_torch.models.common import tree_map
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = _tiny_f32(arch)
    cpu_p = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    dev_p = tree_map(lambda x: x.to(cuda_device), cpu_p)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    outs = {}
    for dev, p in (("cpu", cpu_p), (cuda_device, dev_p)):
        tk = tokens.to(dev)
        full, _ = forward(p, {"tokens": tk}, cfg)
        state = init_decode_state(cfg, 2, 8, device=dev)
        steps = []
        for t in range(8):
            lg, state = decode_step(p, tk[:, t], torch.full(
                (2,), t, dtype=torch.int32, device=dev), state, cfg)
            steps.append(lg)
        outs[str(dev)] = (full.cpu(), torch.stack(steps, 1).cpu())
    for a, b in zip(outs[str(cuda_device)], outs["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_cuda_engine_tokens_match_cpu(cuda_device):
    """The ``Engine`` on the card gives the CPU engine's output tokens:
    tiny deepseek-7b in float32, the same parameters, 8 slots and a
    128-slot cache over the serve_engine example's 16 requests (slot
    reuse, and the long requests wrap the ring)."""
    from repro_torch.examples.serve_engine import make_requests
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import Engine
    cfg = _tiny_f32("deepseek-7b")
    cpu_p = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    outs = {}
    for dev, p in (("cpu", cpu_p),
                   (cuda_device, tree_map(lambda x: x.to(cuda_device),
                                          cpu_p))):
        engine = Engine(cfg, p, batch_slots=8, cache_len=128, device=dev)
        done = engine.run(make_requests(cfg.vocab_size))
        outs[str(dev)] = {r.rid: list(r.out) for r in done}
    assert len(outs["cpu"]) == 16
    assert outs[str(cuda_device)] == outs["cpu"]


def test_cuda_cache_update_in_place_matches_functional(cuda_device):
    """``decode_attention`` writes the new K/V into the cache tensors it
    was given, on the card, with the values of a write into a copy (the
    reference's functional update), past the end of the ring too."""
    from repro_torch.models import attention as attn
    from repro_torch.models import init_lm
    cfg = _tiny_f32("gemma3-1b")
    p = init_lm(torch.Generator(cuda_device).manual_seed(0), cfg,
                device=cuda_device)["groups"][0]["b0"]["attn"]
    gen = torch.Generator(cuda_device).manual_seed(1)
    cache = attn.init_kv_cache(cfg, 8, 8, device=cuda_device)
    rows = torch.arange(8, device=cuda_device)
    for step in range(11):
        x = torch.randn((8, 1, cfg.d_model), generator=gen,
                        device=cuda_device)
        pos = (torch.arange(8, device=cuda_device, dtype=torch.int32)
               + step)
        k_new, v_new = attn._project_kv(p, x, cfg, pos[:, None])
        want = {n: t.clone() for n, t in cache.items()}
        want["k"][rows, (pos % 8).long()] = k_new[:, 0]
        want["v"][rows, (pos % 8).long()] = v_new[:, 0]
        ptr = cache["k"].data_ptr()
        _, out = attn.decode_attention(p, x, pos, cache, cfg,
                                       window=cfg.window)
        torch.cuda.synchronize()
        assert out is cache and out["k"].data_ptr() == ptr
        assert torch.equal(out["k"], want["k"])
        assert torch.equal(out["v"], want["v"])


@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b",
                                  "recurrentgemma-2b", "rwkv6-1.6b"])
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    """Three float32 train steps (backward with remat, AdamW) on the card
    against the CPU from the same parameters: losses and the parameters
    and moments after the third step at rtol/atol 1e-4 (AdamW's eps 1e-3,
    as in tests/test_torch_train.py: with eps 1e-8 a parameter whose
    gradient is ~1e-8 moves either way on its gradient's rounding)."""
    import chip_smoke
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_items
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = _tiny_f32(arch)
    cpu_p = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    l_cpu, t_cpu = chip_smoke.train_steps_tiny(cfg, cpu_p, "cpu")
    l_dev, t_dev = chip_smoke.train_steps_tiny(cfg, cpu_p, cuda_device)
    np.testing.assert_allclose(l_dev, l_cpu, rtol=1e-4)
    for (path, a), (_, b) in zip(tree_items(t_dev), tree_items(t_cpu)):
        assert a.dtype == b.dtype, path
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("s", [1, 7, 33])
def test_cuda_recurrent_scans_match_cpu(cuda_device, s):
    """The associative scan on the card against the same scan on the CPU,
    both combines (the RG-LRU's pair, RWKV's broadcast pair), lengths that
    are and are not powers of two; rtol 1e-5 (float32 products and sums in
    the same tree order, fused differently)."""
    from repro_torch.models import recurrent as rec
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.3, 1.0, (2, s, 3, 64)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, s, 3, 64)).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal((2, s, 3, 64, 64)).astype(
        np.float32))

    def combine(left, right):
        a1, u1 = left
        a2, u2 = right
        return a1 * a2, a2[..., None] * u1 + u2
    for dev in ("cpu", cuda_device):
        got = (rec._rglru_scan(a.to(dev), b.to(dev))
               + rec.associative_scan(combine, (a.to(dev), u.to(dev))))
        if dev == "cpu":
            want = got
    for x, y in zip(got, want):
        assert x.is_cuda
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_cuda_checkpoint_round_trip(cuda_device, tmp_path):
    """An asynchronous save of a tree on the card, written over right
    after ``save`` returns (as the next step would), restores onto the
    card bit for bit with the values of the call."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim import adamw
    cfg = _tiny_f32("deepseek-7b")
    p = init_lm(torch.Generator(cuda_device).manual_seed(0), cfg,
                device=cuda_device)
    tree = {"params": p, "opt": adamw.init(p)}
    want = tree_map(lambda x: x.cpu(), tree)
    t = checkpoint.save(str(tmp_path), 4, tree, blocking=False)
    for _, x in tree_items(tree):
        x.add_(1)
    t.join(timeout=60)
    assert not t.is_alive() and checkpoint.latest_step(str(tmp_path)) == 4
    out = checkpoint.restore(str(tmp_path), 4, tree, device=cuda_device)
    for (path, a), (_, b) in zip(tree_items(out), tree_items(want)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, path
        assert torch.equal(a.cpu(), b), path


def _multirank_on_card(inputs: dict) -> dict:
    """A rank of :func:`test_cuda_multirank_matches_cpu`: flash-decode and
    gpipe (as many stages as ranks) with the ranks' tensors on the card,
    and on the CPU too where the backend carries CPU tensors (gloo)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import ModelConfig
    from repro_torch.pipeline import gpipe
    from repro_torch.serve.decode_sharded import make_flash_decode
    w = dist.get_world_size()
    out = {}
    devs = ("cuda", "cpu") if dist.get_backend() == "gloo" else ("cuda",)
    for dev in devs:
        x = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        f = make_flash_decode(make_mesh((w,), ("model",), device=dev),
                              ModelConfig(num_heads=8, num_kv_heads=2,
                                          head_dim=16))
        fd = f(x["q"], x["k"], x["v"], x["valid"]).to_local()
        g = gpipe(lambda p, a: torch.tanh(a @ p["w"]),
                  make_mesh((w,), ("stage",), device=dev), n_stages=w,
                  n_micro=6)({"w": x["w"][:w]}, x["x"]).to_local()
        out[dev] = (fd.cpu().numpy(), g.cpu().numpy())
    return out


@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")])
def test_cuda_multirank_matches_cpu(cuda_device, world, backend):
    """flash-decode and gpipe on the card: over NCCL at one rank, over
    gloo at two ranks sharing the card (gpipe's host-staged shift), each
    against the CPU at rtol/atol 1e-4 (float32 products without TF32)."""
    from repro_torch.launch.mesh import run_ranks
    rng = np.random.default_rng(0)
    inputs = {
        "q": rng.standard_normal((3, 1, 8, 16)).astype(np.float32),
        "k": rng.standard_normal((3, 64, 2, 16)).astype(np.float32),
        "v": rng.standard_normal((3, 64, 2, 16)).astype(np.float32),
        "valid": np.arange(64)[None, :] <= np.asarray([10, 40, 63])[:, None],
        "w": (rng.standard_normal((2, 16, 16)) * 0.5).astype(np.float32),
        "x": rng.standard_normal((6, 8, 16)).astype(np.float32)}
    ranks = run_ranks(_multirank_on_card, world, backend=backend,
                      args=(inputs,), timeout=300)
    x = torch.from_numpy(inputs["x"])
    for s in range(world):
        x = torch.tanh(x @ torch.from_numpy(inputs["w"][s]))
    for r in ranks:
        fd, g = r["cuda"]
        np.testing.assert_allclose(g, x.numpy(), rtol=1e-4, atol=1e-4)
        if "cpu" in r:
            np.testing.assert_allclose(fd, r["cpu"][0], rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(g, r["cpu"][1], rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_array_equal(fd, ranks[0]["cuda"][0])
