"""The CUDA kernels against their plain PyTorch versions, on the card.

Ragged shapes (a partial last tile, one event, empty input), a carry, bins
on both sides of the shared-memory limit, and inputs that are not 16-byte
aligned.  Tolerances: ``n`` and counts exact; float prefixes rtol 1e-5
(both are float32 scans, summed in another order); weighted histogram
rtol 1e-4 (float atomics in a varying order).  Each test needs a CUDA card
and skips without one; run them there with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import cmetric_fold as fold_k
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


@pytest.mark.parametrize("e", [1, 7, 2047, 2048, 2049, 100_003])
def test_cuda_fold_matches_plain(cuda_device, e):
    t, deltas = _stream(e, e + 11)
    dt = torch.from_numpy(np.concatenate([np.diff(t), [0.0]]).astype(
        np.float32)).to(cuda_device)
    d = torch.from_numpy(deltas).to(cuda_device)
    carry = (3.0, 0.5, 0.25)
    before = fold_k.LAUNCHES["fold"]
    k = fold_k.fold(dt, d, carry)
    p = ref.fold_ref(dt, d, carry)
    torch.cuda.synchronize()
    assert fold_k.LAUNCHES["fold"] == before + 1
    assert torch.equal(k[0], p[0])
    np.testing.assert_allclose(k[1].cpu().numpy(), p[1].cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(k[2:], p[2:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("e", [1, 2049, 100_003])
def test_cuda_carry_cumsum_matches_plain(cuda_device, e, offset):
    """``offset`` 1 hands over views that are not 16-byte aligned."""
    rng = np.random.default_rng(e)
    c = torch.from_numpy(rng.random(e + 1).astype(np.float32)).to(
        cuda_device)[offset:offset + e]
    i = torch.from_numpy(rng.random(e + 1).astype(np.float32)).to(
        cuda_device)[offset:offset + e]
    gk, ek, ik = fold_k.carry_cumsum(c, i, (0.25, 0.5))
    gp, ep, ip = ref.carry_cumsum_ref(c, i, (0.25, 0.5))
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(ek), float(ep), rtol=1e-5)
    np.testing.assert_allclose(float(ik), float(ip), rtol=1e-5)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("s,k", [(0, 3), (1, 1), (1000, 100),
                                 (300_001, 6144), (300_001, 6145),
                                 (100_000, 1 << 20)])
def test_cuda_hist_matches_plain(cuda_device, s, k, weighted):
    rng = np.random.default_rng(s + k)
    tags = torch.from_numpy(rng.integers(-3, k + 3, s).astype(np.int32)).to(
        cuda_device)
    w = (torch.from_numpy(rng.random(s, dtype=np.float32)).to(cuda_device)
         if weighted else None)
    ck, wk = hist_k.hist(tags, w, num_bins=k)
    cp, wp = ref.hist_ref(tags, w, k)
    assert torch.equal(ck, cp)
    np.testing.assert_allclose(wk.cpu().numpy(), wp.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)


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
