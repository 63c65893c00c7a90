"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; the same numpy
inputs (seeded) go through ``repro.kernels.ops`` in interpret mode, as the
JAX package's own tests run it.  Tolerances are the reference's own:
``n`` and counts exact, the f32 gcm prefix rtol 1e-5 / atol 1e-7
(tests/test_kernels.py), the chunk prefix rtol 1e-4 and the weighted
histogram rtol 1e-4 (sums in another order).

``tests/test_torch_cuda.py`` holds the CUDA kernels themselves against
these plain versions, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import cmetric_fold as fold_k
from repro_torch.kernels import tag_hist as hist_k
from tests.test_torch_cuda import _stream


@pytest.mark.parametrize("e", [1, 7, 255, 1000, 5000])
def test_fold_matches_pallas_reference(e):
    t, deltas = _stream(e, e)
    n_j, g_j, tot_j, idle_j, cnt_j = jops.cmetric_fold(jnp.asarray(t),
                                                       jnp.asarray(deltas))
    n_t, g_t, tot_t, idle_t, cnt_t = ops.cmetric_fold(torch.from_numpy(t),
                                                      torch.from_numpy(deltas))
    assert n_t.dtype == torch.int32 and g_t.dtype == torch.float32
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
    np.testing.assert_allclose(float(idle_t), float(idle_j), rtol=1e-5,
                               atol=1e-7)
    assert float(cnt_t) == float(cnt_j) == float(deltas.sum())


def test_fold_carry_resume_matches_reference():
    """Two calls stitched by the returned (count, gcm, idle) triple equal
    one whole call, and equal the Pallas kernel's own resume."""
    e, cut = 1500, 700
    t, deltas = _stream(e, 2)
    dt = np.concatenate([np.diff(t), [0.0]]).astype(np.float32)
    d, dd = torch.from_numpy(dt), torch.from_numpy(deltas)
    n_a, g_a, tot_a, idle_a, cnt_a = fold_k.fold(d, dd)
    n1, g1, tot1, idle1, cnt1 = fold_k.fold(d[:cut], dd[:cut])
    n2, g2, tot2, idle2, cnt2 = fold_k.fold(d[cut:], dd[cut:],
                                            (cnt1, tot1, idle1))
    np.testing.assert_array_equal(n_a.numpy(), torch.cat([n1, n2]).numpy())
    np.testing.assert_allclose(g_a.numpy(), torch.cat([g1, g2]).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tot_a), float(tot2), rtol=1e-5)
    np.testing.assert_allclose(float(idle_a), float(idle2), rtol=1e-5,
                               atol=1e-7)
    assert float(cnt_a) == float(cnt2)
    fk = jops._fold
    j1 = fk.fold(jnp.asarray(dt[:cut]), jnp.asarray(deltas[:cut]), block=256)
    j2 = fk.fold(jnp.asarray(dt[cut:]), jnp.asarray(deltas[cut:]),
                 (j1[4], j1[2], j1[3]), block=256)
    np.testing.assert_array_equal(n2.numpy(), np.asarray(j2[0]))
    np.testing.assert_allclose(g2.numpy(), np.asarray(j2[1]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("e", [1, 100, 2048, 5000])
def test_fold_chunk_prefix_nonzero_carry(e):
    rng = np.random.default_rng(3 + e)
    c = rng.random(e)
    i = rng.random(e)
    g_t, i_t = ops.fold_chunk_prefix(0.25, 0.5, c, i, device="cpu")
    g_j, i_j = jops.fold_chunk_prefix(0.25, 0.5, c, i, block=256)
    assert g_t.dtype == np.float64 and isinstance(i_t, float)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4)
    np.testing.assert_allclose(i_t, i_j, rtol=1e-4)
    np.testing.assert_allclose(g_t, 0.25 + np.cumsum(c), rtol=1e-4)


@pytest.mark.parametrize("s,k", [(1, 4), (100, 17), (1024, 128),
                                 (5000, 1000), (333, 64)])
def test_hist_matches_pallas_reference(s, k):
    rng = np.random.default_rng(s * k)
    tags = rng.integers(-2, k, size=s).astype(np.int32)
    w = rng.random(s).astype(np.float32)
    c_j, w_j = jops.tag_histogram(jnp.asarray(tags), jnp.asarray(w),
                                  num_bins=k, block=256)
    c_t, w_t = ops.tag_histogram(torch.from_numpy(tags), torch.from_numpy(w),
                                 num_bins=k)
    assert c_t.dtype == torch.int32 and w_t.dtype == torch.float32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4,
                               atol=1e-4)


def test_hist_drops_out_of_range_tags_like_the_tpu_kernel():
    """Tags >= num_bins and negative tags are dropped, as the Pallas kernel
    drops them; the JAX oracle ``ref.hist_ref`` clips them into the last
    bin instead, which this pins as a divergence inside the reference."""
    k = 5
    tags = np.asarray([0, 4, 5, 9, -1, -7, 2, 4, 100], np.int32)
    w = np.arange(1, tags.size + 1, dtype=np.float32)
    c_t, w_t = ops.tag_histogram(torch.from_numpy(tags), torch.from_numpy(w),
                                 num_bins=k)
    c_j, w_j = jops.tag_histogram(jnp.asarray(tags), jnp.asarray(w),
                                  num_bins=k)
    np.testing.assert_array_equal(c_t.numpy(), [1, 0, 1, 0, 2])
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(w_t.numpy(), [1, 0, 7, 0, 10])
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j))
    clipped = np.asarray(jref.hist_ref(jnp.asarray(tags), k))
    assert clipped[-1] == 5 and c_t.numpy()[-1] == 2


def test_hist_default_weights():
    tags = torch.tensor([0, 1, 1, 2, -1, 2, 2], dtype=torch.int32)
    c, w = hist_k.hist(tags, num_bins=3)
    np.testing.assert_array_equal(c.numpy(), [1, 2, 3])
    np.testing.assert_allclose(w.numpy(), [1, 2, 3])


@pytest.mark.parametrize("call", ["fold-dtype", "fold-2d", "fold-strided",
                                  "fold-shape", "fold-empty", "fold-meta",
                                  "cumsum-dtype", "hist-dtype", "hist-bins",
                                  "hist-weights", "hist-weight-dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    f = torch.zeros(8, dtype=torch.float32)
    i = torch.zeros(8, dtype=torch.int32)
    bad = {
        "fold-dtype": lambda: fold_k.fold(f, f),
        "fold-2d": lambda: fold_k.fold(f.reshape(2, 4), i.reshape(2, 4)),
        "fold-strided": lambda: fold_k.fold(torch.zeros(16)[::2], i),
        "fold-shape": lambda: fold_k.fold(f, i[:4]),
        "fold-empty": lambda: fold_k.fold(f[:0], i[:0]),
        "fold-meta": lambda: fold_k.fold(f.to("meta"), i.to("meta")),
        "cumsum-dtype": lambda: fold_k.carry_cumsum(f.double(), f, (0, 0)),
        "hist-dtype": lambda: hist_k.hist(i.long(), num_bins=3),
        "hist-bins": lambda: hist_k.hist(i, num_bins=0),
        "hist-weights": lambda: hist_k.hist(i, f[:4], num_bins=3),
        "hist-weight-dtype": lambda: hist_k.hist(i, i, num_bins=3),
    }[call]
    with pytest.raises((TypeError, ValueError)):
        bad()


def test_cpu_calls_neither_build_nor_count_launches(monkeypatch):
    def no_build(name):
        raise AssertionError(f"CPU call tried to build {name}")
    monkeypatch.setattr(build, "load", no_build)
    before = ops.launch_counts()
    t, deltas = _stream(300, 5)
    ops.cmetric_fold(torch.from_numpy(t), torch.from_numpy(deltas))
    ops.fold_chunk_prefix(0.0, 0.0, np.ones(10), np.zeros(10), device="cpu")
    ops.tag_histogram(torch.zeros(4, dtype=torch.int32), num_bins=2)
    ops.stream_scan(torch.from_numpy(t), torch.zeros(300, dtype=torch.int32),
                    torch.from_numpy(deltas), 1)
    assert ops.launch_counts() == before


def test_build_targets_sm90a_and_keys_libraries_by_source(tmp_path,
                                                          monkeypatch):
    cmd = build.nvcc_command("cmetric_fold", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1].endswith("cmetric_fold.cu")
    for name in build.SOURCES:
        assert (build.CSRC / build.SOURCES[name]).is_file()
    before = build.library_path("tag_hist")
    src = tmp_path / "csrc"
    src.mkdir()
    for f in build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", src)
    assert build.library_path("tag_hist") == before
    (src / "tag_hist.cu").write_text("// edited\n")
    edited = build.library_path("tag_hist")
    assert edited != before and edited.parent == build.BUILD_DIR
    # a shared header is part of every library's key
    fold_before = build.library_path("cmetric_fold")
    (src / "common.cuh").write_text("// edited header\n")
    assert build.library_path("cmetric_fold") != fold_before
    assert build.library_path("tag_hist") != edited


def test_kernel_sources_match_the_build_tables():
    """Every header a source includes is one ``library_path`` hashes, and
    every C function a source exports has its signature declared."""
    import re
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    for name, source in build.SOURCES.items():
        text = (build.CSRC / source).read_text()
        local = set(re.findall(r'#include "([^"]+)"', text))
        assert local <= headers, (source, local - headers)
        exported = set(re.findall(r"^int (gapp_\w+)\(", text, re.M))
        assert exported == set(build.SIGNATURES[name]), source
