"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; the same numpy
inputs (seeded) go through ``repro.kernels.ops`` in interpret mode, as the
JAX package's own tests run it.  Tolerances are the reference's own:
``n`` and counts exact, the f32 gcm prefix rtol 1e-5 / atol 1e-7
(tests/test_kernels.py), the chunk prefix rtol 1e-4 and the weighted
histogram rtol 1e-4 (sums in another order).

The decode attention kernel replaces no Pallas kernel: its plain version
is held against the port's masked attention over the whole cache
(``models/attention.py::_sdpa_math``), float32 rtol/atol 1e-5 (the same
float32 arithmetic, summed in another order) and bfloat16 2^-7 (as
float32, plus a normalised weight or an output on either side of a
bfloat16 rounding: one unit in the last place).

``tests/test_torch_cuda.py`` holds the CUDA kernels themselves against
these plain versions, on the card.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import cmetric_fold as fold_k
from repro_torch.kernels import decode_attn as attn_k
from repro_torch.kernels import tag_hist as hist_k
from repro_torch.models import attention as attn_lib
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


#: Decode attention cases: (heads, kv heads) of MHA, GQA and MQA, and
#: (cache rows, window, positions): a full cache at pos 0, mid-cache, its
#: last row and past its end; a ring of one window before and after it
#: wraps (pos 15 and 40 leave the interval empty: every row weighs alike);
#: a window shorter than the cache.
ATTN_HEADS = {"mha": (4, 4), "gqa": (8, 2), "mqa": (8, 1)}
ATTN_CACHES = {"full": (24, None, [0, 11, 23, 24, 61]),
               "ring": (8, 8, [0, 5, 7, 10, 14, 15, 40]),
               "window": (24, 8, [3, 12, 30, 40])}


def _attn_inputs(heads, kv, hd, length, pos, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b = len(pos)
    q = torch.randn((b, 1, heads, hd), generator=gen).to(dtype)
    k = (2.0 * torch.randn((b, length, kv, hd), generator=gen)).to(dtype)
    v = torch.randn((b, length, kv, hd), generator=gen).to(dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32)


def _masked_sdpa(q, k, v, pos, window, softcap):
    """``decode_attention``'s attention before the kernel: the validity
    mask of the whole cache through ``_sdpa_math``."""
    slots = torch.arange(k.shape[1])[None, :]
    written = slots <= pos[:, None]
    if window is not None:
        written &= slots > pos[:, None] - window
    cfg = types.SimpleNamespace(opt_level=0, logits_softcap=softcap)
    return attn_lib._sdpa_math(q, k, v, written[:, None, None, None, :], cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache", sorted(ATTN_CACHES))
@pytest.mark.parametrize("softcap", [0.0, 2.0])
@pytest.mark.parametrize("hd", attn_k.HEAD_DIMS)
@pytest.mark.parametrize("heads", sorted(ATTN_HEADS))
def test_decode_attn_plain_matches_the_masked_whole_cache(heads, hd, softcap,
                                                          cache, dtype):
    h, kv = ATTN_HEADS[heads]
    length, window, pos = ATTN_CACHES[cache]
    q, k, v, pos = _attn_inputs(h, kv, hd, length, pos, dtype)
    got = ops.decode_attention(q, k, v, pos, window=window, softcap=softcap)
    want = _masked_sdpa(q, k, v, pos, window, softcap)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,want", [
    # the decode cells: 96 slots, 4,096 rows, 32 MHA heads, hd 128, bf16
    ((96, 4096, 32, 32, 128, 2), attn_k.Plan(1, 1, 256, 16)),
    # tiny gemma3: MQA, g 4, one ring of 8 rows: one split
    ((2, 8, 1, 4, 16, 2), attn_k.Plan(4, 1, 8, 1)),
    # a long cache of one slot and one kv head: splits shrink to the least
    ((1, 32768, 1, 8, 128, 2), attn_k.Plan(8, 1, 64, 512)),
    # recurrentgemma-2b: g 10 in two chunks of 8 (5 live); grok: g 6
    ((4, 2048, 1, 10, 256, 2), attn_k.Plan(8, 2, 64, 32)),
    ((8, 1024, 8, 48, 128, 4), attn_k.Plan(8, 1, 64, 16)),
    # GQA g 2 and g 3; MQA g 16
    ((16, 4096, 8, 16, 128, 2), attn_k.Plan(2, 1, 256, 16)),
    ((16, 4096, 8, 24, 64, 2), attn_k.Plan(4, 1, 512, 8)),
    ((16, 4096, 1, 16, 64, 2), attn_k.Plan(8, 2, 128, 32)),
])
def test_decode_attn_plan_follows_the_shapes(shape, want):
    """The split and head chunk come from the shapes alone; at the decode
    cells' shape even the shortest slots (256 written rows: one split a
    head) keep more than 4 blocks an SM of 132 live."""
    b, length, kv, h, hd, itemsize = shape
    got = attn_k.plan(b, length, kv, h, hd, itemsize, sms=132)
    assert got == want
    assert got.chunk * got.nchunk >= h // kv > (got.chunk // 2) * got.nchunk
    assert got.split * got.nsplit >= length > got.split * (got.nsplit - 1)
    if shape[0] == 96:
        assert b * kv * got.nchunk >= 4 * 132


@pytest.mark.parametrize("call", ["fold-dtype", "fold-2d", "fold-strided",
                                  "fold-shape", "fold-empty", "fold-meta",
                                  "cumsum-dtype", "hist-dtype", "hist-bins",
                                  "hist-weights", "hist-weight-dtype",
                                  "attn-dtype", "attn-mixed-dtype",
                                  "attn-head-dim", "attn-two-tokens",
                                  "attn-heads", "attn-pos-dtype",
                                  "attn-strided", "attn-window",
                                  "attn-meta"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    f = torch.zeros(8, dtype=torch.float32)
    i = torch.zeros(8, dtype=torch.int32)
    q, k, v, pos = _attn_inputs(4, 2, 16, 8, [1, 2], torch.bfloat16)

    def attn(q=q, k=k, v=v, pos=pos, window=None):
        return attn_k.decode_attn(q, k, v, pos, window=window)
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
        "attn-dtype": lambda: attn(q.half(), k.half(), v.half()),
        "attn-mixed-dtype": lambda: attn(q=q.float()),
        "attn-head-dim": lambda: attn(q[..., :8].contiguous(),
                                      k[..., :8].contiguous(),
                                      v[..., :8].contiguous()),
        "attn-two-tokens": lambda: attn(q=q.expand(2, 2, 4, 16).contiguous()),
        "attn-heads": lambda: attn(q=q[:, :, :3].contiguous()),
        "attn-pos-dtype": lambda: attn(pos=pos.long()),
        "attn-strided": lambda: attn(k=k.transpose(1, 2)),
        "attn-window": lambda: attn(window=0),
        "attn-meta": lambda: attn(q.to("meta"), k.to("meta"), v.to("meta"),
                                  pos.to("meta")),
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
    ops.decode_attention(*_attn_inputs(4, 2, 16, 8, [1, 9], torch.bfloat16),
                         window=4)
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


def test_decode_attn_kernels_are_not_named_as_weight_products():
    """The decode attention kernels carry none of the names by which the
    benchmark's gemm shares find cuBLAS's weight products
    (``gappbench/metrics/_products.py``): attention is not a weight
    product, and counted as one it would lower those shares."""
    import re
    text = (build.CSRC / build.SOURCES["decode_attn"]).read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(",
                         text)
    assert kernels == ["decode_attn_split", "decode_attn_combine"]
    for name in kernels + ["gapp_decode_attn"]:
        assert not any(p in name.lower() for p in
                       ("nvjet", "gemm", "gemv", "xmma", "cutlass")), name


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
