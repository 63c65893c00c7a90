"""The sharded loss runs vocab-parallel and the sharded decode attention
combines the cache's slices as flash-decode does, on the CPU.

The reference constrains the logits to ``("batch", "seq", "vocab")`` and
leaves ``logsumexp`` and ``take_along_axis`` to GSPMD, which keeps each
rank on its vocab span and all-reduces (B, S) values; its decode
attention runs over a cache whose sequence is sharded over ``model``,
and XLA splits the softmax's reductions into flash-decode's two-pass
combine.  The same tiny cells as ``test_torch_dryrun_pod.py`` (one
pattern group, 8 sequences of 16 tokens) are traced on a fake world of
eight ranks, (2, 4) ``("data", "model")``: no all-gather's result holds
a rank's logit rows whole in vocab, and inside decode attention the only
collectives are the gather of q's heads and the combine's three
all-reduces a layer.  Plain checks with no ranks hold the pieces: the
loss's vocab spans over uneven splits against ``lm_loss``'s terms on the
whole logits, value and gradient, and the combine over cache slices
(threads standing in for the ranks) against ``_sdpa`` on the whole
cache.
"""
import concurrent.futures
import dataclasses
import sys
import threading

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import cost as tcost
from repro_torch.models import attention, transformer
from repro_torch.serve import decode_sharded
from test_torch_dryrun_pod import trace_world

WORLD = ((2, 4), ("data", "model"))
BATCH, SEQ = 8, 16                      # trace_world's tiny shape
ROWS = BATCH // 2                       # a rank's rows: the batch on data
MODEL = 4


def _under_sdpa() -> bool:
    """True if attention's ``_sdpa`` is on the calling stack."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "_sdpa" and \
                f.f_code.co_filename.endswith("attention.py"):
            return True
        f = f.f_back
    return False


def _trace(arch: str, kind: str, monkeypatch) -> dict:
    """``trace_world``'s cell on ``WORLD``, with each counted collective
    as ``(op, bytes, group, numel, dtype, ndim, under _sdpa)`` (of its
    result) and, for decode, the calls of ``_sdpa_cache_slice``."""
    seen = {"collectives": [], "slices": 0}
    count = tcost.CostMode._count

    def counted(self, func, args, kwargs, out):
        n = len(self.trace.collectives)
        count(self, func, args, kwargs, out)
        if len(self.trace.collectives) > n:
            op, nbytes, group = self.trace.collectives[-1]
            t = tcost._tensors(out)[0]
            seen["collectives"].append((op, nbytes, group, t.numel(),
                                        t.dtype, t.dim(), _under_sdpa()))

    monkeypatch.setattr(tcost.CostMode, "_count", counted)
    if kind == "decode":
        block = attention._sdpa_cache_slice

        def sliced(*args, **kwargs):
            seen["slices"] += 1
            return block(*args, **kwargs)
        monkeypatch.setattr(attention, "_sdpa_cache_slice", sliced)
    trace_world(arch, kind, WORLD, pytest.MonkeyPatch())
    return seen


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-1b"])
def test_the_loss_gathers_no_logit_rows_whole_in_vocab(arch, monkeypatch):
    cfg = tconfigs.get_tiny(arch)
    got = _trace(arch, "train", monkeypatch)
    # float32 (B, S, V) logits; an all-gather stacks its pieces on the
    # first dimension (the embedding table, (V, D), is gathered whole)
    rows = ROWS * SEQ * cfg.vocab_size
    gathers = [c for c in got["collectives"] if c[0] == "all-gather"]
    assert gathers
    whole = [c for c in gathers
             if c[4] == torch.float32 and c[5] == 3 and c[3] >= rows]
    assert not whole, whole


@pytest.mark.parametrize("arch",
                         ["deepseek-7b", "recurrentgemma-2b", "gemma3-1b"])
def test_decode_attention_gathers_q_alone_and_combines_by_all_reduces(
        arch, monkeypatch):
    cfg = tconfigs.get_tiny(arch)
    got = _trace(arch, "decode", monkeypatch)
    assert got["slices"] > 0
    inside = [c[:5] for c in got["collectives"] if c[6]]
    # q (B, 1, H, hd) gathered whole in heads where the rules shard them
    q = ROWS * cfg.num_heads * cfg.hd
    gathers = [c for c in inside if c[0] != "all-reduce"]
    assert all(c[0] == "all-gather" and c[3] == q
               and c[4] == cfg.compute_dtype for c in gathers), gathers
    # each layer: the max and the sum of exps of every (row, head), then
    # the weighted values, over the model axis
    rows = ROWS * cfg.num_heads
    combine = [("all-reduce", 4 * rows, MODEL, rows, torch.float32)] * 2 \
        + [("all-reduce", 4 * q, MODEL, q, torch.float32)]
    reduces = [c for c in inside if c[0] == "all-reduce"]
    assert reduces == combine * got["slices"]


# -- the pieces, with no ranks ---------------------------------------------

@pytest.mark.parametrize("sizes", [(37,), (20, 17), (5, 20, 12),
                                   (10, 9, 9, 9)],
                         ids=["1", "2", "3", "4"])
def test_vocab_spans_give_the_loss_and_its_gradient(sizes):
    """``transformer``'s span functions, each on its own vocab span and
    combined as the ranks' all-reduces combine them, give ``lm_loss``'s
    ``logsumexp`` and target logits on the whole logits, and the same
    gradient; targets at every span's edges and -1 (padding) included."""
    gen = torch.Generator().manual_seed(0)
    b, s, v = 3, 6, sum(sizes)
    x = torch.randn(b, s, v, generator=gen) * 4
    edges = torch.cumsum(torch.tensor((0,) + sizes), 0)
    targets = torch.cat([edges[:-1], edges[1:] - 1, torch.tensor([-1])])
    targets = targets[torch.randint(0, len(targets), (b, s),
                                    generator=gen)]
    mask = targets >= 0
    weights = torch.randn(b, s, generator=gen)

    def loss(logz, tgt):
        return torch.sum((logz - tgt) * mask * weights)

    whole = x.clone().requires_grad_()
    want = loss(torch.logsumexp(whole, dim=-1),
                transformer._target_logits(whole, targets))
    want.backward()
    split = x.clone().requires_grad_()
    spans = torch.split(split, sizes, dim=-1)
    offsets = [((0, 0, int(e)), None) for e in edges[:-1]]
    top = torch.stack([transformer._span_max(t) for t in spans]).amax(0)
    sum_exp = sum(transformer._span_sum_exp(t, top) for t in spans)
    tgt = sum(transformer._span_target(t, targets, offsets=o)
              for t, o in zip(spans, offsets))
    got = loss(torch.log(sum_exp) + top, tgt)
    got.backward()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(split.grad, whole.grad, rtol=1e-6,
                               atol=1e-6 * float(whole.grad.abs().max()))


class _Exchange:
    """Stands in for a process group of ``n`` threads, one a cache slice:
    each all-reduce waits for every slice's tensor and reduces them in
    slice order."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=30)
        self.parts = [None] * n

    def all_reduce(self, rank: int, t, op: str):
        self.parts[rank] = t
        self.barrier.wait()
        stack = torch.stack(self.parts)
        out = stack.amax(0) if op == "max" else stack.sum(0)
        self.barrier.wait()
        return out


def _over_slices(fn, n: int, monkeypatch) -> list:
    """``fn(rank, group)`` on ``n`` threads whose all-reduces meet in an
    :class:`_Exchange`; each thread's result."""
    ex = _Exchange(n)
    monkeypatch.setattr(attention, "_all_reduce",
                        lambda t, op, group: ex.all_reduce(group, t, op))
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        return list(pool.map(lambda r: fn(r, r), range(n)))


@pytest.mark.parametrize("arch,softcap", [("deepseek-7b", 0.0),
                                          ("gemma3-1b", 5.0)])
@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("n", [2, 3])
def test_the_combine_over_cache_slices_gives_sdpa_on_the_whole_cache(
        arch, softcap, opt_level, n, monkeypatch):
    """``_sdpa_cache_slice`` on each of ``n`` slices of a 12-slot cache,
    combined, gives ``_sdpa`` on the whole cache: grouped and repeated
    layouts, the softcap on, and rows whose positions leave whole slices
    unwritten (row 0 sees slots 0-2 only)."""
    cfg = dataclasses.replace(tconfigs.get_tiny(arch),
                              compute_dtype=torch.float32,
                              logits_softcap=softcap, opt_level=opt_level)
    gen = torch.Generator().manual_seed(1)
    b, length = 3, 12
    q = torch.randn(b, 1, cfg.num_heads, cfg.hd, generator=gen) * 3
    k, v = (torch.randn(b, length, cfg.num_kv_heads, cfg.hd, generator=gen)
            for _ in range(2))
    pos = torch.tensor([2, 7, 11])
    mask = (torch.arange(length)[None] <= pos[:, None])[:, None, None, None]
    want = attention._sdpa(q, k, v, mask, cfg, kv_seq="cache_seq")
    span = length // n

    def part(rank, group):
        at = slice(rank * span, (rank + 1) * span)
        return attention._sdpa_cache_slice(
            q, k[:, at], v[:, at], mask, cfg=cfg, group=group, heads=None,
            offsets=(None, (0, rank * span, 0, 0), None, None))

    for got in _over_slices(part, n, monkeypatch):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_flash_decode_local_shares_the_combine(monkeypatch):
    """``serve.decode_sharded.flash_decode_local`` (its mask -inf, not the
    model's finite one) over 4 slices, the last two wholly invalid for a
    row and a row invalid everywhere, gives dense attention, and 0 for
    the row that sees nothing."""
    gen = torch.Generator().manual_seed(2)
    b, h, kv, hd, length, n = 3, 4, 2, 8, 16, 4
    q = torch.randn(b, 1, h, hd, generator=gen)
    k, v = (torch.randn(b, length, kv, hd, generator=gen) for _ in range(2))
    valid = torch.arange(length)[None] <= torch.tensor([5, 15, -1])[:, None]
    qg = q.reshape(b, kv, h // kv, hd) * hd ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qg, k)
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    want = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s[:2], dim=-1),
                        v[:2]).reshape(2, 1, h, hd)
    span = length // n

    def part(rank, group):
        at = slice(rank * span, (rank + 1) * span)
        return decode_sharded.flash_decode_local(q, k[:, at], v[:, at],
                                                 valid[:, at], group)

    for got in _over_slices(part, n, monkeypatch):
        torch.testing.assert_close(got[:2], want, rtol=1e-6, atol=1e-6)
        assert torch.equal(got[2], torch.zeros_like(got[2]))


def main() -> int:
    """The routes DTensor itself takes for ``logsumexp`` and ``amax``
    over vocab-sharded logits on this torch, traced on a (2, 4) fake
    world: ``PYTHONPATH=src python tests/test_torch_dryrun_loss_decode.py``
    prints each op's collectives (or its error)."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch import mesh as tmesh
    print(f"torch {torch.__version__}")
    with tmesh.fake_world(8):
        mesh = tmesh.make_mesh(*WORLD, device="cpu")
        for name, fn in (("logsumexp", lambda x: torch.logsumexp(x, -1)),
                         ("amax", lambda x: torch.amax(x, -1).full_tensor())):
            mode = tcost.CostMode()
            with mode:
                x = DTensor.from_local(torch.empty(ROWS, SEQ, 64), mesh,
                                       [Shard(0), Shard(2)], run_check=False)
                mode.begin((x,))
                try:
                    y = fn(x)
                    trace = mode.end(y)
                    print(f"{name}: {trace.collectives} -> "
                          f"{getattr(y, 'placements', 'whole')}")
                except Exception as e:          # noqa: BLE001 -- printed
                    print(f"{name}: {type(e).__name__}: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
