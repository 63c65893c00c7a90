"""The sharded step computes attention and the MoE experts on the blocks
that the reference's constraints give each rank, on the CPU.

The reference constrains q and attention's output to ``("batch", "seq",
"heads", "head_dim")``, the expert activations to ``("batch",
"experts_act", None, "embed"/"expert_mlp")``, and shards the expert
weights as ``rules_for`` binds them; GSPMD then computes each rank's block
where those constraints place it.  The same tiny cells as
``test_torch_dryrun_pod.py`` (one pattern group, 8 sequences of 16
tokens) are traced on a fake world of eight ranks, (2, 4) ``("data",
"model")``: each rank's score products cover 4 of the 8 sequences and 1
of the 4 heads, so their FLOPs a chip are an eighth of the whole, and no
rank holds or receives a whole expert table.  Where the ``model`` axis
splits no head (gemma3-1b's 4 heads on 8 ranks) the heads stay whole, as
the reference's filtered constraint leaves them, and the cell costs what
it cost before the heads were sharded.
"""
import collections
import dataclasses

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import configs as tconfigs
from repro_torch.launch import cost as tcost
from repro_torch.models import attention
from test_torch_dryrun_pod import trace_world

WORLD = ((2, 4), ("data", "model"))
BATCH, SEQ = 8, 16                      # trace_world's tiny shape

# attention's score and value products (``_sdpa``, opt_level 0)
PRODUCTS = ("bqkgh,bskh->bkgqs", "bkgqs,bskh->bqkgh")


def _trace(arch: str, kind: str, world, monkeypatch) -> dict:
    """``trace_world``'s cell, with the FLOPs counted inside attention's
    products and their calls, and the most elements any counted op's
    tensor (operand or result, collectives included) holds."""
    seen = {"inside": False, "calls": 0, "flops": 0.0, "numel": 0}
    einsum, count = torch.einsum, tcost.CostMode._count

    def products(eq, *operands):
        if eq not in PRODUCTS:
            return einsum(eq, *operands)
        seen["calls"] += 1
        seen["inside"] = True
        try:
            return einsum(eq, *operands)
        finally:
            seen["inside"] = False

    def counted(self, func, args, kwargs, out):
        before = self.trace.flops
        count(self, func, args, kwargs, out)
        if seen["inside"]:
            seen["flops"] += self.trace.flops - before
        seen["numel"] = max([seen["numel"]] + [
            t.numel() for t in tree_leaves((args, kwargs, out))
            if isinstance(t, torch.Tensor)])

    monkeypatch.setattr(torch, "einsum", products)
    monkeypatch.setattr(tcost.CostMode, "_count", counted)
    mp = pytest.MonkeyPatch()
    out = trace_world(arch, kind, world, mp)
    return {**seen, "trace": out["trace"]}


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in ("deepseek-7b", "grok-1-314b", "arctic-480b")
    for k in ("train", "prefill")])
def test_each_rank_computes_its_heads_and_holds_no_whole_expert_table(
        arch, kind, monkeypatch):
    cfg = tconfigs.get_tiny(arch)
    assert cfg.num_heads == 4
    got = _trace(arch, kind, WORLD, monkeypatch)
    whole = 2 * BATCH * cfg.num_heads * SEQ * SEQ * cfg.hd
    assert got["calls"] > 0
    assert got["flops"] == got["calls"] * whole / 8
    if cfg.num_experts:
        table = cfg.num_experts * cfg.d_model * cfg.d_ff
        assert got["numel"] < table


# gemma3-1b's tiny train and prefill cells on (1, 8), as the commit
# before the heads were sharded traced them (torch 2.13): FLOPs, the
# collectives as {(op, result bytes, group): count}, and the peak.  The
# train cell's loss runs vocab-parallel since: its two all-gathers of
# the rank's logit rows whole in vocab (8 x 16 x 256 float32, 131072 B:
# logsumexp's and the target gather's) became three all-reduces of (8,
# 16) float32 values (the spans' max, sum of exps and target logit)
GEMMA_1X8 = {
    "train": (83820544.0, {
        ("all-gather", 4096, 8): 24, ("all-gather", 8192, 8): 6,
        ("all-gather", 16384, 8): 12, ("all-gather", 20480, 8): 6,
        ("all-gather", 40960, 8): 6, ("all-gather", 65536, 8): 1,
        ("all-reduce", 512, 8): 3, ("all-reduce", 224, 8): 1,
        ("all-reduce", 256, 8): 13, ("all-reduce", 16384, 8): 29,
        ("all-reduce", 32768, 8): 1, ("reduce-scatter", 2048, 8): 6,
        ("reduce-scatter", 5120, 8): 18}, 2436246),
    "prefill": (11534336.0, {
        ("all-gather", 4096, 8): 12, ("all-gather", 16384, 8): 6,
        ("all-gather", 65536, 8): 1, ("all-reduce", 16384, 8): 12},
        331904),
}


@pytest.mark.parametrize("kind", list(GEMMA_1X8))
def test_heads_the_model_axis_does_not_split_stay_whole(kind, monkeypatch):
    cfg = tconfigs.get_tiny("gemma3-1b")
    got = _trace("gemma3-1b", kind, ((1, 8), ("data", "model")),
                 monkeypatch)
    # every rank computes every head of every sequence
    whole = 2 * BATCH * cfg.num_heads * SEQ * SEQ * cfg.hd
    assert got["flops"] == got["calls"] * whole > 0
    trace = got["trace"]
    flops, collectives, peak = GEMMA_1X8[kind]
    assert trace.flops == flops
    assert collections.Counter(trace.collectives) == collectives
    assert trace.peak_bytes == peak



@pytest.mark.parametrize("h0,hl", [(0, 6), (3, 3), (2, 1), (2, 4), (1, 4)],
                         ids=["all", "whole-group", "in-a-group",
                              "two-groups", "straddling"])
def test_a_rank_s_heads_meet_the_kv_heads_of_their_groups(h0, hl):
    """``_sdpa_heads`` on heads ``h0 .. h0 + hl`` of 6 q heads over 2 kv
    heads (groups of 3) gives those heads of the whole attention, also
    where the rank's heads split no group evenly."""
    cfg = dataclasses.replace(tconfigs.get_tiny("grok-1-314b"), num_heads=6,
                     num_kv_heads=2, compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 6, 8, generator=g)
    k, v = (torch.randn(2, 5, 2, 8, generator=g) for _ in range(2))
    mask = torch.tril(torch.ones(5, 5, dtype=torch.bool))[None, None, None]
    whole = attention._sdpa(q, k, v, mask, cfg)
    part = attention._sdpa_heads(q[:, :, h0:h0 + hl], k, v, mask, cfg=cfg,
                                 offsets=((0, 0, h0, 0), (0,) * 4,
                                          (0,) * 4, None))
    torch.testing.assert_close(part, whole[:, :, h0:h0 + hl], rtol=1e-6,
                               atol=1e-6)
