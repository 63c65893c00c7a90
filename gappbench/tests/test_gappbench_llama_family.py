"""The ``llama`` family holds the numbers the harness had before families:
the leaf specs, the parameters' and the bank's bytes, the yardstick's
counts, the plain reference's loss, gradients and logits, every reader's
value on the stored records, and the decode check's readings on a stored
run's finished requests, each pinned as it was computed before the llama
code moved into ``families/llama.py`` and ``reference/llama.py`` (the
check's, before the routed check of expert families came in)."""
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench import control, run, weights, yardstick  # noqa: E402
from gappbench.reference import model as ref  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 4099
DATA = pathlib.Path(__file__).with_name("data")


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _bytes(t) -> bytes:
    return t.detach().contiguous().view(torch.uint8).numpy().tobytes()


def _counts_sha(counts) -> str:
    return _sha(json.dumps(counts, sort_keys=True).encode())


@pytest.fixture
def one_thread():
    """The float32 products' bits depend on how many threads split them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# config: (a cell, leaf specs, leaves, matmul params, params, the family's
# ModelConfig family, decode_step counts, train_step counts)
CONFIGS = {
    "deepseek-7b-8l": ("ds7b8-decode-c4k-gapp", "7ef2026424570904", 75,
                       2038431744, 2457931776, "dense", "852e4c68d1de7a69",
                       "7f0786e11974bd6c"),
    "internvl2-2b": ("ivl2-train-s4k-gapp", "f470319da5e6012c", 220,
                     1701595136, 1891244032, "vlm", None,
                     "e97732d16d09fa2b"),
    "tiny-deepseek": ("tiny-decode-gapp", "125ce80fac6d5c11", 21, 110592,
                      127296, "dense", "63d917b61ef8f47f", None),
    "tiny-internvl2": ("tiny-train-gapp", "77406a29c5029a2c", 22, 104448,
                       121152, "vlm", None, "b3049c903166b1f1"),
}
TRAIN_CELL = {"deepseek-7b-8l": "ds7b8-train-s4k-gapp"}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_leaf_specs_and_counts_are_the_parents(config):
    cell, specs, n, mm, params, kind, dec, trn = CONFIGS[config]
    c = cell_lib.load(cell)
    s = c.shape
    assert s.family == "llama" and cell_lib.family_of(s).NAME == "llama"
    got = weights.leaf_specs(s)
    assert len(got) == n and _sha(repr(got).encode()) == specs
    assert yardstick.matmul_params(s) == mm
    assert yardstick.param_count(s) == params
    cfg = cell_lib.model_config(s, c.config_name)
    assert cfg.family == kind and cfg.block_pattern == ("dense",)
    if dec is not None:
        mix = c.traffic
        slots = mix["slots"]
        counts = [yardstick.decode_step(s, slots, r)
                  for r in (slots, slots * 1700, slots * mix["cache_len"])]
        assert _counts_sha(counts) == dec
    if trn is not None:
        mix = cell_lib.load(TRAIN_CELL.get(config, cell)).traffic
        counts = yardstick.train_step(s, mix["batch"], mix["seq_len"])
        assert _counts_sha(counts) == trn


# tiny config: (parameters in float32, in bf16, the bank's k, v, shape)
BYTES = {
    "tiny-deepseek": ("tiny-decode-gapp", "6030eccf5ec71ed8",
                      "5ebc0c485fdafabd", "7abaa2a4fa57fbbe",
                      "62b9d12a2f2e18f7", (2, 32, 4, 16)),
    "tiny-internvl2": ("tiny-train-gapp", "0f8b01cc11cee8b9",
                       "0e32367889d6ff16", "297c104095fa2ccd",
                       "8568c0ba5cd5bfdd", (2, 32, 2, 16)),
}


@pytest.mark.parametrize("config", sorted(BYTES))
def test_parameter_and_bank_bytes_are_the_parents(config):
    cell, f32, bf16, k_sha, v_sha, bank_shape = BYTES[config]
    s = cell_lib.load(cell).shape
    specs = weights.leaf_specs(s)
    for dtype, want in ((torch.float32, f32), (torch.bfloat16, bf16)):
        tree = weights.make_params(s, SEED, dtype, CPU)
        got = b"".join(_bytes(weights.get(tree, p)) for p, _, _ in specs)
        assert _sha(got) == want, dtype
    bk, bv = weights.make_bank(s, SEED, 32, CPU)
    assert tuple(bk.shape) == bank_shape
    assert (_sha(_bytes(bk)), _sha(_bytes(bv))) == (k_sha, v_sha)


TRAIN_REF = {
    "plain": (6.292718410491943, "818ab61168da046b", [
        2.6625254154205322, 0.23602090775966644, 1.7175283432006836,
        1.436724066734314, 0.3946172595024109, 0.26510703563690186,
        1.8117002248764038, 1.7405294179916382, 2.0432400703430176,
        2.2352795600891113, 1.5398502349853516, 1.4787521362304688,
        2.3166069984436035, 0.1587698608636856, 0.17350926995277405,
        0.6288038492202759, 0.6167829632759094, 1.088797926902771,
        1.0238465070724487, 0.9602827429771423, 0.9401797652244568,
        1.510934591293335]),
    "fp8": (6.292892932891846, "7afb94107d5cde7b", [
        2.6759443283081055, 0.23636481165885925, 1.7166123390197754,
        1.4547358751296997, 0.38221290707588196, 0.2626025080680847,
        1.8511515855789185, 1.7370283603668213, 2.052764415740967,
        2.2204384803771973, 1.5290992259979248, 1.4635659456253052,
        2.316532611846924, 0.16399002075195312, 0.17647583782672882,
        0.6390268802642822, 0.6322051286697388, 1.083512783050537,
        1.027853012084961, 0.9498829245567322, 0.9252223372459412,
        1.5007628202438354]),
}


@pytest.mark.parametrize("mm", sorted(TRAIN_REF))
def test_reference_loss_and_gradients_are_the_parents(mm, one_thread):
    s = cell_lib.load("tiny-train-gapp").shape
    params = weights.make_params(s, SEED, torch.float32, CPU)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, s.vocab, (2, 12)))
    front = torch.from_numpy(rng.standard_normal(
        (2, s.prefix, s.frontend_dim)).astype(np.float32))
    leaves = [weights.get(params, p) for p, _, _ in weights.leaf_specs(s)]
    for x in leaves:
        x.requires_grad_(True)
    loss = ref.lm_loss(params, tokens, front, s,
                       mm=ref.plain_mm if mm == "plain" else ref.fp8_mm)
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want_grads, want_norms = TRAIN_REF[mm]
    assert float(loss.detach()) == want_loss
    assert [float(g.norm()) for g in grads] == want_norms
    assert _sha(b"".join(_bytes(g) for g in grads)) == want_grads
    with torch.no_grad():
        half = ref.lm_loss(params, tokens, front, s, keep_rows=slice(0, 1))
    if mm == "plain":
        assert float(half) == 5.80332612991333


def test_reference_decode_logits_are_the_parents(one_thread):
    s = cell_lib.load("tiny-decode-gapp").shape
    params = weights.make_params(s, SEED, torch.float32, CPU)
    bk, bv = weights.make_bank(s, SEED, 32, CPU)
    toks = torch.tensor([5, 17, 200, 3, 99, 42])
    with torch.no_grad():
        a = ref.decode_logits(params, toks, 9, bk[:, :9], bv[:, :9], s)
        b = ref.decode_logits(params, toks, 9, bk[:, :9], bv[:, :9], s,
                              mm=ref.fp8_mm)
        pb = weights.make_params(s, SEED, torch.bfloat16, CPU)
        c = ref.decode_logits(pb, toks, 9, bk[:, :9], bv[:, :9], s)
        # the decode check hands each layer's rows as a list
        d = ref.decode_logits(params, toks, 9, [x[:9] for x in bk],
                              [x[:9] for x in bv], s)
    assert _sha(_bytes(a)) == "36b1a35e1e0096a9"
    assert _sha(_bytes(b)) == "efbfff8d273d044a"
    assert _sha(_bytes(c)) == "c386f106ec840418"
    assert torch.equal(a, d)
    assert [float(x) for x in a[0, :4]] == [
        -0.48102959990501404, -0.4022082984447479, 0.13273648917675018,
        -0.3176441788673401]
    assert ref.widest_gap(a, b.argmax(-1)) == 0.062293052673339844


def test_the_decode_check_reads_the_parents_numbers(one_thread):
    # a tiny run's finished requests, slots and offsets, stored; the llama
    # family routes nothing, so its check keeps its path: logit_gap alone
    rec = json.loads((DATA / "decode-check-tiny.closed.json").read_text())
    c = cell_lib.load("tiny-decode-gapp")
    assert cell_lib.route_layers(c.shape) == []
    assert control.controls_for(c) == ("control", "drop_critical",
                                       "permute_tags")
    closed = {"finished": [tuple(x) for x in rec["finished"]],
              "slot_of": {int(k): tuple(v)
                          for k, v in rec["slot_of"].items()}}
    bank = weights.make_bank(c.shape, rec["seed"], c.traffic["cache_len"],
                             CPU)
    nums, info = run.check_decode(c, rec["seed"], CPU, closed,
                                  (bank, np.array(rec["offsets"])),
                                  ("control",))
    assert nums == {"program": {"logit_gap": 0.015570878982543945},
                    "control": {"logit_gap": 0.5212050676345825}}
    assert info == {"tokens_checked": 51}


# each reader's value on the stored records (traced), as read before
READS = {
    "decode-nogapp-spans.rec.json": {
        "decode_attn_ms": 206.78364199050904,
        "decode_gemm_roofline": 4.521724291483047,
        "decode_issue_ms": 27.844527004740012,
        "decode_itl_p95_ms": 216.93693800000347,
        "decode_mfu": 3.788211956123183,
        "decode_submit_ms": 0.08909249289099527,
        "decode_tokens_per_s": 449.3644795463311,
        "device_idle.decode": 2.3682928300327255,
        "setup_s": 13.714436145999997},
    "decode-spans.rec.json": {
        "decode_attn_ms": 207.034268499979,
        "decode_gemm_roofline": 4.521069461486105,
        "decode_issue_ms": 37.72360904326888,
        "decode_itl_p95_ms": 223.74161400000503,
        "decode_mfu": 3.8078085868714133,
        "decode_submit_ms": 0.24688179807692312,
        "decode_tokens_per_s": 442.87805812228777,
        "device_idle.decode": 3.6731252878455023,
        "gapp_drain_device_ms.decode": 6.199183208695399,
        "gapp_drain_idle.decode": 0.9736545773058047,
        "gapp_drain_ms.decode": 7.940720956522263,
        "setup_s": 14.337785834999991},
    "decode-traced.rec.json": {
        "decode_gemm_roofline": 4.522035445202966,
        "decode_issue_ms": 37.194445236717065,
        "decode_itl_p95_ms": 228.10469300020486,
        "decode_mfu": 3.415610456464482,
        "decode_tokens_per_s": 441.5055647951376,
        "device_idle.decode": 3.816383044542049,
        "gapp_drain_ms.decode": 16.74467132038091,
        "setup_s": 16.594735073000038},
    "train-ds7b8-spans.rec.json": {
        "device_idle.train": 3.375306829893465,
        "gapp_drain_device_ms.train": 2.472232928571462,
        "gapp_drain_ms.train": 3.857427727274251,
        "loader_wait_ms": 0.07621244999640453,
        "setup_s": 22.69357748799996,
        "train_adamw_ms": 143.11364162500556,
        "train_attn_ms": 302.492743325002,
        "train_gemm_roofline": 27.650615655360667,
        "train_issue_ms": 504.56262887500145,
        "train_mfu": 10.092755575621712,
        "train_tokens_per_s": 7211.609511151368},
    "train-spans.rec.json": {
        "device_idle.train": 2.4295432559440777,
        "gapp_drain_device_ms.train": 28.57131303076921,
        "gapp_drain_ms.train": 29.93370786154121,
        "loader_wait_ms": 0.07779062068611266,
        "setup_s": 22.94173662899999,
        "train_adamw_ms": 110.06506479310501,
        "train_attn_ms": 1136.3686880689247,
        "train_gemm_roofline": 15.271138284330874,
        "train_issue_ms": 1507.5497273793064,
        "train_mfu": 7.127759965617143,
        "train_tokens_per_s": 5546.486684186313},
    "train-traced.rec.json": {
        "device_idle.train": 2.4362612664354133,
        "gapp_drain_ms.train": 25.704959676904064,
        "loader_wait_ms": 0.0874847586178005,
        "setup_s": 23.66524951100007,
        "train_gemm_roofline": 15.263165356876105,
        "train_issue_ms": 1508.2245827241675,
        "train_mfu": 7.124165811406205,
        "train_tokens_per_s": 5543.68988286752},
}
# the readers that read the trace, and so nothing from an untraced record
TRACE_ONLY = {"decode_attn_ms", "decode_gemm_roofline", "decode_mfu",
              "decode_submit_ms", "device_idle.decode",
              "gapp_drain_device_ms.decode", "gapp_drain_idle.decode",
              "device_idle.train", "gapp_drain_device_ms.train",
              "train_adamw_ms", "train_attn_ms", "train_gemm_roofline",
              "train_mfu"}


@pytest.mark.parametrize("name", sorted(READS))
def test_every_reader_reads_the_parents_value(name):
    rec = json.loads((DATA / name).read_text())
    rec["shape"] = cell_lib.Shape(**rec["shape"])
    names = sorted(p.stem for p in (ROOT / "gappbench" / "metrics")
                   .glob("*.py") if not p.stem.startswith("_"))
    got = {m: run._reader(m).read(rec) for m in names}
    assert {m: v for m, v in got.items() if v is not None} == READS[name]
    untraced = {m: run._reader(m).read(dict(rec, trace=None))
                for m in names}
    assert {m: v for m, v in untraced.items() if v is not None} == {
        m: v for m, v in READS[name].items() if m not in TRACE_ONLY}
