"""The traffic generator: determined by the seed, and the same sizes for
every seed."""
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench.traffic import generate  # noqa: E402

MIX = cell_lib.load("ds7b8-decode-c4k-gapp").traffic
SEED = 2**31 + 977


def test_decode_requests_repeat_by_seed():
    a = generate.decode_requests(MIX, SEED, 102400)
    b = generate.decode_requests(MIX, SEED, 102400)
    c = generate.decode_requests(MIX, SEED + 1, 102400)
    assert a == b
    assert a != c


def test_every_seed_runs_the_same_sizes_in_another_order():
    sizes = [sorted((r["start"], r["max_new"]) for r in
                    generate.decode_requests(MIX, s, 102400))
             for s in (1, SEED, 3 * SEED)]
    assert sizes[0] == sizes[1] == sizes[2]
    first = [(r["start"], r["max_new"]) for r in
             generate.decode_requests(MIX, 1, 102400)[:50]]
    other = [(r["start"], r["max_new"]) for r in
             generate.decode_requests(MIX, SEED, 102400)[:50]]
    assert first != other


def test_a_shuffle_block_gives_every_seed_the_same_sizes_block_by_block():
    block = MIX["shuffle_block"]
    runs = [[(r["start"], r["max_new"]) for r in
             generate.decode_requests(MIX, s, 102400)]
            for s in (1, SEED, 3 * SEED)]
    for i in range(0, MIX["requests"], block):
        blocks = [sorted(run[i:i + block]) for run in runs]
        assert blocks[0] == blocks[1] == blocks[2]
    assert runs[0][:block] != runs[1][:block]
    # the fixed order mixes the sizes: no block holds only short prompts
    lo, hi = MIX["start_pos"]
    means = [(np.mean([st for st, _ in runs[0][i:i + block]]) - lo)
             / (hi - lo) for i in range(0, MIX["requests"], block)]
    assert min(means) > 0.35 and max(means) < 0.65
    # without the key, the seed orders the whole list
    whole = {k: v for k, v in MIX.items() if k != "shuffle_block"}
    a = [(r["start"], r["max_new"]) for r in
         generate.decode_requests(whole, 1, 102400)[:block]]
    b = [(r["start"], r["max_new"]) for r in
         generate.decode_requests(whole, SEED, 102400)[:block]]
    assert sorted(a) != sorted(b)


def test_request_sizes_keep_to_the_mix():
    start, new = generate.request_sizes(MIX)
    lo, hi = MIX["start_pos"]
    assert start.min() >= lo and start.max() <= hi
    assert new.min() >= MIX["max_new"]["min"]
    assert new.max() <= MIX["max_new"]["max"]
    assert np.all(start + new <= MIX["cache_len"])
    # the lognormal's median, before the clip to the cache
    assert 120 <= np.median(new) <= 136


def test_batch_source_repeats_by_seed_and_keeps_the_first_batches():
    a = generate.BatchSource(1000, 32, 2, SEED, frontend_shape=(4, 8),
                             keep=2)
    b = generate.BatchSource(1000, 32, 2, SEED, frontend_shape=(4, 8))
    c = generate.BatchSource(1000, 32, 2, SEED + 1)
    xa = [a.next_batch() for _ in range(3)]
    xb = [b.next_batch() for _ in range(3)]
    for u, v in zip(xa, xb):
        assert np.array_equal(u["tokens"], v["tokens"])
        assert np.array_equal(u["frontend"], v["frontend"])
    assert not np.array_equal(xa[0]["tokens"], c.next_batch()["tokens"])
    assert len(a.kept) == 2
    assert np.array_equal(a.kept[1]["tokens"], xa[1]["tokens"])
    assert xa[0]["tokens"].dtype == np.int32
    assert xa[0]["tokens"].max() < 1000
    # the rows of one batch differ
    assert not np.array_equal(xa[0]["tokens"][0], xa[0]["tokens"][1])
