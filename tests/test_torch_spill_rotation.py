"""The port's ``SpillStore`` journal against the JAX package's: segment
rotation and retention, windowed reads, read-only opens of damaged or
live files, and the journal mode (``open_append``/``append_block``).

The cases of ``tests/test_spill_rotation.py`` and
``tests/test_spill_readonly.py`` run through ``repro_torch.core`` and,
on the same seeded blocks, through the reference: each case returns what
it read, which must be equal in both packages, and every file the two
stores leave (the active file, its ``.g<first>.seg`` segments) must be
byte-equal.
"""
import os
import struct

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def _same(a, b) -> None:
    """Deep equality of what two cases returned (arrays exactly)."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


def _both(case, tmp_path):
    """``case(pkg, directory)`` for the reference and the port, each in a
    directory of its own; their results must be equal and the files they
    leave byte-equal.  Returns the port's result."""
    out = {}
    for name, pkg in (("ref", J), ("port", T)):
        d = tmp_path / name
        d.mkdir()
        out[name] = case(pkg, d)
    _same(out["port"], out["ref"])
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    return out["port"]


def _block(t0, n=10):
    return (np.arange(t0, t0 + n, dtype=np.int64), np.zeros(n, np.int32),
            np.ones(n, np.int8), np.zeros(n, np.int32),
            np.full(n, -1, np.int32))


def _append_blocks(st, count, start=0, n=10):
    return [st.append_block(*_block((start + i) * 1000, n))
            for i in range(count)]


def _cols(log):
    return [log.times, log.workers, log.deltas, log.tags, log.stacks]


# ---------------------------------------------------------------------------
# rotation and retention (tests/test_spill_rotation.py)
# ---------------------------------------------------------------------------

def test_rotation_rolls_segments_and_keeps_global_indices(tmp_path):
    def case(pkg, d):
        st = pkg.SpillStore(str(d / "j.spill"), rotate_bytes=1)
        idxs = _append_blocks(st, 10)
        out = [idxs, st.blocks, st.segments]
        st.close()
        return out
    idxs, blocks, segments = _both(case, tmp_path)
    assert idxs == list(range(10)) and blocks == 10
    assert segments >= 3
    assert len([f for f in os.listdir(tmp_path / "port")
                if f.endswith(".seg")]) >= 3


def test_reader_spans_segments_bit_equal(tmp_path):
    def case(pkg, d):
        plain, rotated = str(d / "plain.spill"), str(d / "rot.spill")
        for st in (pkg.SpillStore(plain),
                   pkg.SpillStore(rotated, rotate_bytes=1)):
            _append_blocks(st, 8)
            st.close()
        return [_cols(pkg.SpillStore.open_readonly(p).freeze(1))
                for p in (plain, rotated)]
    plain, rotated = _both(case, tmp_path)
    _same(rotated, plain)


def test_iter_blocks_skip_is_global(tmp_path):
    def case(pkg, d):
        st = pkg.SpillStore(str(d / "j.spill"), rotate_bytes=1)
        _append_blocks(st, 10)
        st.close()
        ro = pkg.SpillStore.open_readonly(str(d / "j.spill"))
        return [list(c) for c in ro.iter_block_columns(skip=7)]
    got = _both(case, tmp_path)
    assert len(got) == 3
    assert got[0][0][0] == 7000         # first time of block 7


def test_open_append_resumes_global_numbering(tmp_path):
    def case(pkg, d):
        path = str(d / "j.spill")
        st = pkg.SpillStore(path, rotate_bytes=1)
        _append_blocks(st, 5)
        st.close()
        st = pkg.SpillStore.open_append(path, rotate_bytes=1)
        out = [st.blocks, st.append_block(*_block(5000))]
        st.close()
        return out + [pkg.SpillStore.open_readonly(path).blocks]
    assert _both(case, tmp_path) == [5, 5, 6]


def test_retention_never_prunes_unacked(tmp_path):
    def case(pkg, d):
        st = pkg.SpillStore(str(d / "j.spill"), rotate_bytes=1,
                            retain_blocks=1)
        _append_blocks(st, 10)
        out = [st.first_block, len(list(st.iter_block_columns()))]
        st.set_ack_floor(10)
        out += [st.first_block, st.blocks]
        st.close()
        return out
    first, readable, pruned_to, blocks = _both(case, tmp_path)
    assert first == 0 and readable == 10    # no ack floor: every block held
    assert pruned_to >= 8 and blocks == 10


def test_ack_floor_prunes_whole_segments_only(tmp_path):
    def case(pkg, d):
        path = str(d / "j.spill")
        st = pkg.SpillStore(path, rotate_bytes=1)   # no retention policy
        _append_blocks(st, 10)
        st.set_ack_floor(7)
        out = [st.first_block]
        st.close()
        st = pkg.SpillStore.open_append(path, rotate_bytes=1,
                                        retain_blocks=2)
        st.set_ack_floor(8)
        kept = list(st.iter_block_columns(skip=st.first_block))
        out += [st.first_block, kept[0][0][0]]
        st.close()
        return out
    first, pruned_to, first_time = _both(case, tmp_path)
    assert first == 0
    assert 0 < pruned_to <= 8
    assert first_time == pruned_to * 1000


def test_replay_tail_after_prune_matches(tmp_path):
    def case(pkg, d):
        st = pkg.SpillStore(str(d / "j.spill"), rotate_bytes=1,
                            retain_blocks=3)
        _append_blocks(st, 12)
        st.set_ack_floor(9)
        out = [int(c[0][0]) for c in st.iter_block_columns(skip=9)]
        st.close()
        return out
    assert _both(case, tmp_path) == [9000, 10000, 11000]


def test_rotate_age_seals_old_segment(tmp_path):
    def case(pkg, d):
        path = str(d / "j.spill")
        st = pkg.SpillStore(path, rotate_age_s=0.0)   # every append "old"
        _append_blocks(st, 3)
        out = [st.segments, st.blocks]
        st.close()
        ro = pkg.SpillStore.open_readonly(path)
        return out + [ro.blocks,
                      [int(c[0][0]) for c in ro.iter_block_columns()]]
    segments, blocks, ro_blocks, firsts = _both(case, tmp_path)
    assert segments >= 2 and blocks == ro_blocks == 3
    assert firsts == [0, 1000, 2000]


def test_unrotated_store_unchanged(tmp_path):
    def case(pkg, d):
        st = pkg.SpillStore(str(d / "j.spill"))
        _append_blocks(st, 6)
        out = st.segments
        st.close()
        return [out, sorted(os.listdir(d))]
    assert _both(case, tmp_path) == [0, ["j.spill"]]


def test_prune_before_time_respects_ack_floor(tmp_path):
    def case(pkg, d):
        st = pkg.SpillStore(str(d / "j.spill"), rotate_bytes=1)
        _append_blocks(st, 10)
        out = [st.prune_before_time(10 ** 9), st.first_block]
        st.set_ack_floor(6)
        out += [st.prune_before_time(5000), st.first_block,
                st.pruned_blocks,
                st.prune_before_time(8000, respect_ack=False),
                st.first_block, st.time_bounds() is not None]
        st.close()
        return out
    assert _both(case, tmp_path) == [0, 0, 5, 5, 5, 3, 8, True]


def test_windowed_read_rotated_bit_equal_unrotated(tmp_path):
    lo, hi = 2500, 8200                     # blocks 3..8 intersect

    def case(pkg, d):
        plain, rotated = str(d / "plain.spill"), str(d / "rot.spill")
        a = pkg.SpillStore(plain)
        b = pkg.SpillStore(rotated, rotate_bytes=1)
        for st in (a, b):
            _append_blocks(st, 12)
        wa = [list(c) for c in a.iter_block_columns_window(lo, hi)]
        wb = [list(c) for c in b.iter_block_columns_window(lo, hi)]
        a.close(), b.close()
        wr = [list(c) for c in pkg.SpillStore.open_readonly(
            rotated).iter_block_columns_window(lo, hi)]
        return [wa, wb, wr]
    wa, wb, wr = _both(case, tmp_path)
    assert len(wa) == 6
    assert wa[0][0][0] == 3000 and wa[-1][0][0] == 8000
    _same(wb, wa)
    _same(wr, wa)


def test_windowed_read_exact_after_prune_and_reopen(tmp_path):
    def case(pkg, d):
        path = str(d / "j.spill")
        st = pkg.SpillStore(path, rotate_bytes=1)
        _append_blocks(st, 10)
        st.prune_before_time(4000, respect_ack=False)
        st.close()
        ro = pkg.SpillStore.open_readonly(path)
        return [ro.time_bounds(),
                [int(c[0][0]) for c in ro.iter_block_columns_window(
                    5000, 7000)],
                list(ro.iter_block_columns_window(0, 3000))]
    assert _both(case, tmp_path) == [(4000, 9009), [5000, 6000, 7000], []]


def test_time_bounds_and_index_survive_reopen(tmp_path):
    def case(pkg, d):
        path = str(d / "j.spill")
        st = pkg.SpillStore(path, rotate_bytes=1)
        _append_blocks(st, 4)
        st.append_block(*_block(0, n=0))    # a seq filler block
        _append_blocks(st, 1, start=9)
        out = [st.time_bounds()]
        st.close()
        ro = pkg.SpillStore.open_readonly(path)
        return out + [ro.time_bounds(),
                      [int(c[0][0]) for c in ro.iter_block_columns_window(
                          3000, 9500) if c[0].size]]
    assert _both(case, tmp_path) == [(0, 9009), (0, 9009), [3000, 9000]]


# ---------------------------------------------------------------------------
# read-only opens (tests/test_spill_readonly.py)
# ---------------------------------------------------------------------------

def _fill(pkg, path, log, chunk_events=64):
    st = pkg.SpillStore(str(path), chunk_events=chunk_events)
    st.append_columns(*_cols(log))
    st.close()


def _damage_tail(path):
    """Chop into the payload of the last of 6 blocks."""
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 40)


def _phantom_header(path):
    with open(path, "ab") as f:
        f.write(b"\x07\x00\x00")        # 3 bytes of a next header


def _header_without_payload(path):
    with open(path, "ab") as f:
        f.write(struct.pack("<Q", 1 << 20))   # claims 1M rows, no data


@pytest.mark.parametrize("damage,seed,half_rows,whole", [
    (_damage_tail, 0, 96, 5 * 64),
    (_phantom_header, 1, 64, None),
    (_header_without_payload, 2, 64, None)],
    ids=["truncated-tail-block", "truncated-inside-header",
         "header-only-tail-with-missing-payload"])
def test_damaged_tail_is_ignored(tmp_path, damage, seed, half_rows, whole):
    """A capture cut mid-block, a few bytes of a phantom header, or a
    complete header whose payload never landed: every complete block
    replays and the tail is dropped, its declared rows not trusted."""
    def case(pkg, d):
        log = pkg.synthetic_log(np.random.default_rng(seed), 2, half_rows)
        path = d / "t.spill"
        _fill(pkg, path, log)
        damage(path)
        ro = pkg.SpillStore.open_readonly(str(path), 64)
        chunks = list(ro.iter_chunks(log.num_workers))
        back = ro.freeze(log.num_workers)
        return [len(log), ro.rows_on_disk, sum(len(c) for c in chunks),
                _cols(back)]
    n, on_disk, chunked, back = _both(case, tmp_path)
    keep = n if whole is None else whole
    assert on_disk == chunked == keep == len(back[0])
    log = T.synthetic_log(np.random.default_rng(seed), 2, half_rows)
    np.testing.assert_array_equal(back[0], log.times[:keep])


def test_zero_flushed_bytes_watermark(tmp_path):
    """Nothing flushed yet: a missing file, an empty file, or a writer
    with only buffered rows reads as an empty stream."""
    def case(pkg, d):
        missing = pkg.SpillStore.open_readonly(str(d / "nope.spill"))
        out = [len(missing), list(missing.iter_chunks(2)),
               len(missing.freeze(2))]
        (d / "empty.spill").touch()
        ro = pkg.SpillStore.open_readonly(str(d / "empty.spill"))
        out += [ro.rows_on_disk, list(ro.iter_chunks(2))]
        log = pkg.synthetic_log(np.random.default_rng(3), 2, 4)  # 16 rows
        w = pkg.SpillStore(str(d / "buf.spill"), chunk_events=1024)
        w.append_columns(*_cols(log))
        ro2 = pkg.SpillStore.open_readonly(str(d / "buf.spill"))
        out += [w.rows_on_disk, w.resident_rows, len(ro2),
                list(ro2.iter_chunks(2))]
        w.close()
        return out
    assert _both(case, tmp_path) == [0, [], 0, 0, [], 0, 16, 0, []]


def test_reader_opened_mid_write_sees_flushed_prefix_only(tmp_path):
    def case(pkg, d):
        log = pkg.synthetic_log(np.random.default_rng(4), 2, 96)  # 384 rows
        path = str(d / "live.spill")
        w = pkg.SpillStore(path, chunk_events=64)
        w.append_columns(*_cols(log.chunk(0, 192)))
        ro = pkg.SpillStore.open_readonly(path, 64)
        out = [ro.rows_on_disk,
               sum(len(c) for c in ro.iter_chunks(log.num_workers))]
        w.append_columns(*_cols(log.chunk(192, 384)))
        w.spill()
        out += [ro.rows_on_disk,
                sum(len(c) for c in ro.iter_chunks(log.num_workers))]
        ro2 = pkg.SpillStore.open_readonly(path, 64)
        out += [ro2.rows_on_disk, ro2.freeze(log.num_workers).times,
                log.times]
        w.close()
        return out
    first, first_rows, again, again_rows, fresh, times, want = _both(
        case, tmp_path)
    assert first == first_rows == again == again_rows == 192
    assert fresh == 384
    np.testing.assert_array_equal(times, want)


def test_readonly_store_rejects_appends(tmp_path):
    def case(pkg, d):
        log = pkg.synthetic_log(np.random.default_rng(5), 2, 8)
        _fill(pkg, d / "ro.spill", log)
        ro = pkg.SpillStore.open_readonly(str(d / "ro.spill"))
        with pytest.raises(ValueError):
            ro.append_columns(*_cols(log))
        return []
    _both(case, tmp_path)


# ---------------------------------------------------------------------------
# journal mode: open_append + append_block (block index == seq)
# ---------------------------------------------------------------------------

def _rows(log, lo, hi):
    return _cols(log.chunk(lo, hi))


def test_append_block_indexes_and_replay(tmp_path):
    def case(pkg, d):
        log = pkg.synthetic_log(np.random.default_rng(6), 2, 64)  # 256 rows
        j = pkg.SpillStore.open_append(str(d / "j.spill"))
        idxs, lo = [], 0
        for n in (10, 1, 37, 100):
            idxs.append(j.append_block(*_rows(log, lo, lo + n)))
            lo += n
        tail = [list(c) for c in j.iter_block_columns(skip=2)]
        out = [idxs, j.blocks, tail, log.times[11:48]]
        j.close()
        return out
    idxs, blocks, tail, want = _both(case, tmp_path)
    assert idxs == [0, 1, 2, 3] and blocks == 4
    assert [len(c[0]) for c in tail] == [37, 100]
    np.testing.assert_array_equal(tail[0][0], want)


def test_open_append_resumes_after_complete_history(tmp_path):
    def case(pkg, d):
        log = pkg.synthetic_log(np.random.default_rng(7), 2, 48)
        path = str(d / "r.spill")
        j = pkg.SpillStore.open_append(path)
        j.append_block(*_rows(log, 0, 50))
        j.append_block(*_rows(log, 50, 120))
        j.close()
        j2 = pkg.SpillStore.open_append(path)
        out = [j2.blocks, j2.append_block(*_rows(log, 120, 192)),
               j2.freeze(log.num_workers).times, log.times]
        j2.close()
        return out
    blocks, idx, times, want = _both(case, tmp_path)
    assert blocks == 2 and idx == 2
    np.testing.assert_array_equal(times, want)


def test_open_append_truncates_torn_tail_to_resume_floor(tmp_path):
    def case(pkg, d):
        log = pkg.synthetic_log(np.random.default_rng(8), 2, 64)  # 256 rows
        path = str(d / "torn.spill")
        j = pkg.SpillStore.open_append(path)
        for lo in range(0, 256, 64):
            j.append_block(*_rows(log, lo, lo + 64))
        j.close()
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 33)              # rip into the last payload
        j2 = pkg.SpillStore.open_append(path)
        out = [j2.blocks, os.path.getsize(path) < size,
               j2.append_block(*_rows(log, 192, 256)),
               j2.freeze(log.num_workers).times, log.times,
               [len(c[0]) for c in j2.iter_block_columns(skip=3)]]
        j2.close()
        return out
    blocks, shrank, idx, times, want, tail = _both(case, tmp_path)
    assert blocks == 3 and shrank and idx == 3
    np.testing.assert_array_equal(times, want)
    assert tail == [64]
