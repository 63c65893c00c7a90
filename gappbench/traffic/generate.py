"""The one traffic generator: decode requests and training batches from a
mix's parameters and the run's seed.

Decode: the set of request sizes is fixed by the mix (quantiles of its
distributions, paired by a fixed permutation), so every seed runs the same
sizes; the seed orders them and draws the tokens.  With ``shuffle_block``
in the mix the sizes stand in one fixed order, and the seed orders only
the requests inside each block of that many: a window that takes the
first blocks then gets the same sizes whatever the seed.  A request's start
position is its prompt's length less one: the engine decodes from the
prompt's last token, over cache rows that hold the prompt's K/V.

Training: the batch source copies the arithmetic of the port's
``SyntheticLM`` (a Zipf unigram over the first 4,096 ids mixed half and
half with the previous token plus one, and normal patch embeddings for a
vision prefix), drawn from the run's seed.
"""
from __future__ import annotations

import statistics

import numpy as np


def request_sizes(mix: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(start, max_new)`` of the mix's ``requests`` requests in a fixed
    order: start positions evenly over ``start_pos`` = [lo, hi], new
    tokens at the quantiles of a lognormal (``median``, ``sigma``) clipped
    to [min, max] and to the cache (start + max_new <= cache_len)."""
    n = mix["requests"]
    lo, hi = mix["start_pos"]
    u = (np.arange(n) + 0.5) / n
    start = (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)
    mn = mix["max_new"]
    z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
    new = np.exp(np.log(mn["median"]) + mn["sigma"] * z)
    new = np.clip(np.round(new), mn["min"], mn["max"]).astype(np.int64)
    new = new[np.random.default_rng(0).permutation(n)]
    new = np.minimum(new, mix["cache_len"] - start)
    return start, new


# the fixed order of the sizes under ``shuffle_block``
BLOCK_ORDER_SEED = 1


def decode_requests(mix: dict, seed: int, vocab: int) -> list[dict]:
    """The run's requests, in the order they are submitted."""
    start, new = request_sizes(mix)
    n = len(start)
    rng = np.random.default_rng(seed)
    block = mix.get("shuffle_block")
    if block is None:
        order = rng.permutation(n)
    else:
        fixed = np.random.default_rng(BLOCK_ORDER_SEED).permutation(n)
        order = np.concatenate([rng.permutation(fixed[i:i + block])
                                for i in range(0, n, block)])
    last = rng.integers(0, vocab, size=n)
    return [{"rid": i, "start": int(start[j]), "max_new": int(new[j]),
             "last_token": int(last[i])} for i, j in enumerate(order)]


class BatchSource:
    """A ``next_batch()`` source of the port's loader's shape: int32
    tokens (batch, seq) and, for a vision prefix, float32 patch
    embeddings (batch, prefix, frontend_dim).  Keeps the first ``keep``
    batches for the check."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int,
                 frontend_shape: tuple | None = None, keep: int = 0):
        self.vocab, self.seq, self.batch = vocab_size, seq_len, batch
        self.frontend_shape = frontend_shape
        self._rng = np.random.default_rng(seed)
        self._support = min(vocab_size, 4096)
        ranks = np.arange(1, self._support + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.keep = keep
        self.kept: list[dict] = []

    def next_batch(self) -> dict:
        base = self._rng.choice(self._support, size=(self.batch, self.seq),
                                p=self._probs)
        shifted = (base + 1) % self._support
        mix = self._rng.random((self.batch, self.seq)) < 0.5
        out = {"tokens": np.where(mix, np.roll(shifted, 1, axis=1),
                                  base).astype(np.int32)}
        if self.frontend_shape is not None:
            out["frontend"] = self._rng.standard_normal(
                (self.batch,) + tuple(self.frontend_shape)).astype(
                    np.float32)
        if len(self.kept) < self.keep:
            self.kept.append({k: v.copy() for k, v in out.items()})
        return out
