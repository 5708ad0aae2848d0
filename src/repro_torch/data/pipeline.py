"""Deterministic synthetic token pipeline, host-sharded.

The port's own copy of ``repro/data/pipeline.py`` (numpy only, no JAX):
the same Philox streams, so the same (seed, step, example range) gives the
same tokens, bit for bit, in both packages.

Every batch is a pure function of (seed, step, example-index) via Philox
counter-based RNG, so any process can materialize exactly its slice of the
global batch without coordination — the property a 1000-node data loader
needs (no shared filesystem, no shuffle servers, bit-identical restart
after preemption).

``GlobalBatchSpec.local_batch`` returns this process's shard;
``global_batch`` (single-process tests / examples) returns everything.
The token stream is Zipf-distributed over the vocabulary with a strided
structure so the ~100M-param training example has learnable signal
(tokens[t+1] depends on tokens[t]), rather than pure noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GlobalBatchSpec", "synthetic_tokens"]


def synthetic_tokens(seed: int, step: int, index: int, seq_len: int,
                     vocab: int) -> np.ndarray:
    """One example: (seq_len + 1,) int32, deterministic in (seed, step, idx)."""
    rng = np.random.Generator(np.random.Philox(
        key=[(seed << 32) ^ step, index]))
    # Zipf-ish marginal + Markov structure: next = (a*cur + noise) % vocab
    base = rng.zipf(1.3, size=seq_len + 1).astype(np.int64)
    cur = base[0] % vocab
    out = np.empty(seq_len + 1, np.int64)
    out[0] = cur
    mult = 6364136223846793005
    noise = base % 17
    for t in range(1, seq_len + 1):
        cur = (cur * mult + 1442695040888963407 + noise[t]) % vocab
        out[t] = cur
    return out.astype(np.int32)


def _batch_block(seed, step, lo, hi, seq_len, vocab):
    rng = np.random.Generator(np.random.Philox(
        key=[(seed << 32) ^ step, (lo << 32) ^ hi]))
    base = rng.integers(0, vocab, size=(hi - lo, seq_len + 1), dtype=np.int64)
    # cheap learnable structure: even positions echo a shifted prior token
    base[:, 2::2] = (base[:, 1:-1:2] * 31 + 7) % vocab
    return base.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class GlobalBatchSpec:
    seed: int
    seq_len: int
    global_batch: int
    vocab: int

    def global_batch_at(self, step: int) -> np.ndarray:
        """(global_batch, seq_len + 1) int32."""
        return _batch_block(self.seed, step, 0, self.global_batch,
                            self.seq_len, self.vocab)

    def local_batch(self, step: int, process_index: int,
                    process_count: int) -> np.ndarray:
        """This process's contiguous shard of the global batch."""
        assert self.global_batch % process_count == 0
        per = self.global_batch // process_count
        lo = process_index * per
        return _batch_block(self.seed, step, lo, lo + per, self.seq_len,
                            self.vocab)
