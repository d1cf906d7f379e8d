"""Deterministic sharded data pipeline with straggler-mitigated reads.

Starling C1 statelessness applied to data: a batch is a pure function of
(seed, step), so ANY worker — including a backup task or a post-failure
replacement — reproduces the exact batch without coordination.

Two sources:
  * SyntheticCorpus: counter-based RNG tokens (no storage).
  * StoredCorpus: token shards in the object store, read with parallel
    range-GETs + RSM, and PIPELINED: the shard for step k+1 prefetches
    during compute of step k (C5), so data stalls only surface when a read
    straggles past the compute window.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.stragglers import StragglerConfig
from repro_torch.objectstore.client import ReadReq, StoreClient
from repro_torch.objectstore.store import ObjectStore


class SyntheticCorpus:
    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch_at(self, step: int, batch: int, seq: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        tokens = rng.integers(0, self.vocab, (batch, seq + 1),
                              dtype=np.int32)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
                "mask": np.ones((batch, seq), np.int32)}


class StoredCorpus:
    """Token stream stored as fixed-size shard objects in the store."""

    def __init__(self, store: ObjectStore, prefix: str, n_shards: int,
                 tokens_per_shard: int, vocab_size: int,
                 policy: StragglerConfig | None = None, seed: int = 0):
        self.store = store
        self.prefix = prefix
        self.n_shards = n_shards
        self.tokens_per_shard = tokens_per_shard
        self.vocab = vocab_size
        self.policy = policy or StragglerConfig()
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def create(store: ObjectStore, prefix: str, n_shards: int,
               tokens_per_shard: int, vocab_size: int, seed: int = 0,
               **kw) -> "StoredCorpus":
        for i in range(n_shards):
            rng = np.random.default_rng((seed << 20) ^ i)
            toks = rng.integers(0, vocab_size, tokens_per_shard,
                                dtype=np.int32)
            store.put(f"{prefix}/shard{i}", toks.tobytes())
            store.put(f"{prefix}/shard{i}.dw", toks.tobytes())
        return StoredCorpus(store, prefix, n_shards, tokens_per_shard,
                            vocab_size, seed=seed, **kw)

    def batch_at(self, step: int, batch: int, seq: int,
                 now: float = 0.0) -> tuple[dict, float]:
        """Deterministic mapping step -> (shard, offset); returns the batch
        and the virtual completion time of its reads (RSM + parallel)."""
        need = batch * (seq + 1)
        shard = (step * need // self.tokens_per_shard) % self.n_shards
        off = (step * need) % max(self.tokens_per_shard - need, 1)
        client = StoreClient(self.store, self.policy,
                             np.random.default_rng(
                                 self.rng.integers(2 ** 63)))
        # split the range across parallel lanes (§3.3 parallel reads)
        lanes = max(self.policy.parallel_reads, 1)
        span = need * 4 // lanes
        reqs = [ReadReq(f"{self.prefix}/shard{shard}",
                        off * 4 + i * span,
                        min(off * 4 + (i + 1) * span, off * 4 + need * 4),
                        alt_key=f"{self.prefix}/shard{shard}.dw")
                for i in range(lanes)]
        datas, end = client.read_many(reqs, now)
        toks = np.frombuffer(b"".join(datas), np.int32)[:need].reshape(
            batch, seq + 1)
        b = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((batch, seq), np.int32)}
        return b, end


class PrefetchingLoader:
    """Pipelined loader: issues step k+1's reads at the start of step k."""

    def __init__(self, corpus: StoredCorpus, batch: int, seq: int):
        self.corpus = corpus
        self.batch = batch
        self.seq = seq
        self._next: tuple[int, dict, float] | None = None

    def get(self, step: int, now: float, compute_s: float
            ) -> tuple[dict, float]:
        """Returns (batch, data_ready_time). Prefetched reads overlap the
        previous step's compute: stall = max(0, read_end - compute window).
        """
        if self._next is not None and self._next[0] == step:
            _, b, end = self._next
        else:
            b, end = self.corpus.batch_at(step, self.batch, self.seq, now)
        # issue next prefetch as-of now (overlaps the caller's compute)
        nb, nend = self.corpus.batch_at(step + 1, self.batch, self.seq, now)
        self._next = (step + 1, nb, nend)
        return b, max(end, now)
