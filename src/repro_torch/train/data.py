"""Training data pipeline, mounted on the SkyStore virtual object store.

The paper's motivating example (§1: repeated-read model training across
clouds) is exactly this pipeline: token shards live as virtual objects in a
*base* region; each pod's region is a cache region.  Every shard GET goes
through :class:`repro_torch.core.virtual_store.VirtualStore`, so write-local +
replicate-on-read + adaptive-TTL eviction manage which shards stay
materialized near the accelerators -- epoch-shaped re-reads are what the
paper's histogram learns.

Two sources:
  * :class:`SyntheticTokens` -- deterministic on-the-fly batches (dry-run,
    smoke tests);
  * :class:`SkyStoreShardSource` -- real bytes through the store: shards are
    .npy blobs written to the base region and read (with caching) from the
    consumer region.

Both yield {"inputs": [B, S] int32, "labels": [B, S] int32} numpy arrays.
This is the port of ``repro.train.data``: the same shards, keys and batches
over the port's store.
"""

from __future__ import annotations

import io
import threading
from typing import Dict, Iterator

import numpy as np

from ..core.virtual_store import VirtualStore


class SyntheticTokens:
    """Deterministic pseudo-corpus: shifted-window token stream."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed = seed
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + self._step)
        self._step += 1
        toks = rng.integers(
            0, self.vocab, (self.batch, self.seq_len + 1), dtype=np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


class SkyStoreShardSource:
    """Shard reader with the paper's placement policy in the loop.

    ``write_corpus`` PUTs shards write-local at the base region; iteration
    GETs them from ``consumer_region`` -- the first epoch pays egress, later
    epochs hit the replicated copies until the adaptive TTL evicts them.
    """

    def __init__(
        self,
        store: VirtualStore,
        bucket: str,
        consumer_region: str,
        batch: int,
        seq_len: int,
        prefetch: int = 2,
    ):
        self.store, self.bucket = store, bucket
        self.region = consumer_region
        self.batch, self.seq_len = batch, seq_len
        self._keys = sorted(store.list_objects(bucket, prefix="shard/"))
        self._idx = 0
        self._lock = threading.Lock()

    # -- corpus creation -------------------------------------------------------
    @staticmethod
    def write_corpus(
        store: VirtualStore,
        bucket: str,
        base_region: str,
        n_shards: int,
        tokens_per_shard: int,
        vocab: int,
        seed: int = 0,
    ) -> None:
        store.create_bucket(bucket)
        for i in range(n_shards):
            rng = np.random.default_rng(seed + i)
            toks = rng.integers(0, vocab, tokens_per_shard, dtype=np.int32)
            buf = io.BytesIO()
            np.save(buf, toks)
            store.put_object(bucket, f"shard/{i:05d}.npy", buf.getvalue(),
                             base_region)

    # -- iteration -----------------------------------------------------------------
    def _read_shard(self, key: str) -> np.ndarray:
        blob = self.store.get_object(self.bucket, key, self.region)
        return np.load(io.BytesIO(blob))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        need = self.batch * (self.seq_len + 1)
        chunks = []
        got = 0
        with self._lock:
            while got < need:
                key = self._keys[self._idx % len(self._keys)]
                self._idx += 1
                arr = self._read_shard(key)
                chunks.append(arr)
                got += arr.size
        flat = np.concatenate(chunks)[:need]
        toks = flat.reshape(self.batch, self.seq_len + 1).astype(np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    @property
    def epoch_bytes(self) -> int:
        return sum(
            self.store.head_object(self.bucket, k).size for k in self._keys)
