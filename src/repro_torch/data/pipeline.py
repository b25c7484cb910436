"""Deterministic sharded token pipeline with a checkpointable cursor.

Random-access generation: batch(step, shard) is a pure function of
(seed, step, shard), so
  - the full cursor state is ONE integer (logged through the Assise layer
    with every checkpoint — restore resumes mid-epoch exactly),
  - elastic rescaling re-partitions shards without replaying history,
  - any worker can recompute any other worker's batch (straggler
    hand-off).

A background prefetch thread keeps `depth` batches ready (overlaps host
datagen with device steps).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineState:
    step: int
    seed: int
    n_shards: int
    shard: int

    def encode(self) -> bytes:
        return (f"{self.step},{self.seed},{self.n_shards},"
                f"{self.shard}").encode()

    @staticmethod
    def decode(b: bytes) -> "PipelineState":
        s, seed, n, sh = (int(x) for x in b.decode().split(","))
        return PipelineState(s, seed, n, sh)


class TokenPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 n_shards: int = 1, shard: int = 0, seed: int = 0,
                 prefetch: int = 2, frontend: int = 0, d_model: int = 0):
        assert global_batch % n_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_shards
        self.state = PipelineState(0, seed, n_shards, shard)
        self.frontend = frontend
        self.d_model = d_model
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = None
        if prefetch > 0:
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()

    # -- pure batch function ---------------------------------------------------
    def batch_at(self, step: int) -> dict:
        st = self.state
        rng = np.random.Generator(np.random.Philox(
            key=st.seed, counter=[step, st.shard, 0, 0]))
        tokens = rng.integers(0, self.vocab,
                              (self.local_batch, self.seq + 1),
                              dtype=np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.frontend:
            out["frontend_embeds"] = rng.standard_normal(
                (self.local_batch, self.frontend, self.d_model),
                dtype=np.float32) * 0.02
        return out

    def _producer(self):
        step = self.state.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self.batch_at(step)), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def next(self) -> dict:
        if self._thread is None:
            b = self.batch_at(self.state.step)
            self.state.step += 1
            return b
        while True:
            step, b = self._q.get()
            if step == self.state.step:
                self.state.step += 1
                return b
            if step > self.state.step:  # producer ahead (post-restore):
                b = self.batch_at(self.state.step)  # regenerate in-line
                self.state.step += 1
                return b
            # else: stale prefetch from before a forward restore — drop

    # -- checkpoint integration --------------------------------------------------
    def snapshot(self) -> bytes:
        return self.state.encode()

    def restore(self, b: bytes) -> None:
        st = PipelineState.decode(b)
        self.state.step = st.step
        self.state.seed = st.seed

    def reshard(self, n_shards: int, shard: int) -> None:
        """Elastic rescaling: repartition without history replay."""
        total = self.local_batch * self.state.n_shards
        assert total % n_shards == 0
        self.local_batch = total // n_shards
        self.state.n_shards = n_shards
        self.state.shard = shard

    def close(self):
        self._stop.set()
