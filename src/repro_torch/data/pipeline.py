"""Token data pipeline backed by the paper's BlockStore (the JAX package's
``repro/data/pipeline.py`` over the port's own `BlockStore`).

A corpus is a BlockStore of fixed-size token blocks (one block = one read
unit = one "split"), and the pipeline prefetches blocks on a background
thread so that a slow block never stalls a training step: the Hadoop
overlap applied to training I/O.

``synthetic_corpus`` draws the reference's Zipf-distributed token stream
(the same numpy draws from the same seed, so the same tokens), so that
training runs hermetically.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np

from repro_torch.core.pipeline.blockstore import BlockStore


def synthetic_corpus(root, *, vocab_size: int, n_tokens: int,
                     block_tokens: int = 65536, seed: int = 0) -> BlockStore:
    """Zipf-distributed int32 token stream split into BlockStore blocks."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    tokens = rng.choice(vocab_size, size=n_tokens, p=probs).astype(np.int32)
    store = BlockStore(Path(root), block_bytes=4 * block_tokens)
    store.put_bytes(tokens.tobytes())
    return store


class TokenPipeline:
    """Iterator of (batch, seq) int32 token/label batches (numpy) with
    block prefetch."""

    def __init__(self, store: BlockStore, *, batch: int, seq: int,
                 prefetch: int = 2, loop: bool = True):
        self.store = store
        self.batch = batch
        self.seq = seq
        self.loop = loop
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._started = False

    def _blocks(self):
        while True:
            for i in range(len(self.store.blocks)):
                yield np.frombuffer(self.store.read_block(i), np.int32)
            if not self.loop:
                return

    def _producer(self):
        need = self.batch * (self.seq + 1)
        buf = np.empty((0,), np.int32)
        for blk in self._blocks():
            buf = np.concatenate([buf, blk])
            while buf.size >= need:
                chunk, buf = buf[:need], buf[need:]
                chunk = chunk.reshape(self.batch, self.seq + 1)
                self._q.put({"tokens": chunk[:, :-1].copy(),
                             "labels": chunk[:, 1:].copy()})
        self._q.put(None)

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item
