"""Synthetic-but-learnable data pipeline with host prefetch; a copy of
``repro.train.data`` (numpy only), so the port imports nothing of the JAX
package.  The same ``(vocab, seed)`` gives the reference's samples bitwise.

Tokens are drawn from a fixed random order-1 Markov chain, so a capable
model's loss drops well below the unigram entropy — gives the end-to-end
training example a real learning signal without external data.  A background
thread keeps a prefetch queue full (straggler mitigation at the input layer:
the trainer never blocks on data generation).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["MarkovLM", "prefetch"]


class MarkovLM:
    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.3):
        rng = np.random.default_rng(seed)
        # sparse-ish transition matrix with a few likely successors per token
        probs = rng.dirichlet(np.full(vocab, concentration), size=vocab)
        self.cum = np.cumsum(probs, axis=1)
        self.vocab = vocab
        self.rng = rng

    def sample(self, batch: int, seq: int, seed: Optional[int] = None
               ) -> np.ndarray:
        rng = self.rng if seed is None else np.random.default_rng(seed)
        out = np.empty((batch, seq), dtype=np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        for t in range(1, seq):
            u = rng.random(batch)
            cur = (self.cum[cur] < u[:, None]).sum(axis=1)
            np.clip(cur, 0, self.vocab - 1, out=cur)
            out[:, t] = cur
        return out

    def batches(self, batch: int, seq: int) -> Iterator[dict]:
        while True:
            toks = self.sample(batch, seq)
            yield {"tokens": toks, "targets": toks,
                   "mask": np.ones_like(toks)}


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
