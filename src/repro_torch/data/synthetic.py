"""Deterministic synthetic token pipeline (training substrate).

The port's own copy of ``repro.data.synthetic`` (numpy only): the same seed,
host and step give the same batch as the JAX package.

A seeded Markov-ish token stream with local structure (so the loss has
something to learn) packed to fixed sequence length, sharded per host, with
a background prefetch thread — the structure of a real pipeline (shard
assignment, prefetch depth, deterministic resume via step index) without an
external dataset dependency.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    """tokens[t+1] depends on tokens[t] via a fixed random permutation with
    noise — learnable structure, deterministic per (seed, host, step)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1):
        assert global_batch % n_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.host = host_id
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab_size)

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.host)
        b, s, v = self.local_batch, self.seq, self.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s)) < 0.15
        rnd = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rnd[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class Prefetcher:
    """Depth-k background prefetch over a batch(step) callable."""

    def __init__(self, fn, start_step: int = 0, depth: int = 2):
        self.fn = fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = False
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        s = self.step
        while not self._stop:
            try:
                self.q.put((s, self.fn(s)), timeout=1.0)
                s += 1
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop = True
