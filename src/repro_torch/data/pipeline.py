"""Deterministic token pipeline; the JAX package's ``repro.data.pipeline``,
which is numpy only, kept here as the port's own copy.

Batch ``t`` for host ``h`` is a pure function of ``(seed, t, h)``: no
coordinator on the data path, so a restarted run resumes at exactly the
right cursor from the checkpointed step alone.  A background prefetch
thread overlaps host-side generation with device compute.

The synthetic corpus is a mixture of Zipf-distributed unigrams and planted
Markov bigram structure, so cross-entropy actually decreases during
training.  Batches are numpy ``int32`` arrays, equal bit for bit to the JAX
package's for the same ``(seed, step, host)``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    hosts: int = 1
    host_id: int = 0
    bigram_weight: float = 0.7    # strength of the learnable structure


class SyntheticCorpus:
    """Zipf unigrams + deterministic bigram transitions."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # each token deterministically prefers a successor band
        self.succ = rng.permutation(v).astype(np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens", "labels"}``, each ``int32 [global_batch / hosts,
        seq_len]``; the labels are the next tokens."""
        cfg = self.cfg
        if cfg.global_batch % cfg.hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.hosts} hosts")
        per_host = cfg.global_batch // cfg.hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131 + cfg.host_id)
        b, s, v = per_host, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.choice(v, size=b, p=self.unigram)
        noise = rng.random((b, s))
        fresh = rng.choice(v, size=(b, s), p=self.unigram)
        for t in range(s):
            follow = self.succ[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < cfg.bigram_weight,
                                      follow, fresh[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch of host batches: yields ``(step,
    batch)`` from ``start_step`` on, in order.  :meth:`close` stops the
    thread."""

    def __init__(self, corpus: SyntheticCorpus, start_step: int = 0,
                 depth: int = 2):
        self.corpus = corpus
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.corpus.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
