"""Deterministic synthetic token pipeline: seeded, host-shardable, with
double-buffered background prefetch. A copy of the JAX package's
``data/pipeline.py`` (numpy only), so both packages draw the same batches.

The stream has learnable structure (a seeded Markov chain over the vocab plus
copy motifs) so short training runs show real loss movement.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # Markov states
    copy_period: int = 16       # every k-th token repeats token k-8 back


class SyntheticLM:
    """Seeded Markov-chain token source, shardable by (host_id, n_hosts)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        root = np.random.default_rng(cfg.seed)
        # shared model of the "language": state transition + emission tables
        self.trans = root.dirichlet(np.ones(cfg.n_states) * 0.2,
                                    size=cfg.n_states)
        emis = root.dirichlet(np.ones(min(cfg.vocab_size, 512)) * 0.1,
                              size=cfg.n_states)
        self.emit_support = root.choice(
            cfg.vocab_size, size=(cfg.n_states, emis.shape[1]), replace=True)
        self.emis = emis

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32, deterministic in (step, host)."""
        cfg = self.cfg
        out = np.empty((self.local_batch, cfg.seq_len + 1), np.int32)
        for i in range(self.local_batch):
            seq_id = step * cfg.global_batch + self.host_id * self.local_batch + i
            rng = np.random.default_rng((cfg.seed, seq_id))
            state = int(rng.integers(cfg.n_states))
            toks = np.empty(cfg.seq_len + 1, np.int32)
            for t in range(cfg.seq_len + 1):
                if cfg.copy_period and t % cfg.copy_period == 0 and t >= 8:
                    toks[t] = toks[t - 8]           # copy motif
                else:
                    e = rng.choice(self.emis.shape[1], p=self.emis[state])
                    toks[t] = self.emit_support[state, e]
                state = rng.choice(cfg.n_states, p=self.trans[state])
            out[i] = toks
        return out


class Prefetcher:
    """Background-thread double buffering over any step->batch function."""

    def __init__(self, fetch, start_step: int = 0, depth: int = 2):
        self._fetch = fetch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            item = self._fetch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
