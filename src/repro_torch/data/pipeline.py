"""Deterministic synthetic data pipeline with host sharding and prefetch
(port of ``repro/data/pipeline.py``; the numpy code is the JAX package's,
copied, so ``batch_at(step)`` gives the same tokens bit for bit).

  * **Step-indexed determinism** — ``batch_at(step)`` is a pure function
    of (seed, step, host), so a restart replays the exact token stream
    with no data-loader state in the checkpoint.
  * **Host sharding** — each host materializes only its slice of the
    global batch (``host_id / num_hosts``).
  * **Background prefetch** — a double-buffered thread keeps the next
    batch ready.

The corpus is a synthetic "language": Zipfian unigrams mixed with copied
motifs, so cross-entropy falls meaningfully in a short QAT run while no
file is needed.  A ``frontend`` adds Gaussian embeddings [B,
n_frontend_tokens, d_model]: ``embeds`` for a vision stub (prepended to
the tokens), ``enc_embeds`` for an audio stub (the encoder's input).
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    n_motifs: int = 64
    frontend: str | None = None   # audio | vision -> also emit embeddings
    d_model: int = 0
    n_frontend_tokens: int = 0


class SyntheticCorpus:
    """Deterministic synthetic token stream (Zipf unigrams + motif copies)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank; sequences interleave motifs with Zipf noise so
        # there is real predictable structure to learn
        self.motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int32)

    def _zipf(self, rng, n):
        # bounded Zipf via inverse-CDF on a truncated harmonic series
        ranks = np.arange(1, self.cfg.vocab + 1, dtype=np.float64)
        if not hasattr(self, "_cdf"):        # computed once per corpus
            w = ranks ** (-self.cfg.zipf_a)
            self._cdf = np.cumsum(w) / np.sum(w)
        u = rng.random(n)
        return np.searchsorted(self._cdf, u).astype(np.int32)

    def sequence(self, rng, length: int) -> np.ndarray:
        out = np.empty(length + 1, np.int32)
        i = 0
        while i <= length:
            if rng.random() < 0.5:  # motif copy
                m = self.motifs[rng.integers(self.cfg.n_motifs)]
                take = min(len(m), length + 1 - i)
                out[i:i + take] = m[:take]
                i += take
            else:
                take = min(int(rng.integers(8, 33)), length + 1 - i)
                out[i:i + take] = self._zipf(rng, take)
                i += take
        return out

    def batch_at(self, step: int, host_id: int = 0,
                 num_hosts: int = 1) -> dict:
        """Pure function of (seed, step, host): the host's batch slice."""
        cfg = self.cfg
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        local_b = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        seqs = np.stack([self.sequence(rng, cfg.seq_len)
                         for _ in range(local_b)])
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        if cfg.frontend == "vision":
            batch["embeds"] = rng.standard_normal(
                (local_b, cfg.n_frontend_tokens, cfg.d_model),
                dtype=np.float32)
        elif cfg.frontend == "audio":
            batch["enc_embeds"] = rng.standard_normal(
                (local_b, cfg.n_frontend_tokens or cfg.seq_len, cfg.d_model),
                dtype=np.float32)
        return batch


class PrefetchIterator:
    """Double-buffered background prefetch over ``corpus.batch_at``; yields
    ``(step, batch)``.  ``close()`` stops the thread."""

    def __init__(self, corpus: SyntheticCorpus, start_step: int = 0,
                 host_id: int = 0, num_hosts: int = 1, depth: int = 2):
        self.corpus = corpus
        self.step = start_step
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self.corpus.batch_at(step, self.host_id,
                                             self.num_hosts)
            try:
                self._q.put((step, batch), timeout=1.0)
            except queue.Full:
                continue
            step += 1
            batch = None

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self, timeout: float = 5.0):
        self._stop.set()
        self._thread.join(timeout)


def device_put_batch(batch: dict, device=None) -> dict:
    """Host numpy batch -> tensors on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
