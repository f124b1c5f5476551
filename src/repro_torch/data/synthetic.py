"""Deterministic synthetic data pipeline (the counterpart of
``repro.data.synthetic``).

Every example is a pure function of (step, global example index): it
draws from a NumPy generator of its own seeded by that pair, which
gives the three properties the fault-tolerance layer needs with zero
I/O:

  * determinism: restarting from step s reproduces the exact stream, so
    checkpoint-restart is bit-exact;
  * disjointness: hosts draw different examples, no coordination;
  * elasticity: re-sharding to a different host count re-partitions the
    same global stream (the seeds depend on the *global* index).

The streams are not the reference's ``jax.random`` ones.  A
background-thread prefetcher overlaps host-side batch synthesis with
device compute.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.configs import ModelConfig


def _example_rng(step: int, global_index: int) -> np.random.Generator:
    return np.random.default_rng((int(step), int(global_index)))


def host_batch(cfg: ModelConfig, seq: int, global_batch: int, step: int,
               host: int = 0, n_hosts: int = 1) -> dict:
    """The host's slice of the global batch at ``step``, as CPU tensors:
    tokens (B, seq), labels (B, seq) shifted by one; embeds (B, seq, D)
    fp32 in place of tokens for stub-frontend archs; frames
    (B, enc_frames, D) for enc-dec archs."""
    if global_batch % n_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n_hosts} hosts")
    per = global_batch // n_hosts
    rngs = [_example_rng(step, i)
            for i in range(host * per, (host + 1) * per)]
    toks = torch.from_numpy(np.stack(
        [r.integers(0, cfg.vocab, seq + 1) for r in rngs]))
    batch = {"tokens": toks[:, :seq], "labels": toks[:, 1:]}
    if cfg.embed_inputs:
        emb = np.stack([r.standard_normal((seq, cfg.d_model), np.float32)
                        for r in rngs])
        batch = {"embeds": torch.from_numpy(emb), "labels": toks[:, 1:]}
    if cfg.enc_dec:
        frames = np.stack([r.standard_normal(
            (cfg.enc_frames, cfg.d_model), np.float32) for r in rngs])
        batch["frames"] = torch.from_numpy(frames)
    return batch


class Prefetcher:
    """Runs host_batch on a worker thread, ``depth`` batches ahead."""

    def __init__(self, cfg, seq, global_batch, start_step=0, depth=2,
                 host=0, n_hosts=1):
        self.cfg, self.seq, self.gb = cfg, seq, global_batch
        self.host, self.n_hosts = host, n_hosts
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        s = self._step
        while not self._stop.is_set():
            b = host_batch(self.cfg, self.seq, self.gb, s, self.host,
                           self.n_hosts)
            while not self._stop.is_set():
                try:
                    self._q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._t.join(timeout=5)
