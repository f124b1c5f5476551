"""Fault tolerance: the restart-from-checkpoint loop, heartbeat/straggler
monitoring (a copy of ``repro.train.ft``, which imports no JAX; the
port keeps its own).

The failure model: a worker dies -> the whole program dies -> the job
restarts and must resume bit-exactly.  The pieces here:

  * ``run_with_restarts`` — the restart loop: run the training function,
    catch worker failure, restore from the latest COMPLETE checkpoint
    and continue.  Combined with the deterministic pipeline
    (repro_torch.data.synthetic, a pure function of step) resume is
    bit-exact.
  * ``StepMonitor`` — per-host step-time EWMA; hosts slower than
    ``straggler_factor`` x the fleet median are flagged.
  * ``Heartbeat`` — liveness file the coordinator can watch.
"""

from __future__ import annotations

import dataclasses
import os
import time


class WorkerFailure(RuntimeError):
    """Raised (or injected in tests) when a worker dies mid-run."""


def run_with_restarts(train_fn, *, restore_fn, max_restarts: int = 3,
                      on_restart=None):
    """train_fn(start_state) -> final_state; restore_fn() -> start_state.

    Restarts train_fn from the latest checkpoint on WorkerFailure, up to
    max_restarts times."""
    attempts = 0
    while True:
        state = restore_fn()
        try:
            return train_fn(state), attempts
        except WorkerFailure:
            attempts += 1
            if attempts > max_restarts:
                raise
            if on_restart:
                on_restart(attempts)


@dataclasses.dataclass
class StepMonitor:
    n_hosts: int
    alpha: float = 0.2                    # EWMA coefficient
    straggler_factor: float = 1.5

    def __post_init__(self):
        self.ewma = [None] * self.n_hosts

    def record(self, host: int, step_time: float):
        e = self.ewma[host]
        self.ewma[host] = step_time if e is None else \
            (1 - self.alpha) * e + self.alpha * step_time

    def stragglers(self) -> list[int]:
        vals = [e for e in self.ewma if e is not None]
        if len(vals) < 2:
            return []
        med = sorted(vals)[len(vals) // 2]
        return [h for h, e in enumerate(self.ewma)
                if e is not None and e > self.straggler_factor * med]


class Heartbeat:
    def __init__(self, path: str, host: int):
        self.path = os.path.join(path, f"heartbeat_{host}")
        os.makedirs(path, exist_ok=True)

    def beat(self, step: int):
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}")

    @staticmethod
    def last(path: str, host: int):
        p = os.path.join(path, f"heartbeat_{host}")
        if not os.path.exists(p):
            return None
        step, t = open(p).read().split()
        return int(step), float(t)
