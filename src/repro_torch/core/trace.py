"""Host spans inside the program, off by default.

    from repro_torch.core import trace
    trace.enable()
    ...                                  # solves, banking, builds
    spans = trace.take()                 # [Span, ...], oldest first

A span records its name, its start and end on ``time.perf_counter_ns``,
the id of the span it was opened in (None at the top) and its
attributes.  Spans are kept in memory until ``take()``; each thread has
its own stack of open spans, so the async tier's drain threads nest
their own.

The spans sit at layer boundaries, never inside a per-block loop:

    solver.solve      Solver.solve, whole
    solver.plan       its spec and program-cache lookup (a build too)
    refine.sweep      each compute-precision sweep (attr "pass")
    refine.residual   each refinement residual
    program.build     CompiledSolverCache.get's build on a miss
                      (attrs "kind", "n", "k", "width")
    kfac.bank         kfac_ca.factor_banks_from_state into banks (sync)
    kfac.cholesky     each damped Cholesky of that banking (sync)

Off, ``span`` returns one shared no-op context manager: no clock is
read and nothing is allocated.  A span never synchronizes the device,
except one opened with ``sync=<device>`` while tracing is on: it ends
with a synchronize of that CUDA device, so its length holds the
device's work.  Only set-up code (banking) opens such spans.

The clock is the one the benchmark stamps its own spans with
(``solvebench/tracing.py``), so the offset it finds to a device trace's
clock lays these spans on the trace's timeline too.
"""

from __future__ import annotations

import itertools
import threading
import time

_enabled = False
_spans: list = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The shared span of a disabled trace: enters and exits, records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One recorded span: ``name``, ``start`` and ``end`` (perf_counter
    ns), ``id``, ``parent`` (the enclosing span's id, or None) and
    ``attrs`` (a dict, or None)."""

    __slots__ = ("name", "attrs", "sync", "id", "parent", "start", "end")

    def __init__(self, name: str, attrs, sync):
        self.name, self.attrs, self.sync = name, attrs, sync
        self.id = next(_ids)
        self.parent = self.start = self.end = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.start = time.perf_counter_ns()
        stack.append(self.id)
        return self

    def __exit__(self, *exc):
        try:
            if self.sync is not None and exc[0] is None:
                _synchronize(self.sync)
        finally:
            self.end = time.perf_counter_ns()
            _stack().pop()
            with _lock:
                _spans.append(self)
        return False


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _synchronize(device) -> None:
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str, attrs=None, sync=None):
    """A context manager that records ``name`` while tracing is on (a
    :class:`Span`), else the shared no-op :data:`OFF`.  ``attrs`` is a
    dict kept with the span; ``sync`` a device whose work the span's
    end waits for (set-up spans only)."""
    if not _enabled:
        return OFF
    return Span(name, attrs, sync)


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording; spans already open still record when they end."""
    global _enabled
    _enabled = False


def take() -> list:
    """The spans ended since the last ``take()``, in the order they
    ended, and forget them."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out
