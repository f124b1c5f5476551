"""Open-loop async serving with latency SLOs (DESIGN.md Sec. 13), the
counterpart of ``repro.core.serving``; re-exported via
``repro_torch.api``.

Every tier below this one is CLOSED-loop: :class:`SolveServer.drain`
is a synchronous wave-packer driven by the caller, so the caller's own
pace is the admission control.  Production traffic is OPEN-loop —
requests arrive on their own schedule, queues must stay bounded, and
the serving tier owes each request a completion handle and a
tail-latency story.  This module adds that front:

* :class:`AsyncSolveServer` — a background drain loop (one thread,
  injectable clock, injectable thread factory) over the existing
  :class:`~repro_torch.core.solver.SolveServer` wave machinery and
  :class:`~repro_torch.core.fleet.SolverFleet` router.  ``submit``
  never blocks and never waits for a wave: it copies the request to
  the device, stamps it into a bounded per-slot :class:`FairQueue` and
  returns a :class:`SolveFuture`.  The loop packs one wave per live
  slot per iteration and dispatches it through
  ``SolveServer._solve_wave`` — one built program for all traffic, no
  build and no host sync in the steady state (the request's ingestion
  upload is paid at submit, exactly like ``place_rhs``).

* **Admission control.**  Each slot's queue is bounded
  (``queue_depth``); a submit against a full queue is SHED with a
  typed :class:`~repro_torch.core.errors.Overloaded` error — never
  enqueued, never served — so queue delay (and hence tail latency) is
  bounded by construction.

* **Weighted fair packing.**  Within one slot's panel, tenants share
  the ``panel_k`` columns by weighted fair queueing (virtual finish
  times): see :class:`FairQueue`.

* **Pipelined dispatch.**  A wave's kernels are enqueued on the
  device's current stream and the dispatch returns; on a CUDA device
  the loop records one ``torch.cuda.Event`` behind each dispatch.  Up
  to ``max_inflight`` waves stay un-finalized, so wave t+1 is packed
  on the host while wave t runs on the card; a future resolves (and
  its completion is timestamped) when its wave is FINALIZED — its
  event waited on — so reported latencies are end-to-end numbers, not
  enqueue times.  On a CPU device a wave is complete when its dispatch
  returns.  Every wave runs on the device's default stream, the stream
  a producer thread's submit-time upload is ordered on, so a wave
  never reads an RHS before its copy has landed.

* **Evict-under-flight safety.**  The per-slot generation counter
  recorded at submit time is re-checked at pack time: requests whose
  slot was turned over since fail their future with
  :class:`~repro_torch.core.errors.StrandedRequestError` instead of
  hanging (or silently solving against the slot's new occupant).
  Fleet-mode requests record the
  :class:`~repro_torch.core.fleet.FleetHandle` generation, so a
  cross-tenant LRU reclaim strands exactly the displaced tenant's
  queued requests.

Determinism for tests: construct with a fake ``clock``, never call
:meth:`AsyncSolveServer.start`, and drive :meth:`step` /
:meth:`flush` by hand — no thread, no sleeps, no wall-clock
(tests/conftest.py packages this as ``FakeClock`` + ``DrainDriver``).

* **Over p > 1 ranks: a leader and followers.**  The server decides on
  a clock, so the ranks cannot each decide.  Every rank constructs it
  (collectively: it makes the descriptor stream's group) and calls
  :meth:`~AsyncSolveServer.warmup`; then rank 0, the leader, serves
  exactly as at p = 1 — ``submit``, ``step`` or the background loop,
  ``stats``, the futures, the admission controller and the autoscaler
  live there, and only it reads the clock — while every other rank
  calls :meth:`~AsyncSolveServer.follow`, which applies the leader's
  stream (``core.stream``: each wave's composition and RHS, each
  mutation of the fleet or bank, the fleet's LRU touches) until the
  leader's ``stop()``.  A follower's ``submit``, ``step`` and
  mutations raise :class:`~repro_torch.core.errors.ServingError`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time as _time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import errors as _errors
from repro_torch.core import stream
from repro_torch.core.solver import SolveServer


class SystemClock:
    """The default wall clock.  The injection point is duck-typed:
    anything with ``monotonic()`` serves (tests pass a manual
    ``FakeClock`` and step the loop by hand, so async tests never
    sleep)."""

    monotonic = staticmethod(_time.monotonic)
    sleep = staticmethod(_time.sleep)


class SolveFuture:
    """Completion handle for one async solve request.

    ``result(timeout)`` blocks until the request's wave is finalized
    and returns the (n_true, j) solution block (a device tensor) — or
    raises the typed failure
    (:class:`~repro_torch.core.errors.StrandedRequestError` when the
    slot was evicted under the request, or whatever the dispatch
    raised).  ``exception(timeout)`` returns that error instead of
    raising.  ``latency()`` is completion minus arrival on the
    server's (injectable) clock, available once done."""

    __slots__ = ("tenant", "tag", "factor", "order", "width", "arrival",
                 "dispatched", "completed", "_event", "_value", "_error")

    def __init__(self, *, tenant, tag, factor, order, width, arrival):
        self.tenant = tenant
        self.tag = tag
        self.factor = factor        # queue key: slot or (bucket, slot)
        self.order = order          # true RHS row count served back
        self.width = width          # RHS column count
        self.arrival = arrival      # clock.monotonic() at submit
        self.dispatched = None      # set when the wave is dispatched
        self.completed = None       # set when the wave is finalized
        self._event = threading.Event()
        self._value = None
        self._error = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"solve future not done after {timeout}s "
                               f"(is the drain loop running?)")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"solve future not done after {timeout}s "
                               f"(is the drain loop running?)")
        return self._error

    def latency(self) -> float | None:
        """Seconds from arrival to finalization (None until done)."""
        if self.completed is None:
            return None
        return self.completed - self.arrival

    def _resolve(self, value, now: float) -> None:
        self._value = value
        self.completed = now
        self._event.set()

    def _fail(self, error: BaseException, now: float) -> None:
        self._error = error
        self.completed = now
        self._event.set()


@dataclasses.dataclass
class _Request:
    """One queued request (internal): the placed RHS block plus the
    bookkeeping fairness, generations, and futures need."""
    seq: int
    b: object                   # (n_bucket, j) device columns
    width: int                  # j
    tenant: str
    key: object                 # queue key: slot (plain) | (bucket, slot)
    gen: int                    # slot generation at submit
    order: int                  # true row count (== n unless padded)
    future: SolveFuture
    vtag: float = 0.0           # WFQ virtual finish time (set on push)
    deadline: float | None = None   # arrival + slo (admission-stamped)


class FairQueue:
    """One panel slot's bounded, weighted-fair request queue.

    Fairness is weighted fair queueing by VIRTUAL FINISH TIME: tenant
    t's request of width w is stamped ``vtag = max(v[t], vclock) +
    w / weight(t)`` at admission (``v[t]``: t's last stamp; ``vclock``:
    the last PACKED stamp, so a tenant returning from idle gets no
    retroactive credit).  A wave packs stamped requests in ascending
    ``(vtag, seq)`` order and STOPS at the first that does not fit the
    remaining panel width.  The invariants that buys:

    * width bound — a wave never exceeds ``panel_k`` columns;
    * FIFO per tenant — stamps are strictly increasing per tenant;
    * weights honored WITHIN one wave — backlogged tenants' columns
      interleave in proportion to their weights (exactly so for
      unit-width requests);
    * no starvation — a request that does not fit keeps the lowest
      stamp and packs FIRST next wave into a fresh panel (every
      admitted width fits an empty panel, so cross-tenant head-of-line
      blocking costs at most one underfilled wave).

    ``depth`` bounds the queue; :meth:`push` raises
    :class:`~repro_torch.core.errors.Overloaded` when full.  Not
    thread-safe on its own — the server serializes access under its
    submit lock.
    """

    def __init__(self, panel_k: int, depth: int, weights=None):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.panel_k = panel_k
        self.depth = depth
        self.weights = dict(weights) if weights else {}
        for t, w in self.weights.items():
            if not w > 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, "
                                 f"got {w}")
        self._reqs: list[_Request] = []
        self._vt: dict = {}          # tenant -> last assigned stamp
        self._vclock = 0.0           # stamp of the last packed request

    def __len__(self) -> int:
        return len(self._reqs)

    def weight(self, tenant) -> float:
        return self.weights.get(tenant, 1.0)

    def set_weight(self, tenant, w: float) -> None:
        """Update one tenant's fair-share weight mid-stream.  Applies
        to stamps assigned from now on; already-queued requests keep
        the stamps they were admitted with (no retroactive reshuffle,
        so FIFO-per-tenant holds across the change)."""
        if not w > 0:
            raise ValueError(f"tenant {tenant!r} weight must be > 0, "
                             f"got {w}")
        self.weights[tenant] = w

    def queued_width(self) -> int:
        """Total queued RHS columns (the admission controller's
        queue-backlog signal)."""
        return sum(r.width for r in self._reqs)

    def push(self, req: _Request, *, force: bool = False) -> None:
        """``force=True`` bypasses the depth bound — migration re-keys
        an old bucket's queue into a new one and must strand/shed
        nothing, even when the target queue is momentarily over
        depth (it drains on the next waves)."""
        if not force and len(self._reqs) >= self.depth:
            raise _errors.Overloaded(
                f"slot {req.key} queue full ({self.depth} pending): "
                f"request for tenant {req.tenant!r} shed — back off "
                f"and resubmit")
        start = max(self._vt.get(req.tenant, 0.0), self._vclock)
        req.vtag = start + req.width / self.weight(req.tenant)
        self._vt[req.tenant] = req.vtag
        self._reqs.append(req)

    def _pack_order(self) -> list[tuple[tuple, _Request]]:
        """The pack ordering: each request paired with its effective
        (vtag, seq) sort key, ascending.

        Plain WFQ order is each request's own stamp.  When any queued
        request carries a ``deadline`` (SLO-aware admission), requests
        are reordered WITHIN each tenant's FIFO window by earliest
        deadline first: the multiset of a tenant's stamps is kept —
        so the cross-tenant weighted interleave and the width bound
        are exactly what plain WFQ would produce — but the tenant's
        own requests map onto those stamp slots in EDF order
        (deadline-less requests keep submission order via an infinite
        deadline tiebroken by seq).  Stamps themselves are never
        mutated, so future packs and the vclock stay consistent."""
        if not any(r.deadline is not None for r in self._reqs):
            return sorted(((r.vtag, r.seq), r) for r in self._reqs)
        by_tenant: dict = {}
        for r in self._reqs:
            by_tenant.setdefault(r.tenant, []).append(r)
        paired = []
        inf = float("inf")
        for reqs in by_tenant.values():
            slots = sorted((r.vtag, r.seq) for r in reqs)
            edf = sorted(reqs, key=lambda r: (
                r.deadline if r.deadline is not None else inf, r.seq))
            paired.extend(zip(slots, edf))
        paired.sort(key=lambda kr: kr[0])
        return paired

    def pack(self) -> list[_Request]:
        """Pop one wave: ascending effective (vtag, seq) — see
        :meth:`_pack_order` — stop at first non-fit.  Nonempty queue
        => nonempty wave (every admitted width <= panel_k)."""
        order = self._pack_order()
        width = take = 0
        for _, r in order:
            if width + r.width > self.panel_k:
                break
            width += r.width
            take += 1
        wave = [r for _, r in order[:take]]
        self._reqs = [r for _, r in order[take:]]
        if wave:
            self._vclock = max([self._vclock]
                               + [key[0] for key, _ in order[:take]])
        if not self._reqs:
            # system idle: reset virtual time (standard WFQ), so stamp
            # magnitudes cannot grow without bound across a long run
            self._vt.clear()
            self._vclock = 0.0
        return wave

    def pop_if(self, pred: Callable[[_Request], bool]) -> list[_Request]:
        """Remove and return every queued request matching ``pred``
        (the stranded-request sweep), FIFO order."""
        hit = [r for r in self._reqs if pred(r)]
        if hit:
            self._reqs = [r for r in self._reqs if not pred(r)]
            hit.sort(key=lambda r: r.seq)
        return hit


class AsyncSolveServer:
    """Open-loop async front over a
    :class:`~repro_torch.core.solver.Solver` or
    :class:`~repro_torch.core.fleet.SolverFleet` (DESIGN.md Sec. 13).

        solver = api.Solver.from_factor(L, grid)
        server = api.AsyncSolveServer(solver, panel_k=16,
                                      queue_depth=64,
                                      slo_ms=50.0).warmup()
        with server:                        # background drain loop
            fut = server.submit(b)          # -> SolveFuture, never waits
            X = fut.result(timeout=30)
        print(server.stats())               # p50/p99, goodput, sheds

    Plain mode addresses bank slots (``factor=``) exactly like
    :class:`~repro_torch.core.solver.SolveServer`; fleet mode
    (constructed over a :class:`~repro_torch.core.fleet.SolverFleet`)
    addresses ``(tenant, order[, tag])`` and serves each solution
    sliced back to its true order.  ``tenant=`` in plain mode is a
    fairness label only: tenants sharing a slot split its panel by
    :class:`FairQueue` weights.

    ``step()`` packs + dispatches exactly ONE wave (all live slots,
    one program dispatch per bucket) and finalizes waves beyond the
    ``max_inflight`` pipeline depth; the background thread just calls
    ``step`` whenever there is work.  Deterministic tests never call
    :meth:`start` — they drive ``step``/``flush`` by hand under a fake
    clock.  Whether a wave is finalized by waiting on a CUDA event or
    is complete when dispatched follows the device of the solver's
    (or the fleet's) grid.

    Over p > 1 ranks rank 0 leads and the others :meth:`follow` (the
    module's docstring): every rank constructs the server and warms it
    up, in the same order.
    """

    def __init__(self, solver, panel_k: int = 16, *,
                 queue_depth: int = 64, weights=None, clock=None,
                 slo_ms: float | None = None, max_inflight: int = 2,
                 thread_factory=None, poll_s: float = 0.001,
                 latency_window: int = 8192, admission=None,
                 wave_ewma_alpha: float = 0.25):
        from repro_torch.core.fleet import SolverFleet
        if isinstance(solver, SolveServer):
            raise TypeError(
                "wrap the Solver or SolverFleet directly — "
                "AsyncSolveServer owns its queues and builds its own "
                "wave dispatcher")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{max_inflight}")
        self.panel_k = panel_k
        self.queue_depth = queue_depth
        self.weights = weights
        self.slo_ms = slo_ms
        self.max_inflight = max_inflight
        self.fleet = solver if isinstance(solver, SolverFleet) else None
        if self.fleet is not None:
            self.solver = None
            self._servers: dict = {}    # bucket key -> wave dispatcher
            grid = self.fleet.grid
        else:
            self.solver = solver
            self._server = SolveServer(solver, panel_k)
            grid = solver.grid
        self._device = grid.device
        # p > 1: the descriptor stream (core.stream) and the fleet or
        # bank whose mutations it carries (its _relay: self.guard; a
        # fleet's bucket banks read the fleet's); a streamed mutation's
        # body runs with _applying set to its thread
        self._stream = None
        self._owner = self.fleet if self.fleet is not None \
            else solver.bank
        self._applying = None
        self._loop_error = None
        if grid.p > 1:
            if self._owner._relay is not None:
                raise _errors.ServingError(
                    "another AsyncSolveServer leads this fleet or bank "
                    "over p > 1 ranks: stop it first")
            self._stream = stream.ControlStream(grid.mesh)
            if not self.leads and admission is not None:
                raise _errors.ServingError(
                    "an AdmissionController decides on the leader's "
                    "clock: pass admission= on rank 0 only")
            self._owner._relay = self
        self._clock = clock if clock is not None else SystemClock()
        self._now = self._clock.monotonic
        self._poll_s = poll_s
        self._thread_factory = thread_factory if thread_factory \
            is not None else threading.Thread
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # RLock: an attached Autoscaler applies a migration from
        # inside step() (same thread, lock already held)
        self._step_lock = threading.RLock()
        self._queues: dict[object, FairQueue] = {}
        # dispatched, un-finalized waves: ([(request, X), ...], the
        # CUDA event recorded behind the dispatch, or None on a CPU
        # device)
        self._inflight: collections.deque = collections.deque()
        self._seq = 0
        self._thread = None
        self._stop_evt = threading.Event()
        self._drain_on_stop = True
        # control-plane hooks (DESIGN.md Sec. 15): an
        # AdmissionController consulted at submit, an Autoscaler
        # ticked after each step — both optional, both clocked by
        # self._clock only (no wall-clock on the decision path)
        self.admission = admission
        if admission is not None and hasattr(admission, "attach"):
            admission.attach(self)
        self._autoscaler = None
        # live service signal per dispatch unit (bucket key in fleet
        # mode, None in plain mode): EWMA of measured seconds per
        # finalized wave — the admission controller's wait-estimate
        # input once real observations exist (cost-model seed before)
        self.wave_ewma_alpha = wave_ewma_alpha
        self._wave_ewma: dict = {}
        # offered / served columns per dispatch unit (the autoscaler's
        # rate signals; under self._lock / step lock respectively)
        self._offered_cols: collections.Counter = collections.Counter()
        self._served_cols: collections.Counter = collections.Counter()
        # counters (under self._lock unless noted)
        self.submitted = 0
        self.served = 0            # finalized OK (step lock)
        self.shed = 0
        self.stranded = 0
        self.waves = 0             # dispatches (step lock)
        self._latencies: collections.deque = \
            collections.deque(maxlen=latency_window)
        self._slo_violations = 0
        self._tenants: dict[str, dict] = {}   # per-tenant breakdown

    def _tenant_stats(self, tenant: str) -> dict:
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = self._tenants[tenant] = dict(
                submitted=0, served=0, shed=0, deadline_shed=0,
                stranded=0, slo_violations=0)
        return ts

    def _unit(self, key):
        """The dispatch unit a queue key belongs to (bucket key in
        fleet mode, None in plain mode)."""
        return key[0] if self.fleet is not None else None

    @property
    def leads(self) -> bool:
        """Whether this rank decides: always at p = 1, rank 0 at p > 1."""
        return self._stream is None or self._stream.leader

    @property
    def stream(self):
        """The descriptor stream at p > 1 (its ``messages``, ``bytes``
        and ``seconds``), else None."""
        return self._stream

    def _leader_only(self, what: str) -> None:
        if not self.leads:
            raise _errors.ServingError(
                f"{what} on a follower: over p > 1 ranks rank 0 leads "
                f"the server (submits, steps, control plane) and the "
                f"other ranks call follow()")
        if self._stream is not None and self._stream.closed:
            raise _errors.ServingError(
                f"{what} after stop(): the followers have returned")

    def attach_autoscaler(self, autoscaler) -> None:
        """Hook an :class:`~repro_torch.core.control.Autoscaler`:
        ``step()`` ticks it after finalization, on the server's
        injected clock.  Leader only at p > 1: its replans reach the
        followers through the stream."""
        self._leader_only("an Autoscaler")
        self._autoscaler = autoscaler

    def set_admission(self, admission) -> None:
        """Install (or remove, with None) the admission controller
        after construction — e.g. only AFTER priming traffic, so
        startup builds never feed the controller's signals.  Leader
        only at p > 1."""
        if admission is not None:
            self._leader_only("an AdmissionController")
        with self._cond:
            self.admission = admission
        if admission is not None and hasattr(admission, "attach"):
            admission.attach(self)

    def reset_service_ewma(self) -> None:
        """Forget the measured seconds-per-wave signal.  Startup waves
        fold first-build time into the EWMA; call this when priming is
        done so admission estimates start from the cost-model seed and
        refresh from STEADY-state waves only."""
        with self._cond:
            self._wave_ewma.clear()

    def set_weight(self, tenant: str, w: float) -> None:
        """Update one tenant's fair-share weight across every queue
        (and for queues created later)."""
        if not w > 0:
            raise ValueError(f"tenant {tenant!r} weight must be > 0, "
                             f"got {w}")
        with self._lock:
            self.weights = dict(self.weights or {})
            self.weights[tenant] = w
            for fq in self._queues.values():
                fq.set_weight(tenant, w)

    # ------------------------------ lifecycle ------------------------------

    def warmup(self) -> "AsyncSolveServer":
        """Build and run the wave program(s) once and pre-build the
        zero panels, so the first wave — and every wave after it —
        runs at steady-state cost with no host transfer."""
        if self.fleet is not None:
            self.fleet.warmup(self.panel_k)
            for key in self.fleet.buckets:
                self._server_for(key)._zeros()
        else:
            self.solver.warmup(self.panel_k)
            self._server._zeros()
        return self

    def start(self) -> "AsyncSolveServer":
        """Spawn the background drain loop (thread via the injectable
        factory)."""
        self._leader_only("start()")
        if self._thread is not None:
            raise RuntimeError("drain loop already running")
        self._stop_evt.clear()
        self._thread = self._thread_factory(
            target=self._loop, name="async-solve-drain", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True,
             timeout: float | None = None) -> "AsyncSolveServer":
        """Stop the loop.  ``drain=True`` (default) serves everything
        still queued first, so every outstanding future resolves;
        ``drain=False`` abandons the queues (their futures never
        resolve — use only when tearing the whole process down).

        At p > 1 the leader's ``stop()`` then streams STOP, and every
        follower's :meth:`follow` returns; a follower's ``stop()`` does
        nothing.  An error that ended the background loop is raised
        here (and reaches the followers with STOP)."""
        if not self.leads or (self._stream is not None
                              and self._stream.closed):
            return self
        self._drain_on_stop = drain
        self._stop_evt.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        error = self._loop_error
        try:
            if drain and error is None:  # also covers never-started servers
                while self.step():
                    pass
                self.flush()
        except BaseException as e:
            error = e
            raise
        finally:
            if self._stream is not None:
                with self._step_lock:
                    self._stream.send(stream.STOP, dict(
                        sync=self._sync(),
                        error=None if error is None else repr(error)))
                    self._stream.closed = True
                self._detach()
        if error is not None:
            raise error
        return self

    def _detach(self) -> None:
        """Stop leading: the fleet's buckets' banks read the fleet's
        relay, so clearing it releases them too."""
        if self._owner._relay is self:
            self._owner._relay = None
        if self.fleet is not None:
            self.fleet._touched.clear()

    def __enter__(self) -> "AsyncSolveServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    def _pinned(self):
        """The grid's device as the thread's current one: a loop or a
        follower enqueues on its own thread's current stream."""
        return torch.cuda.device(self._device) \
            if self._device.type == "cuda" else contextlib.nullcontext()

    def _loop(self) -> None:
        with self._pinned():
            try:
                while True:
                    served = self.step()
                    if self._stop_evt.is_set():
                        if not self._drain_on_stop or not self.pending():
                            break
                        continue
                    if not served:
                        with self._cond:
                            if not self._has_work() \
                                    and not self._stop_evt.is_set():
                                self._cond.wait(self._poll_s)
                if self._drain_on_stop:
                    while self.step():
                        pass
                self.flush()
            except Exception as e:
                # never swallowed: every open future fails with it, and
                # stop() raises it
                self._loop_error = e
                self._fail_open(e)

    def _fail_open(self, error: BaseException) -> None:
        """Fail every queued and in-flight future with ``error``."""
        now = self._now()
        with self._lock:
            for fq in self._queues.values():
                for r in fq.pop_if(lambda r: True):
                    r.future._fail(error, now)
        while self._inflight:
            for r, _ in self._inflight.popleft()[0]:
                r.future._fail(error, now)

    # ------------------------------ admission ------------------------------

    def _has_work(self) -> bool:
        return any(len(q) for q in self._queues.values())

    def pending(self) -> int:
        """Queued (not yet dispatched) requests across all slots."""
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def _queue_for(self, key) -> FairQueue:
        fq = self._queues.get(key)
        if fq is None:
            fq = self._queues[key] = FairQueue(
                self.panel_k, self.queue_depth, self.weights)
        return fq

    def _server_for(self, key) -> SolveServer:
        """A bucket's wave dispatcher: a plain-mode SolveServer over
        the bucket's solver, made on first use and again when the
        bucket's solver changed (``apply_plan`` rebuilt it; also after
        :meth:`drop_dispatch_unit` forgot a rebuilt bucket's)."""
        solver = self.fleet.solver(key)
        srv = self._servers.get(key)
        if srv is None or srv.solver is not solver:
            srv = self._servers[key] = SolveServer(solver, self.panel_k)
        return srv

    def _dispatcher(self, unit) -> SolveServer:
        """The wave dispatcher of a dispatch unit (:meth:`_unit`)."""
        return self._server if self.fleet is None \
            else self._server_for(unit)

    def submit(self, b, factor: int = 0, *, tenant: str = "default",
               tag: object = None) -> SolveFuture:
        """Enqueue one RHS block — (n,) vector or (n, j) columns — and
        return its :class:`SolveFuture`.  Never blocks and never
        dispatches; the block is copied to the device (at the solver's
        I/O dtype) here, and the drain loop picks the request up on its
        next wave.  Raises
        :class:`~repro_torch.core.errors.Overloaded` when the slot's
        queue is full (the request is shed), and the same submit-time
        validation errors as
        :class:`~repro_torch.core.solver.SolveServer` (unknown/inactive
        slot, over-wide request, shape mismatch).  In fleet mode the
        request is addressed by ``(tenant, order[, tag])`` — the RHS
        row count IS the order — and a missing/stale route raises
        ``KeyError`` here, at admission.  At p > 1 the leader's alone."""
        self._leader_only("submit")
        b = torch.as_tensor(b)
        if b.ndim == 1:
            b = b[:, None]
        if b.ndim != 2:
            raise ValueError(f"rhs must be (n, j), got {tuple(b.shape)}")
        if b.shape[1] > self.panel_k:
            raise ValueError(f"request wider than panel: {b.shape[1]} > "
                             f"{self.panel_k}")
        if self.fleet is not None:
            h = self.fleet.lookup(tenant, order=int(b.shape[0]), tag=tag)
            n_b = h.bucket[0]
            b = b.to(self._device, self.fleet.solver(h.bucket).dtype)
            if b.shape[0] < n_b:         # zero rows, made on the device
                b = torch.nn.functional.pad(b, (0, 0, 0, n_b - b.shape[0]))
            key, gen, order = (h.bucket, h.slot), h.generation, h.order
        else:
            if tag is not None:
                raise ValueError("tag= addressing needs a fleet server "
                                 "(AsyncSolveServer(SolverFleet, ...))")
            if not 0 <= factor < self.solver.width:
                raise ValueError(f"unknown factor {factor}; bank holds "
                                 f"{self.solver.width}")
            bank = self.solver.bank
            if not bank.is_live(factor):
                raise ValueError(
                    f"inactive slot {factor}: evicted or never admitted "
                    f"(live slots: {list(self.solver.live_slots())})")
            if b.shape[0] != self.solver.n:
                raise ValueError(f"rhs must be ({self.solver.n}, j), "
                                 f"got {tuple(b.shape)}")
            b = b.to(self._device, self.solver.dtype)
            key, order = factor, int(b.shape[0])
            gen = bank.slot_generation(factor)
        with self._cond:
            now = self._now()
            future = SolveFuture(tenant=tenant, tag=tag, factor=key,
                                 order=order, width=int(b.shape[1]),
                                 arrival=now)
            req = _Request(seq=self._seq, b=b, width=int(b.shape[1]),
                           tenant=tenant, key=key, gen=gen, order=order,
                           future=future)
            if self.admission is not None:
                # SLO-aware admission (DESIGN.md Sec. 15): the
                # controller stamps req.deadline, or sheds by raising
                # DeadlineUnmeetable — which surfaces ONLY through
                # the future (submit still returns a handle)
                try:
                    self.admission.admit(self, key, req, now)
                except _errors.DeadlineUnmeetable as e:
                    self.shed += 1
                    ts = self._tenant_stats(tenant)
                    ts["shed"] += 1
                    ts["deadline_shed"] += 1
                    future._fail(e, now)
                    return future
            try:
                self._queue_for(key).push(req)
            except _errors.Overloaded:
                self.shed += 1
                self._tenant_stats(tenant)["shed"] += 1
                raise
            self._seq += 1
            self.submitted += 1
            self._tenant_stats(tenant)["submitted"] += 1
            self._offered_cols[self._unit(key)] += req.width
            self._cond.notify()
        return future

    # ------------------------------ the loop ------------------------------

    def _generation(self, key) -> tuple[bool, int]:
        """(live, current generation) for a queue key, either mode."""
        if self.fleet is not None:
            bucket, slot = key
            try:
                bank = self.fleet.bucket(bucket).bank
            except KeyError:
                return False, -1     # bucket closed by a replan
            return bank.is_live(slot), bank.slot_generation(slot)
        return self.solver.bank.is_live(key), \
            self.solver.bank.slot_generation(key)

    def _fail_stranded(self, key, fq: FairQueue, now: float) -> None:
        live, gen = self._generation(key)
        stale = fq.pop_if(lambda r: not live or r.gen != gen)
        for r in stale:
            self.stranded += 1
            self._tenant_stats(r.tenant)["stranded"] += 1
            r.future._fail(_errors.StrandedRequestError(
                f"slot {key} evicted after submission (generation "
                f"{r.gen} -> {gen}, live={live}); the request would "
                f"be served against the slot's new occupant — "
                f"resubmit against a live factor"), now)

    def step(self) -> int:
        """Pack and dispatch ONE wave across all slots with queued
        work, then finalize waves beyond the pipeline depth; with no
        work, finalize everything in flight.  Returns the number of
        requests dispatched (0 = idle).  The background loop calls
        this; deterministic tests call it directly.  At p > 1 the
        leader's alone; idle, it streams a heartbeat when one is due."""
        self._leader_only("step()")
        with self._step_lock:
            now = self._now()
            with self._lock:
                waves: dict = {}
                for key, fq in list(self._queues.items()):
                    self._fail_stranded(key, fq, now)
                    if len(fq):
                        wave = fq.pack()
                        if wave:
                            waves[key] = wave
            if not waves:
                self._finalize(all_waves=True)
                if self._autoscaler is not None:
                    self._autoscaler.tick()
                if self._stream is not None \
                        and self._stream.heartbeat_due():
                    self._stream.send(stream.IDLE,
                                      dict(sync=self._sync()))
                return 0
            dispatched = self._dispatch(waves)
            self._finalize(all_waves=False)
            if self._autoscaler is not None:
                self._autoscaler.tick()
            return dispatched

    def flush(self) -> None:
        """Finalize every in-flight wave (resolve its futures)."""
        with self._step_lock:
            self._finalize(all_waves=True)

    def _dispatch(self, waves: dict) -> int:
        """One program dispatch per dispatch unit (the whole bank in
        plain mode; per bucket in fleet mode); futures join the
        in-flight pipeline with their solutions, views of the wave's
        output that the device is still computing.  At p > 1 the WAVE
        descriptor goes out first, so every follower solves the same
        units in the same order."""
        units: dict = {}             # dispatch unit -> {slot: [req, ...]}
        for key, wave in waves.items():
            unit, slot = key if self.fleet is not None else (None, key)
            units.setdefault(unit, {})[slot] = wave
        if self._stream is not None:
            self._stream.send(stream.WAVE, dict(units=[
                (unit, [(slot, [(r.seq, r.width) for r in wave])
                        for slot, wave in slots.items()])
                for unit, slots in units.items()], sync=self._sync()),
                [torch.cat([r.b for wave in slots.values() for r in wave],
                           dim=1) for slots in units.values()])
        now = self._now()
        pairs: list = []
        total = 0
        for unit_key, unit in units.items():
            srv = self._dispatcher(unit_key)
            by_seq = {r.seq: r for wave in unit.values() for r in wave}
            try:
                out = srv._solve_wave(
                    {slot: [(r.seq, r.b) for r in wave]
                     for slot, wave in unit.items()})
            except Exception as e:       # surface through the futures,
                for r in by_seq.values():     # never hang the loop
                    r.future._fail(e, now)
                if self._stream is not None:
                    raise                # the followers are in this wave
                continue
            self.waves += 1
            for xs in out.values():
                for seq, X in xs:
                    r = by_seq[seq]
                    if r.order < X.shape[0]:    # fleet: slice the
                        X = X[:r.order]         # padded tail back off
                    r.future.dispatched = now
                    pairs.append((r, X))
                    total += 1
        if pairs:
            done = None
            if self._device.type == "cuda":
                done = torch.cuda.Event()
                done.record()        # behind the wave, on its stream
            self._inflight.append((pairs, done))
        while len(self._inflight) > self.max_inflight:
            self._finalize_one()
        return total

    def _finalize(self, *, all_waves: bool) -> None:
        limit = 0 if all_waves else self.max_inflight - 1
        while len(self._inflight) > limit:
            self._finalize_one()

    def _finalize_one(self) -> None:
        pairs, done = self._inflight.popleft()
        if done is not None:
            done.synchronize()       # the one intended wait
        now = self._now()
        units_seen = set()
        for r, X in pairs:
            r.future._resolve(X, now)
            self.served += 1
            ts = self._tenant_stats(r.tenant)
            ts["served"] += 1
            lat = r.future.latency()
            self._latencies.append(lat)
            if self.slo_ms is not None and lat * 1e3 > self.slo_ms:
                self._slo_violations += 1
                ts["slo_violations"] += 1
            unit = self._unit(r.key)
            self._served_cols[unit] += r.width
            # measured seconds per wave for this dispatch unit (one
            # sample per unit per finalized wave): the live service
            # signal wait estimation and autoscaling run on
            if unit not in units_seen and r.future.dispatched \
                    is not None:
                units_seen.add(unit)
                s = now - r.future.dispatched
                prev = self._wave_ewma.get(unit)
                a = self.wave_ewma_alpha
                self._wave_ewma[unit] = s if prev is None \
                    else (1 - a) * prev + a * s

    # ------------------------------- stats -------------------------------

    def stats(self) -> dict:
        """Serving counters + the latency distribution of the last
        ``latency_window`` completed requests: submitted / served /
        shed / stranded / waves / pending / inflight, p50/p99/max
        latency (ms), the violation count when an SLO was set, and the
        per-tenant breakdown under ``"tenants"`` (submitted / served /
        shed / deadline_shed / stranded / slo_violations each).

        Empty-window contract: with NO completed request in the
        window, every percentile field (``p50_ms`` / ``p99_ms`` /
        ``max_ms``) is ``None`` — never ``0.0``, which a scraper would
        read as an (excellent) measurement instead of an absence."""
        with self._lock:
            pending = sum(len(q) for q in self._queues.values())
            lat = sorted(self._latencies)
            tenants = {t: dict(ts) for t, ts in self._tenants.items()}

        def pct(q: float) -> float | None:
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3
        return dict(
            submitted=self.submitted, served=self.served,
            shed=self.shed, stranded=self.stranded, waves=self.waves,
            pending=pending, inflight=len(self._inflight),
            queue_depth=self.queue_depth,
            p50_ms=pct(0.50), p99_ms=pct(0.99),
            max_ms=lat[-1] * 1e3 if lat else None,
            slo_ms=self.slo_ms, slo_violations=self._slo_violations,
            tenants=tenants)

    # ------------------------- migration support -------------------------

    def rekey_queue(self, old_handle, new_handle) -> int:
        """Live-migration hook (DESIGN.md Sec. 15): move every queued
        request addressed at ``old_handle``'s (bucket, slot) onto
        ``new_handle``'s, re-padding the staged RHS to the new bucket
        order and re-stamping the generation — so a fleet replan
        strands NOTHING.  Caller (the Autoscaler's apply path) holds
        the step lock; this takes the submit lock itself.  Returns the
        number of requests moved."""
        if self.fleet is None:
            raise ValueError("rekey_queue is fleet-mode only")
        old_key = (old_handle.bucket, old_handle.slot)
        new_key = (new_handle.bucket, new_handle.slot)
        n_old, n_new = old_handle.bucket[0], new_handle.bucket[0]
        with self._cond:
            fq = self._queues.get(old_key)
            if fq is None:
                return 0
            moved = fq.pop_if(lambda r: True)
            target = self._queue_for(new_key)
            for r in moved:
                if n_new > n_old:
                    # grow from the dispatcher's device-resident zero
                    # panel: no host upload
                    zeros = self._server_for(new_handle.bucket)._zeros()
                    r.b = torch.cat([r.b, zeros[:n_new - n_old, :r.width]
                                     .to(r.b.dtype)], dim=0)
                elif n_new < n_old:
                    # rows past the true order are the admit-time zero
                    # padding; the narrower bucket keeps >= order rows
                    r.b = r.b[:n_new]
                r.key = new_key
                r.gen = new_handle.generation
                r.future.factor = new_key
                target.push(r, force=True)
            if not len(fq):
                self._queues.pop(old_key, None)
            if moved:
                self._cond.notify()
        return len(moved)

    # ------------------------- p > 1: the stream -------------------------

    def _sync(self):
        """The fleet's LRU bookkeeping to stream, or None (plain mode)."""
        return self.fleet._sync_out() if self.fleet is not None else None

    @contextlib.contextmanager
    def guard(self, owner, kind: str, args: tuple, kwargs: dict, *,
              check, lock):
        """Run one mutation of the fleet or bank this server leads over
        p > 1 ranks, or of a bucket's bank of that fleet (the hook of
        ``core.stream.mutation``).  The leader
        holds the step lock, so no wave interleaves, and the owner's
        ``lock``; runs ``check`` (which raises before anything is
        streamed); streams the call; and runs it.  A follower refuses
        it: only the leader decides.  What a streamed mutation calls in
        turn, and a follower's application of it, runs as it is."""
        if self._applying == threading.get_ident():
            with lock:
                yield
            return
        if not self.leads:
            raise _errors.ServingError(
                f"{type(owner).__name__}.{kind} on a follower: while an "
                f"AsyncSolveServer leads it over p > 1 ranks, mutations "
                f"go through the leader (rank 0), which streams them")
        with self._step_lock, lock:
            check()
            self._forward(self._target(owner), kind, args, kwargs)
            with self._applying_here():
                yield

    @contextlib.contextmanager
    def _applying_here(self):
        """Mark this thread as running a streamed mutation's body."""
        prev, self._applying = self._applying, threading.get_ident()
        try:
            yield
        finally:
            self._applying = prev

    def _target(self, owner):
        """Which object a mutation is streamed for: None for the fleet
        or bank this server leads, ``("bucket", key)`` for the bank of
        one of the led fleet's buckets."""
        return None if owner is self._owner else ("bucket", owner._fleet[1])

    def _forward(self, target, kind: str, args: tuple,
                 kwargs: dict) -> None:
        """The leader streams one mutation of ``target``
        (:meth:`_target`): a tensor or array argument goes as a tensor,
        a fleet handle as its (bucket, slot), anything else pickled."""
        from repro_torch.core.fleet import FleetHandle
        tensors = []

        def enc(a):
            if isinstance(a, FleetHandle):
                return ("handle", a.bucket, a.slot)
            if torch.is_tensor(a) or isinstance(a, np.ndarray):
                tensors.append(torch.as_tensor(a))
                return ("tensor", len(tensors) - 1)
            return ("value", a)

        head = dict(target=target, kind=kind, args=[enc(a) for a in args],
                    kwargs={k: enc(v) for k, v in kwargs.items()},
                    sync=self._sync())
        self._stream.send(stream.MUTATE, head, tensors)

    def follow(self) -> "AsyncSolveServer":
        """A follower's serving loop over p > 1 ranks: apply the
        leader's descriptor stream — solve each wave the leader
        dispatches, on the same RHS, through the same dispatcher; apply
        each streamed mutation; take the fleet's LRU bookkeeping — until
        the leader's ``stop()``, then return.  Keeps no futures and
        drops each X once computed; never reads the clock.  Pins the
        grid's device as the drain loop does.  An exception raised here
        propagates; an error that ended the leader's loop raises
        :class:`~repro_torch.core.errors.ServingError` here."""
        if self.leads:
            raise _errors.ServingError(
                "follow() is a follower's: over p > 1 ranks rank 0 leads "
                "(submit, step, start, stop) and the other ranks follow")
        if self._stream.closed:
            raise _errors.ServingError("the leader stopped this server")
        with self._pinned():
            while True:
                kind, head, tensors = self._stream.recv()
                if self.fleet is not None:
                    self.fleet._sync_in(head["sync"])
                if kind == stream.WAVE:
                    self._follow_wave(head["units"], tensors)
                elif kind == stream.MUTATE:
                    self._apply_mutation(head, tensors)
                elif kind == stream.STOP:
                    break
        self._stream.closed = True
        self._detach()
        if head["error"] is not None:
            raise _errors.ServingError(
                f"the leader's drain loop failed: {head['error']}")
        return self

    def _follow_wave(self, units, tensors) -> None:
        """Solve one streamed wave: per unit, the packed RHS split back
        into its requests, through the unit's dispatcher."""
        for (unit, slots), (packed, _) in zip(units, tensors):
            b = packed.to(self._device)
            wave, off = {}, 0
            for slot, reqs in slots:
                wave[slot] = []
                for seq, j in reqs:
                    wave[slot].append((seq, b[:, off:off + j]))
                    off += j
            self._dispatcher(unit)._solve_wave(wave)
            self.waves += 1

    def _apply_mutation(self, head, tensors) -> None:
        """Apply one streamed mutation to this rank's fleet or bank, or
        to the bank of one of its fleet's buckets; a fleet's
        ``apply_plan`` also drops the dispatchers of the buckets it
        closed or rebuilt, as ``Autoscaler.apply`` does."""
        if head["target"] is not None:
            target = self.fleet.bucket(head["target"][1]).bank
        elif self.fleet is not None:
            target = self.fleet
        else:
            target = self.solver.bank

        def dec(enc):
            if enc[0] == "handle":
                return self.fleet.bucket(enc[1]).handles[enc[2]]
            if enc[0] == "tensor":
                t, on_device = tensors[enc[1]]
                return t.to(self._device) if on_device else t
            return enc[1]

        with self._applying_here():
            out = getattr(target, head["kind"])(
                *map(dec, head["args"]),
                **{k: dec(v) for k, v in head["kwargs"].items()})
        if head["kind"] == "apply_plan":
            for key in out["closed"] + out["rebuilt"]:
                self.drop_dispatch_unit(key)

    def drop_dispatch_unit(self, bucket_key) -> None:
        """Forget the wave dispatcher and any empty queues of a bucket
        the fleet closed or rebuilt on migration (stale queues would
        re-create phantom slots on the next sweep)."""
        self._servers.pop(bucket_key, None)
        with self._lock:
            for key in [k for k in self._queues
                        if k[0] == bucket_key and not len(
                            self._queues[k])]:
                self._queues.pop(key)
