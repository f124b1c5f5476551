"""Control plane: SLO-aware admission + fleet autoscaling for the
async serving tier (DESIGN.md Sec. 15), the counterpart of
``repro.core.control``; re-exported via ``repro_torch.api``.

The paper's a priori cost analysis makes configurations priceable
BEFORE anything is built — :func:`~repro_torch.core.fleet.plan_fleet`
already exploits that to bucket a mixed-order manifest, and the async
tier (DESIGN.md Sec. 13) tracks a live latency window but sheds only
on queue depth.  This module closes the loop:

* :class:`AdmissionController` — deadline-aware admission.  At submit
  time it estimates the request's queue wait from the live per-wave
  service EWMA (seeded by the cost-model steady solve time,
  :func:`repro_torch.core.tuning.serving_steady_s`, until real waves
  have been measured) and the target slot's queued backlog
  (:func:`repro_torch.core.cost_model.queue_wait_estimate`).  A
  request whose ``arrival + wait_estimate`` cannot meet ``slo_ms`` is
  shed with :class:`~repro_torch.core.errors.DeadlineUnmeetable` —
  surfaced ONLY through its
  :class:`~repro_torch.core.serving.SolveFuture`, so producers keep
  one exception-free submit path.  Admitted requests are stamped with
  their deadline, and :meth:`FairQueue.pack
  <repro_torch.core.serving.FairQueue.pack>` reorders WITHIN each
  tenant's FIFO window by earliest deadline first (cross-tenant
  weighted fairness untouched).

* :class:`Autoscaler` — planner-driven bucket splits/merges.  It
  tracks per-bucket offered-rate EWMAs (columns/s submitted) against
  each bucket's service capacity (``panel_k`` / measured-or-modeled
  seconds per wave) and, when the worst bucket's utilization drifts
  out of the [low_water, high_water] band, re-prices the LIVE manifest
  with :func:`plan_fleet` at a load-scaled dispatch budget: saturation
  shrinks the budget (padding overhead stops being bought back →
  split), underutilization grows it (dispatch overhead dominates →
  merge).  Replanning is pure cost-model arithmetic — nothing is
  built until the new buckets serve.  An adopted plan is applied LIVE:
  resident factors migrate through the fleet's admit/evict churn path
  (:meth:`SolverFleet.apply_plan
  <repro_torch.core.fleet.SolverFleet.apply_plan>`, phase 1 once per
  moved factor, on B5 where it is padded), queued requests are
  re-keyed onto their new slots (:meth:`AsyncSolveServer.rekey_queue
  <repro_torch.core.serving.AsyncSolveServer.rekey_queue>`) so
  migration strands NOTHING, and buckets that survive the replan keep
  their banks and built programs.

Determinism contract: neither class ever reads a wall clock — every
decision is a function of the server's injected clock and its
counters, so the FakeClock/DrainDriver harness (tests/conftest.py)
reproduces admission and scaling decisions exactly.  The budget the
planner prices with is its nominal dispatch constant
(``plan.dispatch_s``), not a time measured on the card.

Over p > 1 ranks both live on the leader (rank 0), whose clock alone
decides: the server refuses either on a follower, and an adopted plan
reaches the followers through the server's descriptor stream
(``SolverFleet.apply_plan`` is streamed while the server leads the
fleet), so every rank migrates the same factors into the same slots.
"""

from __future__ import annotations

from repro_torch.core import cost_model as cm
from repro_torch.core import errors as _errors
from repro_torch.core import tuning
from repro_torch.core.fleet import plan_fleet


def _steady_seed_s(server, unit, machine=None) -> float:
    """Cost-model seed for one dispatch unit's seconds-per-wave: the
    hoisted steady solve time at the unit's order and the server's
    panel width — the a priori stand-in until the unit's measured
    wave EWMA exists."""
    if server.fleet is not None:
        solver = server.fleet.solver(unit)
    else:
        solver = server.solver
    n0 = solver.n0 if solver.method == "inv" else None
    return tuning.serving_steady_s(
        solver.n, server.panel_k, solver.grid, machine=machine, n0=n0,
        structure=getattr(solver.bank, "structure", None))


class AdmissionController:
    """Deadline-aware admission for :class:`~repro_torch.core.serving.
    AsyncSolveServer` (DESIGN.md Sec. 15).

        ctrl = api.AdmissionController()
        server = api.AsyncSolveServer(solver, panel_k, slo_ms=50.0,
                                      admission=ctrl).warmup()
        fut = server.submit(b)          # never raises for deadline
        err = fut.exception(timeout=1)  # DeadlineUnmeetable when shed

    ``slo_ms`` defaults to the server's; ``safety`` scales the budget
    (0.8 sheds at 80% of the SLO — headroom for estimate error).
    ``dispatch_s`` is the per-wave launch overhead added to the
    modeled service time, the same budget :func:`plan_fleet` prices
    merges against.  ``machine`` prices the cost-model seed (the H100
    preset by default).  All state is derived from the server's
    injected clock and queue/latency counters — no wall-clock reads,
    so decisions replay exactly under the FakeClock harness."""

    def __init__(self, *, slo_ms: float | None = None,
                 safety: float = 1.0, dispatch_s: float = 0.0,
                 machine=None):
        if not safety > 0:
            raise ValueError(f"safety must be > 0, got {safety}")
        self.slo_ms = slo_ms
        self.safety = safety
        self.dispatch_s = dispatch_s
        self.machine = machine
        self.admitted = 0
        self.shed = 0
        self._seeds: dict = {}      # dispatch unit -> modeled s/wave
        self._server = None

    def attach(self, server) -> None:
        """Called by the server at construction (``admission=``)."""
        self._server = server

    def service_s(self, server, unit) -> float:
        """Seconds per wave for a dispatch unit: the live measured
        EWMA once waves have finalized, the cost-model steady seed
        before (both plus ``dispatch_s``)."""
        s = server._wave_ewma.get(unit)
        if s is None:
            s = self._seeds.get(unit)
            if s is None:
                s = self._seeds[unit] = _steady_seed_s(
                    server, unit, self.machine)
        return s + self.dispatch_s

    def wait_estimate(self, server, key, width: int) -> float:
        """Estimated seconds from submit to completion for a request
        of ``width`` columns against queue ``key`` — backlog waves
        ahead of it, its own wave, and the in-flight pipeline, each at
        the unit's per-wave service time."""
        fq = server._queues.get(key)
        queued = fq.queued_width() if fq is not None else 0
        unit = server._unit(key)
        return cm.queue_wait_estimate(
            queued, width, len(server._inflight), server.panel_k,
            self.service_s(server, unit) - self.dispatch_s,
            self.dispatch_s)

    def admit(self, server, key, req, now: float) -> None:
        """The server's submit hook: stamp the request's deadline, or
        shed it by raising
        :class:`~repro_torch.core.errors.DeadlineUnmeetable` (the
        server fails the future with it; submit still returns the
        handle)."""
        slo_ms = self.slo_ms if self.slo_ms is not None \
            else server.slo_ms
        if slo_ms is None:
            return                   # no SLO: depth-only admission
        budget_s = slo_ms * 1e-3 * self.safety
        fq = server._queues.get(key)
        if (fq is None or len(fq) == 0) and not server._inflight:
            # probe path: an idle system always admits one request —
            # its measured wave refreshes the service EWMA, so a
            # pessimistic estimate (e.g. startup builds folded into
            # early samples) can never wedge admission shut
            self.admitted += 1
            req.deadline = now + slo_ms * 1e-3
            return
        wait_s = self.wait_estimate(server, key, req.width)
        if wait_s > budget_s:
            self.shed += 1
            raise _errors.DeadlineUnmeetable(
                f"request for tenant {req.tenant!r} at slot {key} "
                f"cannot meet its {slo_ms:.1f} ms SLO: estimated "
                f"queue wait {wait_s * 1e3:.1f} ms > budget "
                f"{budget_s * 1e3:.1f} ms — shed at admission so "
                f"capacity serves requests that CAN finish in time")
        self.admitted += 1
        req.deadline = now + slo_ms * 1e-3

    def stats(self) -> dict:
        return dict(admitted=self.admitted, shed=self.shed,
                    slo_ms=self.slo_ms, safety=self.safety)


class Autoscaler:
    """Planner-driven online bucket splits/merges for a fleet-mode
    :class:`~repro_torch.core.serving.AsyncSolveServer` (DESIGN.md
    Sec. 15).

        fleet = api.SolverFleet(grid, api.plan_fleet(manifest, grid))
        server = api.AsyncSolveServer(fleet, panel_k).warmup()
        scaler = api.Autoscaler(server)     # attaches: step() ticks it

    Each :meth:`tick` (driven by the server's ``step`` once attached,
    or called directly by a harness) refreshes the per-bucket
    offered-rate EWMAs from the server's submit counters; when the
    maximum bucket utilization leaves [``low_water``, ``high_water``]
    and the ``dwell_s`` hold-down has elapsed, the live manifest is
    re-priced with :func:`plan_fleet` at dispatch budget
    ``base_dispatch_s * target / pressure`` and — if the bucket set
    actually changes — applied as a live migration.  Under sustained
    pressure the post-replan plan is a fixed point (same keys → no-op
    ticks), so scaling CONVERGES instead of thrashing; ``dwell_s``
    bounds the replan rate on top of that.  Decision records
    accumulate in :attr:`replans`."""

    def __init__(self, server, *, high_water: float = 0.85,
                 low_water: float = 0.25, target: float = 0.5,
                 dwell_s: float = 1.0, rate_alpha: float = 0.3,
                 dispatch_s: float | None = None, headroom: int = 0,
                 machine=None, attach: bool = True):
        if server.fleet is None:
            raise ValueError(
                "Autoscaler needs a fleet-mode AsyncSolveServer "
                "(AsyncSolveServer(SolverFleet, ...)): bucket "
                "splits/merges are a fleet concept")
        if not server.leads:
            raise _errors.ServingError(
                "an Autoscaler decides on the leader's clock: over p > 1 "
                "ranks make it on rank 0 only (its replans are streamed)")
        if not 0 < low_water < target < high_water:
            raise ValueError(
                f"need 0 < low_water < target < high_water, got "
                f"{low_water}, {target}, {high_water}")
        self.server = server
        self.high_water = high_water
        self.low_water = low_water
        self.target = target
        self.dwell_s = dwell_s
        self.rate_alpha = rate_alpha
        self.base_dispatch_s = dispatch_s if dispatch_s is not None \
            else server.fleet.plan.dispatch_s
        self.headroom = headroom
        self.machine = machine
        self.offered_ewma: dict = {}     # bucket key -> cols/s
        self.replans: list[dict] = []
        self._seeds: dict = {}
        self._last_tick: float | None = None
        self._last_offered: dict = {}
        self._last_replan: float | None = None
        if attach:
            server.attach_autoscaler(self)

    # ------------------------------ signals ------------------------------

    def _observe(self, now: float) -> None:
        """Fold the submit-counter deltas since the last tick into the
        per-bucket offered-rate EWMAs."""
        if self._last_tick is None:
            self._last_tick = now
            self._last_offered = dict(self.server._offered_cols)
            return
        dt = now - self._last_tick
        if dt <= 0:
            return
        cur = dict(self.server._offered_cols)
        a = self.rate_alpha
        for key in self.server.fleet.buckets:
            rate = (cur.get(key, 0)
                    - self._last_offered.get(key, 0)) / dt
            prev = self.offered_ewma.get(key)
            self.offered_ewma[key] = rate if prev is None \
                else (1 - a) * prev + a * rate
        self._last_tick = now
        self._last_offered = cur

    def observe(self, now: float | None = None) -> None:
        """Refresh the offered-rate EWMAs WITHOUT making a scaling
        decision — re-baselines the observation window (useful after
        a known-idle gap that should not read as underutilization)."""
        self._observe(self.server._now() if now is None else now)

    def _service_s(self, key) -> float:
        s = self.server._wave_ewma.get(key)
        if s is None:
            s = self._seeds.get(key)
            if s is None:
                s = self._seeds[key] = _steady_seed_s(
                    self.server, key, self.machine)
        return s

    def utilization(self) -> dict:
        """Per-bucket offered/capacity ratio: offered cols/s over
        ``panel_k / s_per_wave`` (measured EWMA, cost-model seed until
        one exists)."""
        out = {}
        for key in self.server.fleet.buckets:
            cap = self.server.panel_k / max(self._service_s(key),
                                            1e-12)
            out[key] = self.offered_ewma.get(key, 0.0) / cap
        return out

    # ------------------------------ decisions ------------------------------

    def replan(self, dispatch_s: float):
        """Price a new :class:`~repro_torch.core.fleet.FleetPlan` for
        the LIVE manifest at the given dispatch budget — pure
        arithmetic, nothing built, no migration (that is
        :meth:`apply`)."""
        fleet = self.server.fleet
        man = fleet.manifest()
        if not man:
            return None
        ref = fleet.plan.buckets[0]
        structure = next((b.structure for b in fleet.plan.buckets
                          if b.structure is not None), None)
        return plan_fleet(man, fleet.grid, k=fleet.plan.k,
                          precision=ref.policy, machine=self.machine,
                          dispatch_s=dispatch_s,
                          headroom=self.headroom,
                          structure=structure)

    def apply(self, plan) -> dict:
        """Adopt a plan LIVE under the server's step lock: migrate
        resident factors (:meth:`SolverFleet.apply_plan
        <repro_torch.core.fleet.SolverFleet.apply_plan>`), re-key
        queued requests onto their new slots (stranding nothing), and
        drop the dispatchers of closed/rebuilt buckets so the next
        wave packs against the new banks.  At p > 1 ``apply_plan`` is
        streamed, and each follower drops the same dispatchers."""
        srv = self.server
        with srv._step_lock:
            report = srv.fleet.apply_plan(
                plan, on_move=srv.rekey_queue)
            for key in report["closed"] + report["rebuilt"]:
                srv.drop_dispatch_unit(key)
        return report

    def tick(self, now: float | None = None):
        """One control-loop iteration on the server's clock.  Returns
        the migration report when a replan was applied, else None."""
        srv = self.server
        now = srv._now() if now is None else now
        self._observe(now)
        if self._last_replan is not None \
                and now - self._last_replan < self.dwell_s:
            return None
        if not self.offered_ewma:
            return None              # no completed observation yet
        utils = self.utilization()
        pressure = max(utils.values(), default=0.0)
        if pressure > self.high_water:
            # saturation side: decay the dispatch price linearly,
            # hitting ZERO at 2x target — once offered exceeds
            # capacity, latency is queue-bound and every padded
            # column is pure waste, so buy ALL padding back (full
            # split by order)
            eff = self.base_dispatch_s \
                * max(0.0, 2.0 - pressure / self.target)
        elif pressure < self.low_water:
            # idle side (down to fully idle): dispatch overhead
            # dominates → raise its price so plan_fleet merges
            eff = self.base_dispatch_s * self.target \
                / max(pressure, 1e-12)
        else:
            return None              # inside the band: hold
        plan = self.replan(eff)
        if plan is None:
            return None
        before = set(srv.fleet.buckets)
        if set(b.key for b in plan.buckets) == before:
            return None              # fixed point: converged
        kind = "split" if len(plan.buckets) > len(before) \
            else "merge"
        report = self.apply(plan)
        self._last_replan = now
        self.replans.append(dict(
            t=now, pressure=pressure, dispatch_s=eff, kind=kind,
            moved=len(report["moved"]), opened=report["opened"],
            closed=report["closed"], rebuilt=report["rebuilt"]))
        return report

    def stats(self) -> dict:
        def label(key):              # JSON-safe bucket-key spelling
            return f"{key[0]}/{key[1].name}"
        return dict(replans=len(self.replans),
                    utilization={label(k): round(u, 4) for k, u
                                 in self.utilization().items()},
                    offered_ewma={label(k): v for k, v
                                  in self.offered_ewma.items()},
                    last_replan=self._last_replan)
