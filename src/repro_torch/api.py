"""The front door of the port (the counterpart of ``repro.api``).

    from repro_torch import api

    grid = api.make_trsm_mesh(1, 1)            # cuda:0; device="cpu" too
    solver = api.Solver.from_factor(L, grid, precision="bf16_refine")
    server = api.SolveServer(solver, panel_k=16).warmup()
    server.submit(b)
    X, = server.drain()[0]

    X = api.trsm(L, B, grid, method="rec")     # one shot

* :class:`SolveSpec` — frozen, hashable solve configuration; a concrete
  spec IS the compiled-program cache key; ``SolveSpec.auto`` plans it
  from the cost model (:func:`resolve_plan`, :func:`plan_grid`).
* :class:`Solver` — resident factor(s) at any bank width, method "inv"
  (It-Inv-TRSM), "rec" (the recursive baseline) or "auto", one cached
  program per RHS width, a steady state that only queues device work.
* :class:`SolveServer` — continuous batching over a Solver.
* :class:`FactorBank` — the admission layer (stacked storage, hoisted
  phase 1 through the hand-written ``tri_inv_blocks`` kernel);
  ``capacity=C`` makes it live-mutable (admit / replace / replace_run /
  evict / padded and cyclic admission, in place), with
  :class:`UpdateSpec` keying its updater (:func:`updater_for`):

      solver = api.Solver.from_spec(spec, capacity=16)   # empty bank
      slot = solver.admit_factor(L)
      solver.replace_factor(slot, L_new)
      solver.evict_factor(slot)

* :class:`FactorStructure` — a factor's block structure (dense, banded,
  block-sparse; DESIGN.md Sec. 14): ``Solver.from_factor(...,
  structure=...)`` masks the factor at admission, sweeps only its kept
  blocks and forms the refinement residual with the block-masked
  ``trmm`` kernel.
* :func:`plan_fleet`, :class:`SolverFleet` — the mixed-order,
  multi-tenant tier (DESIGN.md Sec. 12): the planner buckets an order
  spectrum (:class:`FleetPlan`, :class:`BucketPlan`), the fleet admits
  each factor into its bucket, zero-padded (phase 1 on the
  validity-gated ``tri_inv_blocks`` kernel), hands back a
  :class:`FleetHandle`, reclaims the coldest slot across tenants and
  live-migrates onto a new plan; ``SolveServer(fleet, panel_k)`` routes
  requests by (tenant, order[, tag]).
* :class:`AsyncSolveServer` — the open-loop tier (DESIGN.md Sec. 13):
  ``submit`` copies a request to the device, stamps it into a bounded
  per-slot :class:`FairQueue` (weighted fair queueing across tenants)
  and returns a :class:`SolveFuture`; a drain loop (a thread, or
  ``step`` by hand under an injected clock) packs and dispatches one
  wave per step through ``SolveServer``'s wave core and resolves the
  futures when the wave's CUDA event has completed.  A full queue
  sheds with :class:`Overloaded`, a turned-over slot strands with
  :class:`StrandedRequestError`, both through typed errors.
* :class:`AdmissionController`, :class:`Autoscaler` — the control plane
  (DESIGN.md Sec. 15): admission sheds a request whose estimated queue
  wait cannot meet the SLO (:class:`DeadlineUnmeetable`, through its
  future) and stamps the others' deadlines; the autoscaler re-prices a
  fleet-mode server's live manifest with :func:`plan_fleet` when its
  buckets' utilization leaves a band, and migrates it live:

      server = api.AsyncSolveServer(solver, panel_k=16, slo_ms=50.0,
                                    admission=api.AdmissionController())
      with server.warmup():
          X = server.submit(b).result(timeout=30)

* :func:`trsm` — one-shot solve.

On a grid with p > 1 (``make_trsm_mesh(p1, p2)`` in each of the p
processes of a ``torch.distributed`` world) :func:`trsm`, :class:`Solver`
and :class:`FactorBank` run in every rank, every preset included; each
rank makes each call in the same order with the same arguments and
gets the natural result back.  Structures, fleets, :class:`SolveServer`
and :class:`AsyncSolveServer` there raise ``NotImplementedError``.
"""

from repro_torch.core import trsm  # noqa: F401
from repro_torch.core.bank import FactorBank  # noqa: F401
from repro_torch.core.control import (  # noqa: F401
    AdmissionController, Autoscaler)
from repro_torch.core.fleet import (  # noqa: F401
    BucketPlan, FleetHandle, FleetPlan, SolverFleet, plan_fleet)
from repro_torch.core.errors import (  # noqa: F401
    DeadlineUnmeetable, Overloaded, ServingError, StrandedRequestError)
from repro_torch.core.grid import TrsmGrid, make_trsm_mesh  # noqa: F401
from repro_torch.core.precision import (  # noqa: F401
    PRESETS, PrecisionPolicy)
from repro_torch.core.session import (  # noqa: F401
    BUILD_COUNTS, CompiledSolverCache, default_cache)
from repro_torch.core.solver import (  # noqa: F401
    Solver, SolveServer, SolveSpec, UpdateSpec,
    plan_grid, resolve_plan, solver_for, updater_for)
from repro_torch.core.serving import (  # noqa: F401
    AsyncSolveServer, FairQueue, SolveFuture)
from repro_torch.core.structure import FactorStructure  # noqa: F401
