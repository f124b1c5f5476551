"""The front door of the solve stack: SolveSpec + Solver + SolveServer
(DESIGN.md Sec. 10; re-exported as ``repro_torch.api``).

* :class:`SolveSpec` — a frozen, hashable description of ONE solve
  configuration: the problem (n, k, operator variant), the plan
  (method, n0, mode, grid — resolvable a priori from the Sec. VIII
  cost model via :meth:`SolveSpec.auto` and :func:`resolve_plan`) and
  the execution policy (precision, bank width, map mode).  A concrete
  spec IS the :class:`~repro_torch.core.session.CompiledSolverCache`
  key.
* :class:`Solver` — resident factor(s) at any bank width: a
  :class:`~repro_torch.core.bank.FactorBank` is the admission layer and
  a width-1 bank is the single-factor case.  After ``warmup`` the steady
  state is one cached program per RHS width that issues device work
  only.
* :class:`UpdateSpec` — the frozen key of a capacity bank's in-place
  updater (the second cache key type, DESIGN.md Sec. 11);
  :func:`updater_for` fetches or builds it.
* :class:`SolveServer` — continuous batching: per-factor request
  queues, first-fit packed fixed-width panels, one solve per wave
  covering every factor, submit-order results; on a capacity bank it
  refuses inactive slots and strands requests whose slot was turned
  over.  Over a :class:`~repro_torch.core.fleet.SolverFleet` it routes
  requests by ``(tenant, order[, tag])`` to the planned buckets.

On a grid with p > 1 (one rank per process, ``make_trsm_mesh`` inside
a ``torch.distributed`` world) a :class:`SolveSpec` builds the one-shot
program (``core.trsm``) and a :class:`Solver` serves its bank
(``from_factor``, ``from_factors``, ``from_bank``, ``from_spec``,
append-only or capacity, every precision preset), every rank calling
each constructor, admission, update and ``solve`` in the same order
with the same arguments: the caller passes the natural B, the same on
every rank, and gets the natural X back on every rank, a structured
factor's too.  A :class:`SolveServer` and a
:class:`~repro_torch.core.fleet.SolverFleet` keep that contract there
(every rank submits, drains, admits and looks up alike; packing,
routing, the fleet's LRU clock and its reclaims follow from the calls
alone).  An ``AsyncSolveServer`` decides on a clock, so at p > 1 rank
0 leads it and the other ranks follow its descriptor stream
(``core.stream``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from repro_torch.core import errors as _errors
from repro_torch.core import precision as preclib
from repro_torch.core import trace
from repro_torch.core.bank import FactorBank
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.structure import FactorStructure


def _normalize_overlap(overlap) -> str | None:
    """Normalize an overlap request to its cache-key spelling:
    ``"off"``/``False``/``None`` -> ``None``, ``"auto"``/``"on"``/
    ``True`` -> ``"on"``.  At p = 1 the sweep has no collective to
    overlap, so both spellings run the same operations."""
    if overlap in (None, False, "off"):
        return None
    if overlap in (True, "auto", "on"):
        return "on"
    raise ValueError(f"overlap must be 'auto' | 'on' | 'off' | bool | "
                     f"None, got {overlap!r}")


def _normalize_structure(structure):
    """Dense IS the unstructured path: ``FactorStructure.dense()``
    normalizes to ``None``, so the two spell one cache key."""
    if structure is None or structure.is_dense:
        return None
    return structure


def _check_method(method: str, *, auto: bool = False) -> None:
    """Methods name an algorithm, "inv" or "rec".  "auto" is resolved
    before a spec or a bank exists, so only the front doors that
    resolve it (``auto=True``) take it."""
    methods = ("inv", "rec", "auto") if auto else ("inv", "rec")
    if method not in methods:
        raise ValueError(f"method must be one of {methods}, got "
                         f"{method!r} (SolveSpec.auto and resolve_plan "
                         f"resolve 'auto')")


# ----------------------------- plan resolution -----------------------------

def plan_grid(p1: int, p2: int) -> TrsmGrid:
    """A device-less grid (p1 x p1 x p2) for plan-only specs: carries the
    processor-grid arithmetic of a :class:`SolveSpec` without touching
    devices.  Executable paths (:func:`solver_for`, :class:`Solver`)
    need a grid from ``make_trsm_mesh``."""
    return TrsmGrid(None, p1, p2)


def resolve_plan(grid: TrsmGrid, n: int, k: int, *, method: str = "inv",
                 n0: int | None = None, machine=None,
                 hoisted: bool = False,
                 structure=None) -> tuple[str, int]:
    """The ONE place method/n0 defaults are resolved (host arithmetic,
    so cache keys are concrete).

    ``method="auto"`` dispatches through the Sec. VIII alpha-beta-gamma
    model — the fused comparison (``tuning.choose_method``) for
    one-shot solves, or the sweep-only steady comparison
    (``tuning.choose_serving_method``) when ``hoisted``: a resident
    factor pays phase 1 once at admission, so the inversion term must
    not count against "inv" in the per-solve dispatch.  An unset ``n0``
    is consumed verbatim from the tuner's frozen
    :class:`~repro_torch.core.tuning.TrsmPlan` for "inv"
    (``tune_for_grid`` — or the hoisted-serving argmin ``serving_n0``),
    and set to the Sec. IV-A base-case size for "rec".  ``machine``
    defaults to the H100 preset (``tuning.default_machine``).

    ``structure`` makes the hoisted dispatch and n0 argmin price the
    blocks the level-scheduled sweep executes, and the recursion from
    the structure's fill."""
    from repro_torch.core import tuning
    structure = _normalize_structure(structure)
    _check_method(method, auto=True)
    if method == "auto":
        if hoisted:
            method, h_n0, _ = tuning.choose_serving_method(
                n, k, grid, machine, n0=n0, structure=structure)
            if method == "inv" and n0 is None:
                n0 = h_n0
        else:
            method, _, _ = tuning.choose_method(n, k, grid.p, machine)
    if n0 is None:
        if method == "inv":
            n0 = tuning.serving_n0(n, grid, structure=structure) \
                if hoisted else \
                tuning.tune_for_grid(n, k, grid, machine).n0
        else:
            from repro_torch.core import rec_trsm
            n0 = rec_trsm.default_n0(n, k, grid.p1, grid.p2)
    return method, n0


# ------------------------------- SolveSpec -------------------------------

@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """A frozen, hashable description of one solve configuration — and
    the sole :class:`~repro_torch.core.session.CompiledSolverCache` key.

    * problem — ``n`` (factor order), ``k`` (RHS width; ``None`` marks a
      template spec a :class:`Solver` completes per width),
      ``lower``/``transpose`` (the operator variant, DESIGN.md Sec. 3).
    * plan — ``method`` ("inv" | "rec"; ``"auto"`` is resolved before a
      spec exists, via :meth:`auto`), ``n0`` (diagonal-block size for
      "inv", base-case size for "rec"), ``mode`` (phase-1 scheme),
      ``grid`` (a plan-only grid has no device), ``block_inv``
      (optional diagonal-inverter hook; ``None`` is the hand-written
      kernel).
    * execution — ``policy`` (the full
      :class:`~repro_torch.core.precision.PrecisionPolicy`),
      ``bank_width`` (``None`` = the unbanked one-shot program; M >= 1
      = the program over an M-factor stack) and ``map_mode`` ("vmap" |
      "scan"; ``None`` when unbanked).
    * ``structure`` — the factor's
      :class:`~repro_torch.core.structure.FactorStructure` (DESIGN.md
      Sec. 14); ``None`` and ``FactorStructure.dense()`` are the same
      key.
    * ``overlap`` — "auto"/"on"/True normalize to "on", "off"/False to
      ``None``.
    * ``fixed_order`` — the program forms its trailing updates and
      refinement residuals on the hand-written tri-GEMM, whose sums run
      in an order that does not depend on n, in place of cuBLAS; a
      capacity bank narrower than :data:`FIXED_ORDER_WIDTH` on the card,
      every capacity bank on the CPU and every bank over p > 1 ranks
      set it (:meth:`Solver.spec_for`), so that a padded slot solves as
      the unpadded factor does, bit for bit (and at p > 1 "scan" as
      "vmap").  The port's own field: the
      reference's XLA products need no such choice.
    """
    n: int
    k: int | None
    grid: TrsmGrid
    policy: PrecisionPolicy
    method: str = "inv"
    n0: int | None = None
    mode: str | None = None
    lower: bool = True
    transpose: bool = False
    block_inv: Callable | None = None
    bank_width: int | None = None
    map_mode: str | None = None
    structure: FactorStructure | None = None
    overlap: str | bool | None = "auto"
    fixed_order: bool = False

    def __post_init__(self):
        _check_method(self.method)
        if self.fixed_order and self.bank_width is None:
            raise ValueError("fixed_order is a banked program's choice "
                             "(set bank_width)")
        object.__setattr__(self, "overlap",
                           _normalize_overlap(self.overlap))
        if self.bank_width is not None and self.bank_width < 1:
            raise ValueError(f"bank width must be >= 1, got "
                             f"{self.bank_width}")
        if self.bank_width is None:
            object.__setattr__(self, "map_mode", None)
        elif self.map_mode is None:
            object.__setattr__(self, "map_mode", "vmap")
        if self.map_mode not in (None, "vmap", "scan"):
            raise ValueError(f"unknown map_mode {self.map_mode!r}")
        object.__setattr__(self, "structure",
                           _normalize_structure(self.structure))

    @property
    def is_concrete(self) -> bool:
        """True when the spec can key a program: shape and plan resolved,
        grid on a device."""
        return (self.k is not None and self.n0 is not None
                and self.grid is not None and self.grid.device is not None)

    def validate(self) -> "SolveSpec":
        """Check plan feasibility (raises ValueError): n0 must tile the
        factor and, for "inv", respect the cyclic layout
        ((p1*p2) | n0); a structure must fit the factor and its
        operator variant."""
        n0 = self.n0
        if n0 is not None:
            if n0 < 1 or self.n % n0:
                raise ValueError(f"n0={n0} does not tile n={self.n}")
            if self.method == "inv" and self.grid is not None \
                    and n0 % (self.grid.p1 * self.grid.p2):
                raise ValueError(
                    f"n0={n0} infeasible for the cyclic layout on "
                    f"p1={self.grid.p1}, p2={self.grid.p2}")
        if self.structure is not None:
            self.structure.validate_for(self.n, lower=self.lower,
                                        transpose=self.transpose)
        return self

    @classmethod
    def auto(cls, n: int, k: int, *, grid: TrsmGrid | None = None,
             p: int | None = None, method: str = "auto",
             n0: int | None = None, mode: str | None = None,
             lower: bool = True, transpose: bool = False,
             machine=None, precision=None, dtype=None,
             block_inv: Callable | None = None,
             bank_width: int | None = None,
             map_mode: str | None = None,
             hoisted: bool | None = None, structure=None,
             overlap: str | bool | None = "auto") -> "SolveSpec":
        """The a-priori front door: resolve the plan ONCE from the
        Sec. VIII cost model and freeze it into a spec.

        Pass either a ``grid`` (n0/method tuned for it) or a processor
        count ``p`` (the tuner also picks p1/p2; the result carries a
        device-less :func:`plan_grid` and is a plan-only spec).  The
        tuner's frozen :class:`~repro_torch.core.tuning.TrsmPlan` is
        consumed verbatim — same n0, same grid factors.  ``hoisted``
        selects the serving-n0 argmin (defaults to True exactly when
        ``bank_width`` is set, i.e. when phase 1 runs at admission).
        ``machine`` defaults to the H100 preset.  ``precision`` accepts
        a preset name or PrecisionPolicy; ``dtype`` the uniform policy;
        default fp32."""
        from repro_torch.core import tuning
        if hoisted is None:
            hoisted = bank_width is not None
        structure = _normalize_structure(structure)
        if structure is not None:
            structure.validate_for(n, lower=lower, transpose=transpose)
        if grid is None:
            if p is None:
                raise ValueError("SolveSpec.auto needs grid= or p=")
            if method == "auto":
                method, plan, _ = tuning.choose_method(n, k, p, machine)
            else:
                plan = tuning.tune(n, k, p, machine)
            grid = plan_grid(plan.p1, plan.p2)
            if n0 is None and method == "inv" and not hoisted:
                n0 = plan.n0                      # the plan, verbatim
        method, n0 = resolve_plan(grid, n, k, method=method, n0=n0,
                                  machine=machine, hoisted=hoisted,
                                  structure=structure)
        if precision is None and dtype is None:
            dtype = torch.float32
        return cls(n=n, k=k, grid=grid,
                   policy=preclib.resolve(precision, dtype),
                   method=method, n0=n0, mode=mode, lower=lower,
                   transpose=transpose, block_inv=block_inv,
                   bank_width=bank_width, map_mode=map_mode,
                   structure=structure, overlap=overlap).validate()


@dataclasses.dataclass(frozen=True)
class UpdateSpec:
    """A frozen, hashable description of one in-place bank update
    program — the second
    :class:`~repro_torch.core.session.CompiledSolverCache` key type
    (DESIGN.md Sec. 11).

    Where a :class:`SolveSpec` keys the steady-state solve program, an
    UpdateSpec keys the mutation program: the single-factor admission
    pipeline (gather + policy casts + structure mask + phase 1) written
    into the bank's resident (C, ...) stacks.  Every field that changes
    the program is here: the factor order and plan, the policy, the
    operator variant, the stack width C, the ingestion layout
    (``"natural"`` runs the gather, ``"cyclic"`` takes a producer's
    factor and only casts), ``chunk`` (a contiguous run of slots written
    by one call) and ``pad_from`` (an incoming (d, d) factor embedded as
    ``blockdiag(L, I)``, DESIGN.md Sec. 12).  ``overlap`` always
    normalizes to None (admission has no sweep to pipeline), a dense
    structure to None."""
    n: int
    grid: TrsmGrid
    policy: PrecisionPolicy
    method: str
    n0: int | None
    mode: str | None
    lower: bool
    transpose: bool
    block_inv: Callable | None
    bank_width: int              # C — the resident stack width
    ingest: str = "natural"      # "natural" | "cyclic"
    chunk: int = 1               # contiguous slots written per call
    pad_from: int | None = None  # incoming factor order d (< n) or None
    structure: FactorStructure | None = None
    overlap: str | bool | None = None

    def __post_init__(self):
        if self.ingest not in ("natural", "cyclic"):
            raise ValueError(f"unknown ingest {self.ingest!r}")
        _normalize_overlap(self.overlap)       # validate the spelling
        object.__setattr__(self, "overlap", None)
        object.__setattr__(self, "structure",
                           _normalize_structure(self.structure))
        if self.structure is not None:
            self.structure.validate_for(self.n, lower=self.lower,
                                        transpose=self.transpose)
            if self.ingest == "cyclic":
                raise ValueError(
                    "structured banks take natural ingestion only: the "
                    "admission mask is applied in natural layout, "
                    "before distribution")
        if self.bank_width < 1:
            raise ValueError(f"bank width must be >= 1, got "
                             f"{self.bank_width}")
        if not 1 <= self.chunk <= self.bank_width:
            raise ValueError(f"chunk must be in [1, bank_width="
                             f"{self.bank_width}], got {self.chunk}")
        if self.pad_from is not None:
            if not 1 <= self.pad_from < self.n:
                raise ValueError(f"pad_from must be in [1, n={self.n}), "
                                 f"got {self.pad_from}")
            if self.ingest == "cyclic":
                raise ValueError(
                    "pad_from requires natural ingestion (a cyclic "
                    "factor is already in the bucket-order storage "
                    "layout; zero-pad before distribution instead)")


def updater_for(uspec: UpdateSpec, cache=None):
    """Fetch (or build) the in-place
    :class:`~repro_torch.core.session.UpdaterProgram` for an update
    spec — the spec IS the cache key (same LRU as the solve
    programs)."""
    from repro_torch.core import session
    if not isinstance(uspec, UpdateSpec):
        raise TypeError(f"updater_for takes an UpdateSpec, got "
                        f"{type(uspec).__name__}")
    cache = cache if cache is not None else session.default_cache()
    return cache.get(uspec, lambda: session._build_updater(uspec))


def solver_for(spec: SolveSpec, cache=None):
    """Fetch (or build) the :class:`~repro_torch.core.session.SolverProgram`
    for a concrete spec — the spec IS the cache key."""
    from repro_torch.core import session
    if not isinstance(spec, SolveSpec):
        raise TypeError(f"solver_for takes a SolveSpec, got "
                        f"{type(spec).__name__}")
    if not spec.is_concrete:
        raise ValueError(f"spec is not concrete (k={spec.k}, "
                         f"n0={spec.n0}): fill k/n0 and target a device "
                         f"grid first")
    cache = cache if cache is not None else session.default_cache()
    return cache.get(spec, lambda: session._build_solver(spec))


# -------------------------------- Solver --------------------------------

# Capacity banks on the card narrower than this serve with
# ``SolveSpec.fixed_order``.  cuBLAS chooses its kernel, and with it the
# order of its sums, by shape, and at width 1 its products over an
# order-n and an order-d stack sum the common rows in different orders,
# which breaks the padding contract (``FactorBank.admit(pad_to=)``) in
# the last bits.  Wider banks keep cuBLAS: there the two orders measured
# bit-equal on the H100 (widths 2, 4 and 16; PERF.md), and the tri-GEMM
# is several times slower.  On the CPU, torch's fp32 batched product
# sums by shape at every width, so every CPU capacity bank takes the
# fixed order.  So does every bank over p > 1 ranks, capacity or not:
# there a padded and an unpadded bank multiply pieces of other shapes,
# and a bank's "scan" multiplies one factor where "vmap" multiplies the
# stack, and cuBLAS sums each in its own order (a "rec" bank's "scan"
# and "vmap" differed in the last bits on the H100); the exchange
# between ranks, not the product, sets the time there.
FIXED_ORDER_WIDTH = 2


class Solver:
    """ONE serving class for resident triangular factors — any bank
    width, any precision policy (DESIGN.md Sec. 10).

        solver = Solver.from_factor(L, grid, precision="bf16_refine")
        X = solver.solve(B)                   # B: (n, k) -> X: (n, k)

        solver = Solver.from_factors(Ls, grid)      # (M, n, n) stack
        X = solver.solve(Bs)                  # (M, n, k) in one call

    After ``warmup(k)``, ``solve`` on an RHS placed by :meth:`place_rhs`
    builds no program and moves no data between host and device: it
    only queues work on the device.  Programs come from the
    :class:`CompiledSolverCache`, keyed by :meth:`spec_for`."""

    def __init__(self, bank: FactorBank, *, cache=None):
        self.bank = bank
        self.cache = cache if cache is not None else bank.cache

    # ---------------------------- constructors ----------------------------

    @classmethod
    def from_factor(cls, L, grid: TrsmGrid, *, method: str = "inv",
                    n0: int | None = None, mode: str | None = None,
                    lower: bool = True, transpose: bool = False,
                    machine=None, block_inv: Callable | None = None,
                    dtype=None, precision=None, map_mode: str = "vmap",
                    k_hint: int | None = None, structure=None,
                    overlap: str | bool | None = "auto",
                    cache=None) -> "Solver":
        """A width-1 solver around one natural-layout (n, n) factor.
        ``method="auto"`` resolves the algorithm a priori from the cost
        model at ``k_hint`` RHS columns (default n) on ``machine``
        (default the H100 preset).  An unset n0 defaults to the
        hoisted-serving argmin for "inv" (``tuning.serving_n0``: n/2 —
        phase 1 runs at admission) and to the Sec. IV-A base-case size
        for "rec" (n at p = 1).  ``structure`` declares the factor's
        block structure (DESIGN.md Sec. 14): admission masks to it, the
        "inv" sweep skips outside it, the residual reads only its
        blocks, and the n0 argmin prices it."""
        _check_method(method, auto=True)
        L = torch.as_tensor(L)
        if dtype is not None:
            L = L.to(preclib.as_torch_dtype(dtype))
        if L.ndim != 2 or L.shape[0] != L.shape[1]:
            raise ValueError(f"factor must be square, got {tuple(L.shape)}")
        if method == "auto":
            method, n0 = resolve_plan(grid, L.shape[0], k_hint or L.shape[0],
                                      method="auto", n0=n0,
                                      machine=machine, hoisted=True,
                                      structure=structure)
        bank = FactorBank(grid, L.shape[0], method=method, n0=n0,
                          mode=mode, lower=lower, transpose=transpose,
                          block_inv=block_inv,
                          dtype=None if precision is not None else L.dtype,
                          precision=precision, map_mode=map_mode,
                          structure=structure, overlap=overlap,
                          cache=cache)
        bank.admit(L)
        return cls(bank, cache=cache)

    @classmethod
    def from_factors(cls, Ls, grid: TrsmGrid, *, method: str = "inv",
                     n0: int | None = None, mode: str | None = None,
                     lower: bool = True, transpose: bool = False,
                     machine=None, block_inv: Callable | None = None,
                     dtype=None, precision=None, map_mode: str = "vmap",
                     k_hint: int | None = None, structure=None,
                     overlap: str | bool | None = "auto",
                     capacity: int | None = None,
                     cache=None) -> "Solver":
        """A width-M solver over an (M, n, n) natural-layout stack,
        admitted in one batched admission.  ``method="auto"`` resolves
        as in :meth:`from_factor`.  ``capacity=C`` (>= M) makes the bank
        live-mutable at width C: the programs are keyed on C, so later
        ``replace_factor`` / ``evict_factor`` / ``admit_factor`` churn
        never rebuilds one (DESIGN.md Sec. 11)."""
        _check_method(method, auto=True)
        Ls = torch.as_tensor(Ls)
        if dtype is not None:
            Ls = Ls.to(preclib.as_torch_dtype(dtype))
        if Ls.ndim != 3 or Ls.shape[-1] != Ls.shape[-2]:
            raise ValueError(f"factor stack must be (M, n, n), got "
                             f"{tuple(Ls.shape)}")
        n = Ls.shape[-1]
        if method == "auto":
            method, n0 = resolve_plan(grid, n, k_hint or n, method="auto",
                                      n0=n0, machine=machine, hoisted=True,
                                      structure=structure)
        bank = FactorBank(grid, Ls.shape[-1], method=method, n0=n0,
                          mode=mode, lower=lower, transpose=transpose,
                          block_inv=block_inv,
                          dtype=None if precision is not None
                          else Ls.dtype,
                          precision=precision, map_mode=map_mode,
                          capacity=capacity, structure=structure,
                          overlap=overlap, cache=cache)
        bank.admit_stack(Ls)
        return cls(bank, cache=cache)

    @classmethod
    def from_bank(cls, bank: FactorBank, *, cache=None) -> "Solver":
        """Serve an existing (possibly still-growing) FactorBank."""
        return cls(bank, cache=cache)

    @classmethod
    def from_spec(cls, spec: SolveSpec, factors=None, *,
                  capacity: int | None = None, cache=None) -> "Solver":
        """Spec-driven construction: build the admission bank from a
        spec's plan/execution fields and admit ``factors`` (one (n, n)
        factor or an (M, n, n) stack).  When the spec pins a
        ``bank_width`` the bank's width must match it: the spec is the
        cache key.  ``capacity`` (defaulting to the spec's
        ``bank_width`` when ``factors`` is omitted) allocates a
        live-mutable bank at that width, to be filled by
        ``admit_factor`` later — the declarative churn-serving entry
        point."""
        if spec.grid is None or spec.grid.device is None:
            raise ValueError("spec has a plan-only grid; re-target it at "
                             "a device grid (make_trsm_mesh) first")
        spec.validate()
        if capacity is None and factors is None:
            capacity = spec.bank_width
        if capacity is not None and spec.bank_width is not None \
                and capacity != spec.bank_width:
            raise ValueError(
                f"capacity={capacity} contradicts the spec's "
                f"bank_width={spec.bank_width} (the spec is the cache "
                f"key; the capacity IS the program's width)")
        bank = FactorBank(spec.grid, spec.n, method=spec.method,
                          n0=spec.n0, mode=spec.mode, lower=spec.lower,
                          transpose=spec.transpose,
                          block_inv=spec.block_inv, precision=spec.policy,
                          map_mode=spec.map_mode or "vmap",
                          capacity=capacity, structure=spec.structure,
                          overlap=spec.overlap, cache=cache)
        if factors is not None:
            factors = torch.as_tensor(factors)
            if factors.ndim == 3:
                bank.admit_stack(factors)
            else:
                bank.admit(factors)
        if spec.bank_width is not None and bank.width != spec.bank_width:
            raise ValueError(
                f"spec pins bank_width={spec.bank_width} but "
                f"{bank.size} factor(s) were admitted; pass a matching "
                f"stack (or a spec with bank_width=None)")
        return cls(bank, cache=cache)

    # ------------------------------ queries ------------------------------

    @property
    def n(self) -> int:
        return self.bank.n

    @property
    def width(self) -> int:
        """The bank width the program is keyed on: the capacity of a
        capacity bank (free slots ride along as inert lanes), else the
        live factor count."""
        return self.bank.width

    @property
    def occupancy(self) -> int:
        """The number of LIVE resident factors (<= width)."""
        return self.bank.size

    @property
    def grid(self) -> TrsmGrid:
        return self.bank.grid

    @property
    def policy(self) -> PrecisionPolicy:
        return self.bank.policy

    @property
    def dtype(self) -> torch.dtype:
        """I/O dtype: residual dtype when the policy refines, compute
        dtype otherwise."""
        return self.bank.policy.io_dtype

    @property
    def method(self) -> str:
        return self.bank.method

    @property
    def n0(self) -> int | None:
        """The bank's block size; ``None`` for a "rec" bank whose base
        case follows k (:meth:`spec_for`)."""
        return self.bank.n0

    def live_slots(self) -> tuple:
        """The live bank slots, ascending."""
        return self.bank.live_slots()

    def spec_for(self, k: int) -> SolveSpec:
        """The concrete :class:`SolveSpec` (== cache key) serving RHS
        width k at the current bank width."""
        b = self.bank
        n0 = b.n0
        if n0 is None:                       # "rec" with unpinned n0
            from repro_torch.core import rec_trsm
            n0 = rec_trsm.default_n0(b.n, k, b.grid.p1, b.grid.p2)
        return SolveSpec(n=b.n, k=k, grid=b.grid, policy=b.policy,
                         method=b.method, n0=n0, mode=b.mode,
                         lower=b.lower, transpose=b.transpose,
                         block_inv=b.block_inv, bank_width=b.width,
                         map_mode=b.map_mode, structure=b.structure,
                         overlap=b.overlap,
                         fixed_order=b.grid.p > 1 or (
                             b.capacity is not None and (
                                 b.width < FIXED_ORDER_WIDTH
                                 or b.grid.device.type == "cpu")))

    def program_for(self, k: int):
        """The :class:`~repro_torch.core.session.SolverProgram` for RHS
        width k (built and cached on first use)."""
        return solver_for(self.spec_for(k), self.cache)

    # ------------------------------ serving ------------------------------

    def _lift(self, B: torch.Tensor):
        """Normalize an RHS to the (M, n, k) stack form; returns
        (stack, was_2d)."""
        if B.ndim == 2:
            if self.width != 1:
                raise ValueError(
                    f"rhs stack must be ({self.width}, {self.n}, k) for "
                    f"a width-{self.width} solver, got {tuple(B.shape)}")
            if B.shape[0] != self.n:
                raise ValueError(f"rhs must be ({self.n}, k), got "
                                 f"{tuple(B.shape)}")
            return B[None], True
        if B.ndim != 3 or B.shape[0] != self.width \
                or B.shape[1] != self.n:
            raise ValueError(f"rhs stack must be ({self.width}, "
                             f"{self.n}, k), got {tuple(B.shape)}")
        return B, False

    def place_rhs(self, B) -> torch.Tensor:
        """Put an RHS — (n, k) at width 1, or an (M, n, k) stack — on the
        program's device at the I/O dtype, in stack form.  A client that
        places requests as they arrive pays the ingestion copy here;
        ``solve`` then moves no data at all."""
        B, _ = self._lift(torch.as_tensor(B).to(self.grid.device,
                                                self.dtype))
        self.program_for(B.shape[-1])
        return B

    def solve(self, B, *, donate: bool = True) -> torch.Tensor:
        """Solve op(L_i) X_i = B_i for every resident factor; X is
        returned in the rank B was given.  ``donate`` is accepted for
        the reference's signature: the sweep never writes the caller's
        B, so it changes nothing."""
        with trace.span("solver.solve"):
            B, squeeze = self._lift(torch.as_tensor(
                B, device=self.grid.device))
            with trace.span("solver.plan"):
                program = self.program_for(B.shape[-1])
            X = program.solve(self.bank.stacks(), B, valid=self.bank.valid)
            return X[0] if squeeze else X

    def warmup(self, k: int) -> "Solver":
        """Build (and run once on zeros) the program for RHS width k at
        the current bank width — its first run builds the kernels and
        uploads the gather indices — so the first real request is served
        at steady-state cost.  A capacity bank can warm up EMPTY: its
        program is keyed on the capacity, so it is the one every later
        occupancy serves."""
        self.solve(torch.zeros((self.width, self.n, k), dtype=self.dtype,
                               device=self.grid.device))
        return self

    # ------------------------- live bank mutation -------------------------

    def admit_factor(self, L) -> int:
        """Admit one natural-layout (n, n) factor; returns its slot.  On
        a capacity bank this fills (and re-uses) free slots in place —
        the program does not change."""
        return self.bank.admit(L)

    def replace_factor(self, slot: int, L) -> int:
        """Refresh live ``slot`` in place through the bank's updater —
        no program is rebuilt (DESIGN.md Sec. 11)."""
        return self.bank.replace(slot, L)

    def evict_factor(self, slot: int) -> None:
        """Free live ``slot`` (capacity banks); its lane goes inert until
        the next ``admit_factor`` re-uses it."""
        self.bank.evict(slot)


# ------------------------------ SolveServer ------------------------------

def _pack_wave(queue: collections.deque, panel_k: int) -> list:
    """First-fit pack one panel's worth of requests off the queue.

    Walks the whole queue in FIFO order and takes EVERY request that
    still fits in the remaining panel width, so a wide request at the
    head does not strand narrow requests behind it.  Skipped requests
    keep their relative order.  Returns the packed [(seq, b), ...]."""
    wave: list = []
    width = 0
    leftover: collections.deque = collections.deque()
    while queue:
        seq, b = queue.popleft()
        if width + b.shape[1] <= panel_k:
            wave.append((seq, b))
            width += b.shape[1]
        else:
            leftover.append((seq, b))
    queue.extend(leftover)
    return wave


class SolveServer:
    """Continuous batching over a :class:`Solver` at any width.

    Solve requests (RHS column blocks of varying width, addressed to a
    bank factor) are first-fit packed into fixed-width (n, panel_k)
    panels, one panel per factor, and every wave is ONE solve covering
    all factors; idle factors ride along as zero panels.  ``drain``
    returns each factor's solutions in its own submit order.

        server = SolveServer(Solver.from_factor(L, grid), panel_k=16)
        server.warmup()
        server.submit(b)
        X, = server.drain()[0]

    On a capacity bank, submits to an inactive (evicted or never
    admitted) slot are refused, and a request whose slot was turned over
    (evicted, even if re-admitted since) after its submit fails at
    ``drain`` with :class:`~repro_torch.core.errors.StrandedRequestError`
    (``cancel`` drops such requests).

    Constructed over a :class:`~repro_torch.core.fleet.SolverFleet`
    instead of a Solver, the server routes submits by ``(tenant,
    order)`` through the fleet's planned buckets (DESIGN.md Sec. 12):
    one lazy inner server per bucket, the RHS zero-padded to the bucket
    order on the device at submit, the solution sliced back to the
    request's true (d, j) at drain:

        server = SolveServer(fleet, panel_k=16)
        server.submit(b, tenant="modelA", tag="layer0")
        outs = server.drain()          # {(tenant, tag): [X, ...]}

    Over p > 1 ranks every rank makes each call (submit, drain, warmup,
    cancel) in the same order with the same arguments; each wave is one
    collective solve, and every rank gets the natural solutions.
    """

    def __init__(self, solver, panel_k: int):
        from repro_torch.core.fleet import SolverFleet
        self.fleet = solver if isinstance(solver, SolverFleet) else None
        self.solver = None if self.fleet is not None else solver
        self.panel_k = panel_k
        if self.fleet is not None:
            # bucket key -> lazy inner server; (bucket key, slot) ->
            # FIFO of (tenant, tag, order) for slicing drained panels
            self._servers: dict = {}
            self._routes: dict = {}
            # what the inner servers of rebuilt buckets served
            self._retired = [0, 0]
        self._queues: dict[int, collections.deque] = {}
        self._seq = 0
        # slot generation at submit, per request: liveness alone cannot
        # tell a request from before an evict + re-admit
        self._req_gen: dict[int, int] = {}
        self._filler = None          # cached (n, panel_k) zeros
        self.requests_served = 0
        self.waves_solved = 0

    @classmethod
    def from_spec(cls, spec: SolveSpec, factors, *, panel_k: int = 16,
                  cache=None, warm: bool = True) -> "SolveServer":
        """Admit ``factors`` under ``spec`` and return a (warmed)
        server."""
        server = cls(Solver.from_spec(spec, factors, cache=cache),
                     panel_k=panel_k)
        return server.warmup() if warm else server

    @property
    def panels_solved(self) -> int:
        """Alias of ``waves_solved`` (a width-1 wave is one panel)."""
        return self.waves_solved

    def _server_for(self, key) -> "SolveServer":
        """The inner server of a bucket, made on first use and again
        when :meth:`SolverFleet.apply_plan` rebuilt the bucket (a
        server of the old bank with requests still queued would serve
        them against it: that raises)."""
        solver = self.fleet.solver(key)
        srv = self._servers.get(key)
        if srv is not None and srv.solver is not solver:
            if srv.pending():
                raise _errors.StrandedRequestError(
                    f"bucket {key[0]} was rebuilt with {srv.pending()} "
                    f"request(s) queued on its old bank; drain before "
                    f"apply_plan")
            self._retired[0] += srv.requests_served
            self._retired[1] += srv.waves_solved
            srv = None
        if srv is None:
            srv = self._servers[key] = SolveServer(solver, self.panel_k)
        return srv

    def _submit_fleet(self, b, tenant, tag) -> None:
        b = torch.as_tensor(b)
        if b.ndim == 1:
            b = b[:, None]
        if b.ndim != 2:
            raise ValueError(f"rhs must be (d, j), got {tuple(b.shape)}")
        h = self.fleet.lookup(tenant if tenant is not None else "default",
                              order=int(b.shape[0]), tag=tag)
        srv = self._server_for(h.bucket)
        b = b.to(srv.solver.grid.device, srv.solver.dtype)
        n_b = h.bucket[0]
        if b.shape[0] < n_b:             # zero rows, made on the device
            b = torch.nn.functional.pad(b, (0, 0, 0, n_b - b.shape[0]))
        srv.submit(b, factor=h.slot)
        self._routes.setdefault((h.bucket, h.slot),
                                collections.deque()) \
            .append((h.tenant, h.tag, h.order))

    def submit(self, b, factor: int = 0, *, tenant: str | None = None,
               tag: object = None) -> None:
        """Enqueue one RHS block — an (n,) vector or (n, j) columns —
        for bank factor ``factor``; it is copied to the device here.
        Submits to an inactive capacity slot are refused: its lane is an
        inert zero panel.

        In fleet mode the request is addressed by ``(tenant, order)``
        (and ``tag`` when the tenant holds several factors of one
        order): the RHS row count is the order, the fleet routes it to
        the planned bucket, and the panel is zero-padded to the bucket
        order (the padded factor's identity tail maps the zero rows to
        exact-zero solution rows)."""
        if self.fleet is not None:
            return self._submit_fleet(b, tenant, tag)
        if tenant is not None or tag is not None:
            raise ValueError("tenant=/tag= addressing needs a fleet "
                             "server (SolveServer(SolverFleet, ...))")
        if not 0 <= factor < self.solver.width:
            raise ValueError(f"unknown factor {factor}; bank holds "
                             f"{self.solver.width}")
        bank = self.solver.bank
        if not bank.is_live(factor):
            raise ValueError(f"inactive slot {factor}: evicted or never "
                             f"admitted (live slots: "
                             f"{list(self.solver.live_slots())})")
        b = torch.as_tensor(b).to(self.solver.grid.device,
                                  self.solver.dtype)
        if b.ndim == 1:
            b = b[:, None]
        if b.ndim != 2 or b.shape[0] != self.solver.n:
            raise ValueError(f"rhs must be ({self.solver.n}, j), "
                             f"got {tuple(b.shape)}")
        if b.shape[1] > self.panel_k:
            raise ValueError(f"request wider than panel: {b.shape[1]} > "
                             f"{self.panel_k}")
        self._queues.setdefault(factor, collections.deque()).append(
            (self._seq, b))
        self._req_gen[self._seq] = bank.slot_generation(factor)
        self._seq += 1

    def pending(self) -> int:
        if self.fleet is not None:
            return sum(s.pending() for s in self._servers.values())
        return sum(len(q) for q in self._queues.values())

    def cancel(self, factor: int) -> int:
        """Drop every queued request for ``factor``; returns how many.
        The recovery path when a slot was evicted with requests pending:
        cancel it, then ``drain`` serves the rest.  A fleet server has
        no flat slot space and refuses."""
        if self.fleet is not None:
            raise ValueError(
                "cancel is slot-addressed; a fleet server has no flat "
                "slot space (drain, or cancel on the bucket's own "
                "server)")
        q = self._queues.pop(factor, None)
        if not q:
            return 0
        for seq, _ in q:
            self._req_gen.pop(seq, None)
        return len(q)

    def _zeros(self) -> torch.Tensor:
        """The all-zero (n, panel_k) panel that idle factors ride along
        as and that completes underfilled panels — built once."""
        if self._filler is None:
            self._filler = torch.zeros(
                (self.solver.n, self.panel_k), dtype=self.solver.dtype,
                device=self.solver.grid.device)
        return self._filler

    def _solve_wave(self, waves: dict) -> dict:
        """Assemble and solve ONE wave: ``{slot: [(seq, b), ...]}`` ->
        ``{slot: [(seq, X), ...]}``, X the request's (n, j) column block
        (a view of the wave's solution)."""
        pk = self.panel_k
        filler = self._zeros()
        panels = []
        for f in range(self.solver.width):
            parts = [b for _, b in waves.get(f, ())]
            w = sum(b.shape[1] for b in parts)
            if w < pk:
                parts.append(filler[:, :pk - w])
            panels.append(torch.cat(parts, dim=1))
        X = self.solver.solve(torch.stack(panels))
        self.waves_solved += 1
        out: dict = {}
        for f, wave in waves.items():
            off, xs = 0, []
            for seq, b in wave:
                j = b.shape[1]
                xs.append((seq, X[f, :, off:off + j]))
                off += j
            out[f] = xs
            self.requests_served += len(wave)
        return out

    def warmup(self) -> "SolveServer":
        if self.fleet is not None:
            self.fleet.warmup(self.panel_k)
            return self
        self.solver.warmup(self.panel_k)
        return self

    def _drain_fleet(self) -> dict:
        results: dict[tuple, list] = {}
        for key, srv in self._servers.items():
            for slot, xs in srv.drain().items():
                route = self._routes.get((key, slot))
                for X in xs:
                    tenant, tag, d = route.popleft()
                    results.setdefault((tenant, tag), []).append(
                        X[:d] if d < X.shape[0] else X)
        self.requests_served = self._retired[0] + sum(
            s.requests_served for s in self._servers.values())
        self.waves_solved = self._retired[1] + sum(
            s.waves_solved for s in self._servers.values())
        return results

    def drain(self) -> dict:
        """Serve all queued requests.  Returns {factor: [X, ...]} for
        every LIVE bank slot (empty list if none were queued; inactive
        capacity slots ride along as the zero panel and are left out),
        each factor's solutions in its own submit order.  Requests whose
        slot was evicted after their submit raise
        :class:`~repro_torch.core.errors.StrandedRequestError`, even if
        the slot was re-admitted since: they would be solved against
        its new occupant.

        In fleet mode: drains every bucket's inner server (one wave per
        bucket, not per order) and returns ``{(tenant, tag): [X, ...]}``,
        each solution sliced back to its request's true (d, j); the
        padded tail rows are exact zeros and are dropped here."""
        if self.fleet is not None:
            return self._drain_fleet()
        bank = self.solver.bank
        live = self.solver.live_slots()
        live_set = set(live)
        dead = sorted(f for f, q in self._queues.items() if q and (
            f not in live_set
            or any(self._req_gen[seq] != bank.slot_generation(f)
                   for seq, _ in q)))
        if dead:
            raise _errors.StrandedRequestError(
                f"pending requests for slot(s) {dead} evicted after "
                f"submission; drain before evicting a slot, or "
                f"cancel(factor) to drop the stranded requests")
        results: dict[int, dict] = {f: {} for f in live}
        while self.pending():
            waves = {f: _pack_wave(q, self.panel_k)
                     for f, q in self._queues.items() if q}
            for f, xs in self._solve_wave(waves).items():
                for seq, x in xs:
                    results[f][seq] = x
                    self._req_gen.pop(seq, None)
        return {f: [res[s] for s in sorted(res)]
                for f, res in results.items()}
