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
* :class:`SolveServer` — continuous batching: per-factor request
  queues, first-fit packed fixed-width panels, one solve per wave
  covering every factor, submit-order results.

Not ported yet: live bank mutation (ROADMAP A7), grids with p > 1
(A12) and fleets (A11).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from repro_torch.core import precision as preclib
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

    def __post_init__(self):
        _check_method(self.method)
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
                     cache=None) -> "Solver":
        """A width-M solver over an (M, n, n) natural-layout stack,
        admitted in one batched admission.  ``method="auto"`` resolves
        as in :meth:`from_factor`."""
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
                          structure=structure, overlap=overlap,
                          cache=cache)
        bank.admit_stack(Ls)
        return cls(bank, cache=cache)

    @classmethod
    def from_bank(cls, bank: FactorBank, *, cache=None) -> "Solver":
        """Serve an existing (possibly still-growing) FactorBank."""
        return cls(bank, cache=cache)

    @classmethod
    def from_spec(cls, spec: SolveSpec, factors, *, cache=None) -> "Solver":
        """Spec-driven construction: build the admission bank from a
        spec's plan/execution fields and admit ``factors`` (one (n, n)
        factor or an (M, n, n) stack).  When the spec pins a
        ``bank_width`` the admitted factor count must match it."""
        spec.validate()
        bank = FactorBank(spec.grid, spec.n, method=spec.method,
                          n0=spec.n0, mode=spec.mode, lower=spec.lower,
                          transpose=spec.transpose,
                          block_inv=spec.block_inv, precision=spec.policy,
                          map_mode=spec.map_mode or "vmap",
                          structure=spec.structure, overlap=spec.overlap,
                          cache=cache)
        factors = torch.as_tensor(factors)
        if factors.ndim == 3:
            bank.admit_stack(factors)
        else:
            bank.admit(factors)
        if spec.bank_width is not None and bank.width != spec.bank_width:
            raise ValueError(
                f"spec pins bank_width={spec.bank_width} but "
                f"{bank.size} factor(s) were admitted")
        return cls(bank, cache=cache)

    # ------------------------------ queries ------------------------------

    @property
    def n(self) -> int:
        return self.bank.n

    @property
    def width(self) -> int:
        """The bank width the program is keyed on."""
        return self.bank.width

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
                         overlap=b.overlap)

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
        B, squeeze = self._lift(torch.as_tensor(B,
                                                device=self.grid.device))
        X = self.program_for(B.shape[-1]).solve(self.bank.stacks(), B)
        return X[0] if squeeze else X

    def warmup(self, k: int) -> "Solver":
        """Build (and run once on zeros) the program for RHS width k at
        the current bank width — its first run builds the kernels and
        uploads the gather indices — so the first real request is served
        at steady-state cost."""
        self.solve(torch.zeros((self.width, self.n, k), dtype=self.dtype,
                               device=self.grid.device))
        return self


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

    Append-only banks never turn a slot over, so no request can be
    stranded by an eviction here."""

    def __init__(self, solver: Solver, panel_k: int):
        self.solver = solver
        self.panel_k = panel_k
        self._queues: dict[int, collections.deque] = {}
        self._seq = 0
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

    def submit(self, b, factor: int = 0) -> None:
        """Enqueue one RHS block — an (n,) vector or (n, j) columns —
        for bank factor ``factor``; it is copied to the device here."""
        if not 0 <= factor < self.solver.width:
            raise ValueError(f"unknown factor {factor}; bank holds "
                             f"{self.solver.width}")
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
        self._seq += 1

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

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
        self.solver.warmup(self.panel_k)
        return self

    def drain(self) -> dict:
        """Serve all queued requests.  Returns {factor: [X, ...]} for
        every bank slot (empty list if none were queued), each factor's
        solutions in its own submit order."""
        results: dict[int, dict] = {f: {} for f in
                                    self.solver.live_slots()}
        while self.pending():
            waves = {f: _pack_wave(q, self.panel_k)
                     for f, q in self._queues.items() if q}
            for f, xs in self._solve_wave(waves).items():
                for seq, x in xs:
                    results[f][seq] = x
        return {f: [res[s] for s in sorted(res)]
                for f, res in results.items()}
