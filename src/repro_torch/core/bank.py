"""FactorBank: the admission layer of the solve stack (DESIGN.md Secs. 9,
11).

A device-resident pool of M same-order triangular factors held as
stacked tensors, one per role: the storage-dtype factor ``L_lo``, for
method "inv" its inverted diagonal blocks ``Dt`` (phase 1, the paper's
Diagonal-Inverter, run ONCE at admission since the factor is
immutable), and, when the precision policy refines, the residual-dtype
factor ``L_hi``.  A "rec" bank holds ``(L_lo[, L_hi])``: the recursion
has no phase 1.  Admission folds the operator reduction (upper /
transpose) into one gather and casts once; the steady state is the
sweep (or the recursion) alone against the resident stacks.  A
width-1 bank is the single-factor case.  A structured bank (DESIGN.md
Sec. 14) masks both resident copies to its structure at its n0.

**Live mutation** (DESIGN.md Sec. 11): a bank built with
``capacity=C`` allocates zero-filled (C, ...) stacks up front and a
device int32 liveness vector of width C.  ``admit`` fills the lowest
free slot, ``replace``/``replace_cyclic``/``replace_run`` refresh live
slots, and ``evict`` frees one, all in place through the bank's
updater (``session._build_updater``, keyed by an
:class:`~repro_torch.core.solver.UpdateSpec`).  The programs are keyed
on C, not on occupancy, so churn never rebuilds one.  ``evict`` and
``admit`` write the liveness entry with a device fill: neither syncs
nor uploads.  A "rec" program hands the liveness vector to every base
case (kernel B6), so an empty or evicted lane solves to zeros without
reading its factor; an "inv" lane of an empty slot solves to zeros
against its zero Dt.

**Over p > 1 ranks** (one process per rank, ``make_trsm_mesh`` inside
a ``torch.distributed`` world) each rank holds its own pieces of every
resident role: L_lo and L_hi (C, n/p1, n/(p1 p2)), Dt (C, m, n0/p1,
n0/p1) (phase 1's transposed faces).  Admission and replacement run
phase 1, which is collective: every rank calls ``admit``,
``admit_stack``, ``admit_cyclic``, ``replace``, ``replace_run`` and
``replace_cyclic`` in the same order with the same factor, and keeps
its own pieces.  ``evict`` and the liveness bookkeeping are local and
the same in every rank.  A structured bank masks the natural factor to
its structure before the pieces are cut.  ``admit_cyclic`` and
``replace_cyclic`` take either the whole cyclic-layout factor (every
rank the same) or this rank's own piece of it, as a multi-rank
``cholesky_cyclic`` or ``lu_cyclic`` returns it.
"""

from __future__ import annotations

import bisect
import warnings
from typing import Callable

import torch

from repro_torch.core import precision as preclib
from repro_torch.core import session as sessionlib
from repro_torch.core import stream
from repro_torch.core.grid import TrsmGrid, cyclic_piece
from repro_torch.core.session import CompiledSolverCache

_CYCLIC_OPERATOR = (
    "cyclic ingestion requires lower=True, transpose=False (the "
    "reversal/transpose reductions are folded into the natural-layout "
    "distribution gather; a pre-permuted factor cannot carry them)")


class FactorBank:
    """A device-resident pool of M triangular factors, ready for batched
    solves.

        bank = FactorBank(grid, n=256, n0=32, precision="bf16_refine")
        for L in per_layer_factors:        # natural-layout (n, n)
            bank.admit(L)
        X = Solver.from_bank(bank).solve(B_stack)   # (M, n, k)

    All factors share one operator configuration (method, n0, lower,
    transpose, precision); "auto" is k-dependent, so a bank takes "inv"
    or "rec" and ``Solver.from_factor`` resolves "auto" before it.
    ``dtype`` / ``precision`` take a preset name or a PrecisionPolicy;
    default fp32 uniform.  ``block_inv=None`` inverts the diagonal
    blocks with the hand-written kernel
    (``kernels.ops.block_inv_kernel``).

    ``capacity=C`` makes the bank live-mutable at width C (zero-filled
    slots solve to zeros — they never contaminate live lanes); without
    it the bank is append-only (width == size grows per admission)."""

    # the p > 1 AsyncSolveServer that leads this bank itself (plain mode)
    _own_relay = None
    # (weak reference to the SolverFleet, bucket key) while a fleet
    # holds this bank as one of its buckets
    _fleet = None

    @property
    def _relay(self):
        """The p > 1 AsyncSolveServer leading this bank (core.stream):
        the one that leads it itself, else, while the bank is still a
        bucket of a fleet (not closed or rebuilt by ``apply_plan``), the
        server leading that fleet, read at call time."""
        if self._own_relay is not None or self._fleet is None:
            return self._own_relay
        ref, key = self._fleet
        fleet = ref()
        b = fleet._buckets.get(key) if fleet is not None else None
        return fleet._relay if b is not None and b.bank is self else None

    @_relay.setter
    def _relay(self, server) -> None:
        self._own_relay = server

    def __init__(self, grid: TrsmGrid, n: int, *, method: str = "inv",
                 n0: int | None = None, mode: str | None = None,
                 lower: bool = True, transpose: bool = False,
                 block_inv: Callable | None = None,
                 dtype=None, precision=None, map_mode: str = "vmap",
                 capacity: int | None = None, structure=None,
                 overlap="auto",
                 cache: CompiledSolverCache | None = None):
        from repro_torch.core import solver as solverlib
        from repro_torch.core import tuning
        if precision is None and dtype is None:
            dtype = torch.float32
        self.policy = preclib.resolve(precision, dtype)
        if map_mode not in ("vmap", "scan"):
            raise ValueError(f"unknown map_mode {map_mode!r}")
        solverlib._check_method(method)
        if grid.device is None:
            raise ValueError("a plan-only grid (plan_grid) has no device: "
                             "build banks on make_trsm_mesh")
        self.structure = solverlib._normalize_structure(structure)
        if grid.p > 1 and self.structure is not None and method == "rec" \
                and n0 is None:
            # rec's base case follows k at p > 1, and the admission mask
            # and the residual's (B4) must use one block size
            raise ValueError("a structured 'rec' bank over p > 1 ranks "
                             "needs n0: its admission mask and its "
                             "residual's block mask use that block size "
                             "(a fleet's 'rec' bucket gets no n0 from "
                             "its plan; the reference's structured 'rec' "
                             "bank with n0 unset fails at admission too)")
        if self.structure is not None:
            self.structure.validate_for(n, lower=lower,
                                        transpose=transpose)
        self.overlap = solverlib._normalize_overlap(overlap)
        self.grid = grid
        self.n = n
        self.method = method
        self.mode = mode
        self.lower = lower
        self.transpose = transpose
        self.block_inv = block_inv
        self.map_mode = map_mode
        self.cache = cache if cache is not None \
            else sessionlib.default_cache()
        if method == "inv":
            # n0 is pinned at construction (admission pre-inverts the
            # diagonal blocks, so every program over this bank agrees
            # on the block size); default: the hoisted-serving argmin,
            # which prices the structure's skipped blocks
            self.n0 = n0 if n0 is not None else tuning.serving_n0(
                n, grid, structure=self.structure)
            if self.n0 < 1 or n % self.n0 \
                    or self.n0 % (grid.p1 * grid.p2):
                raise ValueError(f"n0={self.n0} infeasible for n={n} on "
                                 f"p1={grid.p1}, p2={grid.p2}")
            from repro_torch.core import inv_trsm
            self._phase1_mode = mode or inv_trsm.pick_phase1_mode(
                n, self.n0, grid)
        else:
            # "rec": None follows k (Solver.spec_for -> default_n0)
            if n0 is not None and (n0 < 1 or n % n0):
                raise ValueError(f"n0={n0} does not tile n={n}")
            self.n0 = n0
            self._phase1_mode = None
        # admitted chunks (tuples of per-role stacks), fused lazily by
        # stacks() into one (width, ...) stack per role; a capacity bank
        # has no chunks: its stacks are allocated here and written in
        # place
        self._chunks: list[tuple] = []
        self._size = 0
        self._stacks: tuple | None = None
        self._updaters: dict[tuple, object] = {}
        self.updates_dispatched = 0        # updater calls
        self.capacity = capacity
        self._live = self._gens = self._free = self.valid = None
        if capacity is not None:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            self._live = [False] * capacity
            self._gens = [0] * capacity             # bumped per evict
            self._free = list(range(capacity))      # sorted, min first
            self._stacks = self._alloc_stacks()
            # the liveness operand of every "rec" program over this bank
            self.valid = torch.zeros(capacity, dtype=torch.int32,
                                     device=grid.device)

    # ------------------------------ slots ------------------------------

    @property
    def size(self) -> int:
        """M — the number of LIVE resident factors (occupancy)."""
        return self._size

    @property
    def width(self) -> int:
        """The stack width the programs are keyed on: ``capacity`` for a
        capacity bank (occupancy never re-keys), else the live size."""
        return self.capacity if self.capacity is not None else self._size

    def is_live(self, slot: int) -> bool:
        """Whether ``slot`` holds an admitted factor."""
        if self.capacity is None:
            return 0 <= slot < self._size
        return 0 <= slot < self.capacity and self._live[slot]

    def live_slots(self) -> tuple:
        """The live slot indices, ascending."""
        if self.capacity is None:
            return tuple(range(self._size))
        return tuple(i for i, live in enumerate(self._live) if live)

    def slot_generation(self, slot: int) -> int:
        """How many times ``slot`` has been turned over (evicted).  A
        server records it at submit, so a request is never served
        against a factor admitted after its slot was evicted;
        ``replace`` does not bump it (refreshing a live factor in place
        is the intended serving semantic).  Always 0 for append-only
        banks."""
        return 0 if self.capacity is None else self._gens[slot]

    def _roles(self) -> list:
        """(shape, dtype) per resident role: L_lo[, Dt][, L_hi], this
        rank's pieces at p > 1: (n/p1, n/(p1 p2)) factors and (m,
        n0/p1, n0/p1) faces."""
        pol = self.policy
        p1, p2 = self.grid.p1, self.grid.p2
        piece = (self.n // p1, self.n // (p1 * p2))
        roles = [(piece, pol.storage)]
        if self.method == "inv":
            from repro_torch.core import inv_trsm
            m, n0, _ = inv_trsm.dt_shape(self.n, self.n0)
            roles.append(((m, n0 // p1, n0 // p1), pol.storage))
        if pol.refines:
            roles.append((piece, pol.residual))
        return roles

    def _alloc_stacks(self) -> tuple:
        """The zero-filled (C, ...) resident stacks: a zero factor's
        "inv" lane solves to zeros, and a "rec" program gates its lane
        off through the liveness vector."""
        return tuple(torch.zeros((self.capacity,) + shape, dtype=dt,
                                 device=self.grid.device)
                     for shape, dt in self._roles())

    def _check_square(self, L, ndim: int, order: int | None = None) -> None:
        d = self.n if order is None else order
        if L.ndim != ndim or tuple(L.shape[-2:]) != (d, d):
            lead = "(M, " if ndim == 3 else "("
            raise ValueError(f"factor must be {lead}{d}, {d}), "
                             f"got {tuple(L.shape)}")

    def _check_cyclic_operator(self) -> None:
        if not self.lower or self.transpose:
            raise ValueError(_CYCLIC_OPERATOR)

    def _resolve_pad(self, L, pad_to: int | None) -> int | None:
        """Normalize a padded-admission request: ``pad_to`` must name
        this bank's order, the incoming factor a (d, d) with d <= n.
        Returns the UpdateSpec's ``pad_from`` (None when d == n)."""
        if pad_to is None:
            return None
        if pad_to != self.n:
            raise ValueError(f"pad_to={pad_to} must equal the bank's "
                             f"order n={self.n} (route to the right "
                             f"bucket first)")
        if self.capacity is None:
            raise ValueError(
                "padded admission requires a capacity-allocated bank "
                "(FactorBank(..., capacity=C)): padding runs inside the "
                "updater")
        d = int(L.shape[-1])
        if tuple(L.shape[-2:]) != (d, d) or not 1 <= d <= self.n:
            raise ValueError(f"padded factor must be (d, d) with "
                             f"1 <= d <= {self.n}, got {tuple(L.shape)}")
        return None if d == self.n else d

    # ------------------------------ admission ------------------------------

    def _phase1(self, L_lo: torch.Tensor) -> torch.Tensor:
        """Admission-time phase 1: invert the factors' diagonal blocks
        ONCE, so the steady-state program is the sweep alone."""
        ph1 = sessionlib._build_phase1(
            self.grid, self.n, self.n0, self._phase1_mode,
            self.policy.accumulate, self.block_inv)
        return ph1(L_lo)

    def _entry(self, parts: tuple) -> tuple:
        """(L_lo[, L_hi]) stacks -> the resident (L_lo[, Dt][, L_hi])."""
        if self.method != "inv":
            return parts
        return (parts[0], self._phase1(parts[0])) + parts[1:]

    def _prepare(self, Ls: torch.Tensor) -> tuple:
        """The resident roles of a natural-layout (M, n, n) stack, the
        structure enforced (``session._admission_preps``)."""
        preps = sessionlib._admission_preps(
            self.grid, self.n, self.n0, self.lower, self.transpose,
            self.policy, self.structure)
        return self._entry(tuple(p(Ls) for p in preps))

    def _natural(self, L, ndim: int, pad_to: int | None) -> tuple:
        """A natural-layout factor (``ndim`` 2) or stack (3) as admit and
        replace take it with ``pad_to``: the tensor and the UpdateSpec's
        ``pad_from``; raises ``ValueError`` otherwise."""
        L = torch.as_tensor(L)
        pad_from = self._resolve_pad(L, pad_to)
        self._check_square(L, ndim, order=pad_from)
        return L, pad_from

    def check_factor(self, L, *, pad_to: int | None = None) -> None:
        """Raise ``ValueError`` unless :meth:`admit` and :meth:`replace`
        take the natural-layout factor ``L`` with ``pad_to`` (its shape
        and padding; no slot is checked)."""
        self._natural(L, 2, pad_to)

    def _check_admit(self, L, *, pad_to: int | None = None) -> tuple:
        L, pad_from = self._natural(L, 2, pad_to)
        if self.capacity is not None and not self._free:
            raise ValueError(
                f"bank full: all {self.capacity} capacity slots are "
                f"live (evict one before admitting)")
        return L, pad_from

    @stream.mutation(check="_check_admit")
    def admit(self, L, *, pad_to: int | None = None) -> int:
        """Admit one natural-layout (n, n) factor (gather with the
        operator reduction folded in, policy casts, diagonal blocks
        pre-inverted); returns its slot.  A capacity bank fills its
        lowest free slot (re-using evicted slots) through its updater;
        an append-only bank grows by one.

        ``pad_to=n`` admits a smaller (d, d) factor into this bank's
        order as ``blockdiag(L, I)``: the tail solves to exact zeros and
        the leading d x k block of a solve is an unpadded order-d
        solve's at the same n0 (DESIGN.md Sec. 12).  Capacity banks
        only.  At p > 1 collective: every rank admits the same factor."""
        L, pad_from = self._check_admit(L, pad_to=pad_to)
        if self.capacity is not None:
            return self._admit_slot(L, "natural", pad_from=pad_from)
        self._chunks.append(self._prepare(L[None]))
        self._size += 1
        return self.size - 1

    def _check_admit_stack(self, Ls) -> torch.Tensor:
        Ls = torch.as_tensor(Ls)
        self._check_square(Ls, 3)
        M = Ls.shape[0]
        if self.capacity is not None and M > len(self._free):
            raise ValueError(
                f"bank full: {M} factors for {len(self._free)} free "
                f"slot(s) of capacity {self.capacity} (evict first)")
        return Ls

    @stream.mutation(check="_check_admit_stack")
    def admit_stack(self, Ls):
        """Admit a natural-layout (M, n, n) stack; returns the admitted
        slots (a range for an append-only bank, a list for a capacity
        bank, whose free slots may not be contiguous).  An append-only
        bank, and an EMPTY capacity bank filled to exactly C, admit the
        stack in one batched admission (whose output is the resident
        stack); a partly filled capacity bank admits slot by slot.  At
        p > 1 collective: every rank admits the same stack."""
        Ls = self._check_admit_stack(Ls)
        M = Ls.shape[0]
        if self.capacity is None:
            first = self.size
            self._chunks.append(self._prepare(Ls))
            self._size += M
            return range(first, self.size)
        if self._size == 0 and M == self.capacity:
            self._stacks = None            # free the zero stacks first
            self._stacks = self._prepare(Ls)
            self.valid.fill_(1)
            self._live = [True] * M
            self._free = []
            self._size = M
            return list(range(M))
        return [self.admit(Ls[j]) for j in range(M)]

    def _check_cyclic(self, L_cyc) -> None:
        """A cyclic factor: the whole (n, n) cyclic-layout matrix or, at
        p > 1, this rank's (n/p1, n/(p1 p2)) piece of it."""
        p1, p2 = self.grid.p1, self.grid.p2
        piece = (self.n // p1, self.n // (p1 * p2))
        if self.grid.p > 1 and L_cyc.ndim == 2 \
                and tuple(L_cyc.shape) == piece:
            return
        self._check_square(L_cyc, 2)

    @stream.mutation(streamable=False)
    def admit_cyclic(self, L_cyc) -> int:
        """Admit a factor ALREADY in the cyclic storage the producers
        emit (``cholesky_cyclic`` / ``lu_cyclic``): only the policy's
        casts (and phase 1) run.  At p = 1 cyclic storage is the natural
        layout.  At p > 1 (collective) every rank passes either the
        whole cyclic-layout factor (``grid.to_cyclic_matrix(L, p1, p1
        p2)``, the same on every rank) and keeps its own piece
        (``grid.cyclic_piece``), or its own (n/p1, n/(p1 p2)) piece, as
        a multi-rank ``cholesky_cyclic`` returns it, which is only cast
        and moved to the device.  Only for lower=True, transpose=False,
        and never into a structured bank (its mask is applied in
        natural layout)."""
        self._check_cyclic_operator()
        if self.structure is not None:
            raise ValueError(
                "cyclic ingestion into a structured bank is not "
                "supported: the admission-time block mask is applied "
                "in natural layout, before distribution (mask the "
                "factor yourself and use natural admission)")
        L_cyc = torch.as_tensor(L_cyc)
        self._check_cyclic(L_cyc)
        if self.capacity is not None:
            return self._admit_slot(L_cyc, "cyclic")
        dts = (self.policy.storage,) + ((self.policy.residual,)
                                        if self.policy.refines else ())
        self._chunks.append(self._entry(tuple(
            cyclic_piece(L_cyc, self.grid, dtype=dt, n=self.n)[None]
            for dt in dts)))
        self._size += 1
        return self.size - 1

    # ----------------------- live mutation (Sec. 11) -----------------------

    def _alloc_slot(self) -> int:
        if not self._free:
            raise ValueError(
                f"bank full: all {self.capacity} capacity slots are "
                f"live (evict one before admitting)")
        return self._free.pop(0)                   # lowest free slot

    def _admit_slot(self, L, ingest: str, pad_from: int | None = None) -> int:
        """Fill the lowest free slot through the updater.  The slot is
        committed only once the update succeeds: a failed build or
        launch puts it back on the free list."""
        slot = self._alloc_slot()
        try:
            self._scatter(slot, L, ingest, pad_from=pad_from)
        except BaseException:
            bisect.insort(self._free, slot)
            raise
        self._live[slot] = True
        self.valid.narrow(0, slot, 1).fill_(1)
        self._size += 1
        return slot

    def _check_live(self, slot: int) -> None:
        if not 0 <= slot < self.width:
            raise ValueError(f"slot {slot} out of range for a "
                             f"width-{self.width} bank")
        if not self.is_live(slot):
            raise ValueError(f"slot {slot} is not live (evicted or "
                             f"never admitted); use admit to fill it")

    def update_spec(self, ingest: str = "natural", *, chunk: int = 1,
                    pad_from: int | None = None):
        """The frozen :class:`~repro_torch.core.solver.UpdateSpec`
        keying this bank's updater (its cache and BUILD_COUNTS key)."""
        from repro_torch.core import solver as solverlib
        if self.width < 1:
            raise ValueError("empty bank: admit factors before updating")
        return solverlib.UpdateSpec(
            n=self.n, grid=self.grid, policy=self.policy,
            method=self.method, n0=self.n0, mode=self._phase1_mode,
            lower=self.lower, transpose=self.transpose,
            block_inv=self.block_inv, bank_width=self.width,
            ingest=ingest, chunk=chunk, pad_from=pad_from,
            structure=self.structure)

    def _scatter(self, slot: int, L, ingest: str, *, chunk: int = 1,
                 pad_from: int | None = None) -> None:
        """Run the updater: the admission pipeline for one factor (or a
        run of ``chunk``) written into the resident stacks in place.
        The program is memoized on the bank per (ingest, width, chunk,
        pad_from), so an update pays one dict probe, not an UpdateSpec
        hash (the width is in the memo for append-only banks, whose
        stacks grow)."""
        from repro_torch.core import solver as solverlib
        memo = (ingest, self.width, chunk, pad_from)
        prog = self._updaters.get(memo)
        if prog is None:
            prog = solverlib.updater_for(
                self.update_spec(ingest, chunk=chunk, pad_from=pad_from),
                self.cache)
            self._updaters[memo] = prog
        prog.update(self.stacks(), slot, L)
        self.updates_dispatched += 1

    def place_factor(self, L) -> torch.Tensor:
        """Put a natural-layout replacement factor on the bank's device,
        so the ingestion copy is paid here and a following
        :meth:`replace` / :meth:`admit` moves no host data — the
        factor-side analogue of ``Solver.place_rhs``."""
        return torch.as_tensor(L).to(self.grid.device)

    def _check_replace(self, slot: int, L, *,
                       pad_to: int | None = None) -> tuple:
        L, pad_from = self._natural(L, 2, pad_to)
        self._check_live(slot)
        return L, pad_from

    @stream.mutation(check="_check_replace")
    def replace(self, slot: int, L, *, pad_to: int | None = None) -> int:
        """Refresh live ``slot`` IN PLACE with a new natural-layout
        (n, n) factor — on append-only banks too: the updater re-runs
        the admission pipeline for this factor alone and copies every
        role into the resident stacks.  No program is rebuilt, no
        occupancy changes.  ``pad_to=n`` takes a smaller (d, d) factor
        as :meth:`admit` does.  Returns the slot.  At p > 1 collective:
        every rank replaces the same slot with the same factor."""
        L, pad_from = self._check_replace(slot, L, pad_to=pad_to)
        self._scatter(slot, L, "natural", pad_from=pad_from)
        return slot

    def _check_replace_run(self, start: int, Ls, *,
                           pad_to: int | None = None) -> tuple:
        if self.capacity is None:
            raise ValueError(
                "replace_run requires a capacity-allocated bank "
                "(FactorBank(..., capacity=C))")
        Ls, pad_from = self._natural(Ls, 3, pad_to)
        if int(Ls.shape[0]) < 1:
            raise ValueError("replace_run needs at least one factor")
        for slot in range(start, start + int(Ls.shape[0])):
            self._check_live(slot)
        return Ls, pad_from

    @stream.mutation(check="_check_replace_run")
    def replace_run(self, start: int, Ls, *, pad_to: int | None = None
                    ) -> range:
        """Refresh the CONTIGUOUS run of live slots ``start .. start +
        u - 1`` with a (u, d, d) stack in ONE updater call
        (``UpdateSpec.chunk = u``): one batched admission, one copy per
        role.  Capacity banks only.  Returns the refreshed slots.  At
        p > 1 collective, as :meth:`replace`."""
        Ls, pad_from = self._check_replace_run(start, Ls, pad_to=pad_to)
        u = int(Ls.shape[0])
        if u == 1:
            self._scatter(start, Ls[0], "natural", pad_from=pad_from)
        else:
            self._scatter(start, Ls, "natural", chunk=u, pad_from=pad_from)
        return range(start, start + u)

    @stream.mutation(streamable=False)
    def replace_cyclic(self, slot: int, L_cyc) -> int:
        """:meth:`replace` for a factor already in cyclic storage: casts
        (and phase 1) only.  Same restriction as :meth:`admit_cyclic`,
        and at p > 1 collective as it is."""
        self._check_cyclic_operator()
        L_cyc = torch.as_tensor(L_cyc)
        self._check_cyclic(L_cyc)
        self._check_live(slot)
        self._scatter(slot, L_cyc, "cyclic")
        return slot

    def _check_evict(self, slot: int) -> None:
        if self.capacity is None:
            raise ValueError(
                "evict requires a capacity-allocated bank "
                "(FactorBank(..., capacity=C)); append-only banks have "
                "no free slots")
        self._check_live(slot)

    @stream.mutation(check="_check_evict")
    def evict(self, slot: int) -> None:
        """Return live ``slot`` to the free list (capacity banks only).
        Its stale data stays resident: a server gives its lane a zero
        panel, the liveness vector gates it off the "rec" base cases,
        and the next ``admit`` overwrites it in place.  Local: no
        collective runs (at p > 1 every rank evicts the same slot)."""
        self._check_evict(slot)
        self._live[slot] = False
        self._gens[slot] += 1
        self.valid.narrow(0, slot, 1).fill_(0)
        bisect.insort(self._free, int(slot))
        self._size -= 1

    # ------------------------------- storage -------------------------------

    def stacks(self) -> tuple:
        """The resident stacks — one (width, ...) tensor per role (sweep
        factor[, inverted diagonal blocks][, residual-dtype factor]).
        A capacity bank returns its allocated stacks (even empty, so a
        server can warm up before any factor exists); an append-only
        bank fuses the chunks admitted since the last call."""
        if self._stacks is None and not self._chunks:
            raise ValueError("empty bank: admit factors before solving")
        if self._chunks:
            parts = ([self._stacks] if self._stacks is not None else []) \
                + self._chunks
            self._stacks = parts[0] if len(parts) == 1 else tuple(
                torch.cat([c[r] for c in parts])
                for r in range(len(parts[0])))
            self._chunks = []
        return self._stacks

    @property
    def factors_cyclic(self) -> torch.Tensor:
        """The storage-dtype (M, n, n) stacked cyclic factor."""
        return self.stacks()[0]

    @property
    def factors_cyclic_residual(self) -> torch.Tensor | None:
        """The residual-dtype (M, n, n) stacked copy (None unless the
        policy refines)."""
        return self.stacks()[-1] if self.policy.refines else None


class BatchedTrsmSession:
    """DEPRECATED multi-factor serving session: a thin shim over
    :meth:`repro_torch.core.solver.Solver.from_bank`, kept for source
    compatibility with the reference; results are the Solver's.

        solver = repro_torch.api.Solver.from_bank(bank)
        X = solver.solve(B_stack)
    """

    def __init__(self, bank: FactorBank):
        from repro_torch.core import solver as solverlib
        warnings.warn("BatchedTrsmSession is deprecated; use "
                      "Solver.from_bank", DeprecationWarning, stacklevel=2)
        self._solver = solverlib.Solver.from_bank(bank)

    @property
    def bank(self) -> FactorBank:
        return self._solver.bank

    @property
    def n(self) -> int:
        return self._solver.n

    @property
    def policy(self):
        return self._solver.policy

    @property
    def dtype(self) -> torch.dtype:
        """The I/O dtype (what ``solve`` returns)."""
        return self._solver.dtype

    def program_for(self, k: int):
        return self._solver.program_for(k)

    def place_rhs(self, B) -> torch.Tensor:
        return self._solver.place_rhs(B)

    def solve(self, B, *, donate: bool = True) -> torch.Tensor:
        """Solve op(L_i) X_i = B_i for every slot: strictly the
        (width, n, k) stack form."""
        M = self.bank.width
        if B.ndim != 3 or B.shape[0] != M or B.shape[1] != self.n:
            raise ValueError(f"rhs stack must be ({M}, {self.n}, k), "
                             f"got {tuple(B.shape)}")
        return self._solver.solve(B, donate=donate)

    def warmup(self, k: int) -> "BatchedTrsmSession":
        self._solver.warmup(k)
        return self
