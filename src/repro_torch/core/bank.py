"""FactorBank: the admission layer of the solve stack (DESIGN.md Sec. 9).

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

This bank is append-only.  Capacity allocation, in-place replace,
evict, cyclic ingestion and padded admission are ROADMAP A7.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import precision as preclib
from repro_torch.core import session as sessionlib
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.session import CompiledSolverCache

_A7 = "live-mutable (capacity) banks are ROADMAP A7"


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
    (``kernels.ops.block_inv_kernel``)."""

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
        if capacity is not None:
            raise NotImplementedError(_A7)
        if grid.device is None:
            raise ValueError("a plan-only grid (plan_grid) has no device: "
                             "build banks on make_trsm_mesh")
        self.structure = solverlib._normalize_structure(structure)
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
        # stacks() into one (width, ...) stack per role
        self._chunks: list[tuple] = []
        self._size = 0
        self._stacks: tuple | None = None
        self.capacity = None

    # ------------------------------ admission ------------------------------

    @property
    def size(self) -> int:
        """M — the number of resident factors."""
        return self._size

    @property
    def width(self) -> int:
        """The stack width the programs are keyed on (== size for an
        append-only bank)."""
        return self._size

    def live_slots(self) -> tuple:
        return tuple(range(self._size))

    def _check_square(self, L, ndim: int) -> None:
        if L.ndim != ndim or tuple(L.shape[-2:]) != (self.n, self.n):
            lead = "(M, " if ndim == 3 else "("
            raise ValueError(f"factor must be {lead}{self.n}, {self.n}), "
                             f"got {tuple(L.shape)}")

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

    def _admit(self, Ls: torch.Tensor) -> None:
        # a structure is enforced at the programs' block size: n0, or for
        # a "rec" bank with n0 unset the base case of every k, n at p = 1
        # (rec_trsm.default_n0), where the mask leaves out nothing
        n0 = self.n0 if self.n0 is not None else self.n
        mask = (self.structure, n0) if sessionlib.structured_info(
            self.structure, self.n, n0) else ()
        preps = sessionlib._factor_preps(self.grid, self.lower,
                                         self.transpose, self.policy,
                                         *mask)
        self._chunks.append(self._entry(tuple(p(Ls) for p in preps)))
        self._size += Ls.shape[0]

    def admit(self, L, *, pad_to: int | None = None) -> int:
        """Admit one natural-layout (n, n) factor (gather with the
        operator reduction folded in, policy casts, diagonal blocks
        pre-inverted); returns its slot."""
        if pad_to is not None:
            raise NotImplementedError(f"padded admission: {_A7}")
        L = torch.as_tensor(L)
        self._check_square(L, 2)
        self._admit(L[None])
        return self.size - 1

    def admit_stack(self, Ls) -> range:
        """Admit a natural-layout (M, n, n) stack in one batched
        admission; returns the admitted slots."""
        Ls = torch.as_tensor(Ls)
        self._check_square(Ls, 3)
        first = self.size
        self._admit(Ls)
        return range(first, self.size)

    def admit_cyclic(self, L_cyc) -> int:
        if self.structure is not None:
            raise ValueError(
                "cyclic ingestion into a structured bank is not "
                "supported: the admission-time block mask is applied "
                "in natural layout, before distribution (mask the "
                "factor yourself and use natural admission)")
        raise NotImplementedError(f"cyclic ingestion: {_A7}")

    def replace(self, slot: int, L, *, pad_to: int | None = None) -> int:
        raise NotImplementedError(_A7)

    def evict(self, slot: int) -> None:
        raise NotImplementedError(_A7)

    # ------------------------------- storage -------------------------------

    def stacks(self) -> tuple:
        """The resident stacks — one (width, ...) tensor per role (sweep
        factor[, inverted diagonal blocks][, residual-dtype factor]).
        Admitted chunks are fused on first use after an admission."""
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
