"""Solve programs and the compiled-solver cache.

* :class:`CompiledSolverCache` — an LRU of :class:`SolverProgram`s keyed
  by :class:`repro_torch.core.solver.SolveSpec` (the frozen solve
  description is the SOLE key type, DESIGN.md Sec. 10), with
  single-flight builds.
* :func:`_build_solver` builds the program for a spec: the B row gather
  (upper/transpose reversal folded in), the solve — the It-Inv sweep
  against the resident factor and its hoisted Dt (banked "inv"),
  phase 1 then the sweep (one-shot "inv"), or the recursive TRSM
  ("rec", banked or one-shot) — the inverse gather, and the policy's
  fixed refinement passes (``repro_torch.core.refine``).

PyTorch runs eagerly, so a "program" is a Python function over device
tensors; building it resolves every plan decision once, and its gather
indices are uploaded on its first call, so the steady state issues
device work only — no host sync and no host-to-device copy.
:data:`BUILD_COUNTS` plays the role of the reference's ``TRACE_COUNTS``:
it is bumped once per program build.  Capturing a program as a CUDA
graph is a later step (ROADMAP).

Operator reductions (DESIGN.md Sec. 3), folded into admission-time
gathers so the sweep only ever sees a lower-triangular operand:
    lower, op(L)=L      : Leff = L
    upper, op(U)=U      : Leff = JUJ   (reverse rows+cols), B/X reversed
    lower, op(L)=L^T    : Leff = J L^T J (transpose+reverse), B/X reversed
    upper, op(U)=U^T    : Leff = U^T  (transpose only)
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
from typing import Callable

import torch

from repro_torch.core import grid as gridlib
from repro_torch.core import inv_trsm
from repro_torch.core import refine as refinelib
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.precision import PrecisionPolicy

# Build telemetry: bumped once per program build, so a test can assert
# steady-state solves never rebuild (spec -> count).
BUILD_COUNTS: collections.Counter = collections.Counter()


def _needs_reversal(lower: bool, transpose: bool) -> bool:
    return lower == transpose


@dataclasses.dataclass(frozen=True)
class SolverProgram:
    """The steady-state program for one solve configuration:
    ``solve(factor, B_nat) -> X_nat``.  A banked program (``bank_width``
    set) works over an (M, n, k) stack, where ``factor`` is a bank's
    resident ``(L_lo[, Dt][, L_hi])`` (admission, phase 1 included, is
    the bank's job: ``FactorBank``).  A one-shot program works on one
    (n, k) right-hand side against ``prep(L_nat)``, its own admission
    of one (n, n) factor.  The solve works on its own copy of B, so the
    caller's B is never written."""
    key: object                  # the program's SolveSpec (cache key)
    solve: Callable
    prep: Callable | None = None


class CompiledSolverCache:
    """LRU cache of :class:`SolverProgram`s, keyed by
    :class:`repro_torch.core.solver.SolveSpec` — the sole key type.

    Thread-safe.  Builds are single-flight per key: when two threads
    miss the same spec concurrently, exactly one runs ``build()`` and
    the other waits for the finished program — one miss per build, a
    hit for every waiter."""

    def __init__(self, maxsize: int = 32):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._inflight: dict = {}          # key -> Event of its build
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, build: Callable):
        from repro_torch.core.solver import SolveSpec
        if not isinstance(key, SolveSpec):
            raise TypeError(f"CompiledSolverCache keys are SolveSpec "
                            f"instances, got {type(key).__name__}")
        while True:
            with self._lock:
                if key in self._entries:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return self._entries[key]
                event = self._inflight.get(key)
                if event is None:          # this thread builds it
                    event = threading.Event()
                    self._inflight[key] = event
                    self.misses += 1
                    break
            # another thread is building this key: wait, then re-check
            # (after a failed build a waiter builds it)
            event.wait()
        try:
            value = build()
        except BaseException:
            with self._lock:
                self._inflight.pop(key, None)
            event.set()
            raise
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
            self._inflight.pop(key, None)
        event.set()
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def stats(self) -> dict:
        """Size/hits/misses/evictions plus the derived hit rate."""
        with self._lock:
            total = self.hits + self.misses
            return dict(size=len(self._entries), hits=self.hits,
                        misses=self.misses, evictions=self.evictions,
                        hit_rate=self.hits / total if total else 0.0)


_DEFAULT_CACHE = CompiledSolverCache()


def default_cache() -> CompiledSolverCache:
    """The process-wide program cache used by every solver that does not
    pass an explicit ``cache=``."""
    return _DEFAULT_CACHE


# ------------------------- program construction -------------------------

@functools.lru_cache(maxsize=128)
def _build_prep(grid: TrsmGrid, lower: bool, transpose: bool,
                dtype: torch.dtype):
    """L_nat -> L_cyc admission for one dtype role: a copy on the grid's
    device at ``dtype`` with the operator reduction folded into one
    gather (identity at p = 1 for the lower, non-transposed case), for
    an (M, n, n) stack of factors."""
    p1, p2 = grid.p1, grid.p2
    rev = _needs_reversal(lower, transpose)

    def prep(L):
        A = torch.as_tensor(L)
        out = gridlib.cyclic_matrix_device(
            A.to(grid.device, dtype), p1, p1 * p2, reverse_rows=rev,
            reverse_cols=rev, transpose=transpose)
        # the resident copy never aliases the caller's tensor
        return out.clone() if out.data_ptr() == A.data_ptr() else out

    return prep


def _factor_preps(grid: TrsmGrid, lower: bool, transpose: bool,
                  policy: PrecisionPolicy) -> tuple:
    """The (storage[, residual]) admission programs for a policy."""
    preps = (_build_prep(grid, lower, transpose, policy.storage),)
    if policy.refines:
        preps += (_build_prep(grid, lower, transpose, policy.residual),)
    return preps


@functools.lru_cache(maxsize=128)
def _build_phase1(grid: TrsmGrid, n: int, n0: int, mode: str, accum,
                  block_inv):
    """Phase 1 L_cyc (M, n, n) -> Dt (M, m, n0, n0), shared by bank
    admission and program prep.  ``block_inv=None`` is the port's
    default, the hand-written ``kernels.ops.block_inv_kernel``."""
    from repro_torch.kernels import ops
    if mode != "alltoall":
        raise NotImplementedError(f"phase-1 mode {mode!r} needs p > 1 "
                                  f"(ROADMAP A12)")
    binv = block_inv if block_inv is not None else ops.block_inv_kernel
    return functools.partial(inv_trsm.invert_diag_blocks, n0=n0,
                             block_inv=binv, accum_dtype=accum)


def _build_solver(spec) -> SolverProgram:
    """Build the program for a concrete
    :class:`repro_torch.core.solver.SolveSpec` (which is also the
    program's cache key and :data:`BUILD_COUNTS` key).

    * banked "inv": the sweep alone against the resident (L_lo, Dt);
    * one-shot "inv": phase 1 (the ``tri_inv_blocks`` kernel by
      default) once per call, then the sweep — every refinement pass
      reuses the call's Dt;
    * "rec", banked or one-shot: the recursive TRSM against the
      resident L_lo, its base cases on the ``trsm_substitution``
      kernel."""
    grid = spec.grid
    n, k, n0, policy = spec.n, spec.k, spec.n0, spec.policy
    if grid.device is None:
        raise ValueError("a plan-only grid (plan_grid) cannot run a "
                         "program: build it on make_trsm_mesh")
    p1, p2 = grid.p1, grid.p2
    rev = _needs_reversal(spec.lower, spec.transpose)
    compute, accum = policy.compute, policy.accumulate
    banked = spec.bank_width is not None

    if spec.method == "inv":
        gridlib.check_divisibility(n, k, n0, grid)

        def base_solve(L_pair, B):
            B_cyc = gridlib.cyclic_rows_device(B.to(compute), p1,
                                               reverse=rev)
            X_cyc = inv_trsm.sweep(L_pair[0], L_pair[1], B_cyc, n0=n0,
                                   accum_dtype=accum)
            return gridlib.cyclic_rows_device(X_cyc, p1, inverse=True,
                                              reverse=rev)

        if banked:
            def sweep_factor(factor):        # (L_lo, Dt[, L_hi])
                return factor[:2]
        else:
            mode = spec.mode or inv_trsm.pick_phase1_mode(n, n0, grid)
            ph1 = _build_phase1(grid, n, n0, mode, accum, spec.block_inv)

            def sweep_factor(factor):        # (L_lo[, L_hi])
                return (factor[0], ph1(factor[0]))
    elif spec.method == "rec":
        from repro_torch.core import rec_trsm
        rec = rec_trsm.rec_trsm_sharded(grid, n, k, n0, accum_dtype=accum)

        def base_solve(L_lo, B):
            B_cyc = gridlib.cyclic_matrix_device(
                B.to(compute), p1, p1 * p2, reverse_rows=rev)
            X_cyc = rec(L_lo, B_cyc)
            return gridlib.cyclic_matrix_device(
                X_cyc, p1, p1 * p2, inverse=True, reverse_rows=rev)

        def sweep_factor(factor):            # (L_lo[, L_hi])
            return factor[0]
    else:
        raise ValueError(f"unknown method {spec.method!r}")

    def program(factor, B):
        L_hi = factor[-1] if policy.refines else None
        return refinelib.refined_solve(base_solve, sweep_factor(factor),
                                       L_hi, B, policy=policy, p1=p1,
                                       p2=p2, reverse=rev)

    BUILD_COUNTS[spec] += 1
    if banked:
        return SolverProgram(key=spec, solve=program)
    preps = _factor_preps(grid, spec.lower, spec.transpose, policy)

    def prep(L):
        return tuple(pr(torch.as_tensor(L)[None]) for pr in preps)

    def solve(factor, B):
        B = torch.as_tensor(B, device=grid.device)
        return program(factor, B[None])[0]

    return SolverProgram(key=spec, solve=solve, prep=prep)
