"""Solve and update programs and the compiled-solver cache.

* :class:`CompiledSolverCache` — an LRU of :class:`SolverProgram`s keyed
  by :class:`repro_torch.core.solver.SolveSpec` and of
  :class:`UpdaterProgram`s keyed by
  :class:`repro_torch.core.solver.UpdateSpec` (the two frozen
  descriptions are the only key types, DESIGN.md Secs. 10-11), with
  single-flight builds.
* :func:`_build_solver` builds the program for a spec: the B row gather
  (upper/transpose reversal folded in), the solve — the It-Inv sweep
  against the resident factor and its hoisted Dt (banked "inv"),
  phase 1 then the sweep (one-shot "inv"), or the recursive TRSM
  ("rec", banked or one-shot) — the inverse gather, and the policy's
  fixed refinement passes (``repro_torch.core.refine``).
* A structured spec (DESIGN.md Sec. 14) masks both resident copies of
  the factor at admission, sweeps only the blocks the structure keeps
  ("inv"; the recursion of "rec" is structure-blind, as in the
  reference), and forms each refinement residual with the block-masked
  ``trmm`` kernel.  A structure that leaves out no block at the spec's
  n0 builds the dense program (:func:`structured_info`).
* :func:`_build_updater` builds the in-place updater of a capacity bank
  (DESIGN.md Sec. 11): one factor's (or a contiguous run's) admission
  pipeline — gather with the operator reduction, policy casts,
  structure mask, padding to ``blockdiag(L, I)``, phase 1 for "inv" —
  written into the resident stacks.  The reference's donated scatter
  is a ``copy_`` into ``stack[slot]`` (``stack.narrow(0, start, u)``
  for a run): a Python-int view moves no data and uploads nothing, so
  the device-resident slot ids the reference pins are not needed.  At
  p > 1 every rank runs it on the same factor (phase 1 is collective)
  and writes its own pieces into its own stacks.
* A "rec" program takes a capacity bank's liveness vector as an
  operand (``valid=``), never as a constant captured at build time,
  and hands it to every base case (kernel B6): occupancy changes
  never rebuild a program.
* A padded updater (``UpdateSpec.pad_from``) runs phase 1 on the
  validity-gated inversion kernel (B5) with a mask, built on the device
  once per updater, that flags every diagonal block lying wholly in the
  identity tail; those blocks then get the identity they would invert
  to, so the resident Dt is B1's on the whole padded stack.
* A spec with ``fixed_order`` (a capacity bank's: on the card one
  narrower than ``solver.FIXED_ORDER_WIDTH``) forms its trailing
  updates and refinement residuals with ``ops.gemm``, whose sums run
  in an order that does not depend on n, in place of cuBLAS, whose
  kernel (and order) follows the shape: a padded slot's leading block
  is then the unpadded solve's bit for bit.

* On a grid with p > 1 (:func:`_build_distributed_solver`) every
  program runs in every rank, each call collective: admission cuts
  this rank's cyclic pieces of the natural factor (the operator
  reduction folded into the same two gathers; a cyclic-layout factor
  is sliced) and phase 1 runs through
  ``inv_trsm.invert_diag_blocks_shard``; a solve cuts the right-hand
  side's piece, runs the stacked shard body (``inv_trsm.sweep_shard``
  or ``rec_trsm.rec_trsm_sharded``), returns the natural X on every
  rank and refines with the distributed residual
  (``refine.distributed_operator``).  A padded updater routes the
  block flags with the blocks (B5).  A structured spec masks the
  natural factor before the pieces are cut, sweeps the level schedule
  on local row ranges ("inv"), and forms each refinement residual's
  local product with B4 at block size n0/p1.

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
import contextlib
import dataclasses
import functools
import threading
from typing import Callable

import torch

from repro_torch.core import comm
from repro_torch.core import grid as gridlib
from repro_torch.core import inv_trsm
from repro_torch.core import refine as refinelib
from repro_torch.core import trace
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.structure import analyze, apply_block_mask

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
    caller's B is never written.  A banked program also takes
    ``valid=``, a capacity bank's (M,) device liveness vector: "rec"
    gates every base case with it (dead lanes solve to zeros), "inv"
    has no use for it (an empty slot's zero Dt, or an evicted slot's
    stale one against its zero panel, already gives zeros)."""
    key: object                  # the program's SolveSpec (cache key)
    solve: Callable
    prep: Callable | None = None


@dataclasses.dataclass(frozen=True)
class UpdaterProgram:
    """The in-place bank updater for one
    :class:`repro_torch.core.solver.UpdateSpec`:
    ``update(stacks, slot, L)`` runs the admission pipeline on one
    (n, n) factor — a (chunk, n, n) run when ``key.chunk > 1``, a
    smaller (d, d) order when ``key.pad_from`` is set — and copies
    every resident role (L_lo[, Dt][, L_hi]) into ``stacks`` at
    ``slot`` (``slot .. slot + chunk - 1``), in place."""
    key: object                  # the program's UpdateSpec (cache key)
    update: Callable


class CompiledSolverCache:
    """LRU cache of :class:`SolverProgram`s and
    :class:`UpdaterProgram`s, keyed by
    :class:`repro_torch.core.solver.SolveSpec` and
    :class:`repro_torch.core.solver.UpdateSpec` — the only key types.

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
        from repro_torch.core.solver import SolveSpec, UpdateSpec
        if not isinstance(key, (SolveSpec, UpdateSpec)):
            raise TypeError(f"CompiledSolverCache keys are SolveSpec or "
                            f"UpdateSpec instances, got "
                            f"{type(key).__name__}")
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
            attrs = _build_attrs(key) if trace.enabled() else None
            with trace.span("program.build", attrs):
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


def _build_attrs(key) -> dict:
    """A ``program.build`` span's attributes: the program's kind, order,
    right-hand-side width (None for an updater) and bank width."""
    from repro_torch.core.solver import SolveSpec
    solve = isinstance(key, SolveSpec)
    return {"kind": "solve" if solve else "update", "n": key.n,
            "k": key.k if solve else None, "width": key.bank_width}


_DEFAULT_CACHE = CompiledSolverCache()


def default_cache() -> CompiledSolverCache:
    """The process-wide program cache used by every solver that does not
    pass an explicit ``cache=``."""
    return _DEFAULT_CACHE


# ------------------------- program construction -------------------------

def structured_info(structure, n: int, n0: int):
    """The :class:`~repro_torch.core.structure.StructureInfo` a
    structured program is built from, or None when there is no
    structure or it leaves out no block at block size n0: such a
    factor is served by the dense program, bit for bit."""
    if structure is None:
        return None
    info = analyze(structure, n, n0)
    return None if info.full else info


@functools.lru_cache(maxsize=128)
def _build_prep(grid: TrsmGrid, lower: bool, transpose: bool,
                dtype: torch.dtype, structure=None, n0: int | None = None):
    """L_nat -> L_cyc admission for one dtype role: a copy on the grid's
    device at ``dtype`` with the operator reduction folded into one
    gather (identity at p = 1 for the lower, non-transposed case), for
    an (M, n, n) stack of factors.  A ``structure`` (with its block
    size ``n0``, both in the memo key) is enforced here: every element
    outside its block mask is zeroed, in natural layout, before the
    gather.  At p > 1 the copy is this rank's (M, n/p1, n/(p1 p2))
    piece (``grid.local_piece``, the reduction folded into its two
    gathers, cut where the factor lives, after the structure's mask)."""
    p1, p2 = grid.p1, grid.p2
    rev = _needs_reversal(lower, transpose)
    if grid.p > 1:
        def prep_piece(L):
            if structure is not None:
                # the mask is the structure's in natural layout, where
                # the factor lives; only then is the piece cut (a
                # structure admits no reversal or transpose)
                L = apply_block_mask(torch.as_tensor(L), structure, n0)
            return gridlib.local_piece(L, grid, "L", dtype=dtype,
                                       reverse_rows=rev, reverse_cols=rev,
                                       transpose=transpose)
        return prep_piece

    def prep(L):
        A = torch.as_tensor(L)
        out = A.to(grid.device, dtype)
        if structure is not None:
            out = apply_block_mask(out, structure, n0)
        out = gridlib.cyclic_matrix_device(
            out, p1, p1 * p2, reverse_rows=rev, reverse_cols=rev,
            transpose=transpose)
        # the resident copy never aliases the caller's tensor
        return out.clone() if out.data_ptr() == A.data_ptr() else out

    return prep


def _factor_preps(grid: TrsmGrid, lower: bool, transpose: bool,
                  policy: PrecisionPolicy, structure=None,
                  n0: int | None = None) -> tuple:
    """The (storage[, residual]) admission programs for a policy.  Both
    copies are masked to ``structure``: the refinement residual sees
    the operator the sweep solves against."""
    preps = (_build_prep(grid, lower, transpose, policy.storage,
                         structure, n0),)
    if policy.refines:
        preps += (_build_prep(grid, lower, transpose, policy.residual,
                              structure, n0),)
    return preps


def _admission_preps(grid: TrsmGrid, n: int, n0: int | None, lower: bool,
                     transpose: bool, policy: PrecisionPolicy,
                     structure=None) -> tuple:
    """A bank's natural-layout admission programs: ``_factor_preps``
    with the structure enforced at the programs' block size — n0, or
    for a "rec" bank with n0 unset the base case of every k, n at p = 1
    (``rec_trsm.default_n0``), where the mask leaves out nothing."""
    bs = n0 if n0 is not None else n
    mask = (structure, bs) if structured_info(structure, n, bs) else ()
    return _factor_preps(grid, lower, transpose, policy, *mask)


@functools.lru_cache(maxsize=128)
def _build_phase1(grid: TrsmGrid, n: int, n0: int, mode: str, accum,
                  block_inv):
    """Phase 1 L_cyc (M, n, n) -> Dt (M, m, n0, n0), shared by bank
    admission and program prep.  ``block_inv=None`` is the port's
    default, the hand-written ``kernels.ops.block_inv_kernel``.  At
    p = 1 every mode's routing is the identity, so each inverts the
    diagonal blocks in one batched call, ``valid`` an (M m,) mask.  At
    p > 1 this rank's (M, n/p1, n/(p1 p2)) pieces -> its (M, m, n0/p1,
    n0/p1) faces through ``inv_trsm.invert_diag_blocks_shard`` in the
    mode asked, ``valid`` an (M, m) mask; collective: every rank runs
    it on the same factors."""
    from repro_torch.kernels import ops
    if mode not in ("alltoall", "doubling", "allgather"):
        raise ValueError(f"unknown phase-1 mode {mode!r}")
    binv = block_inv if block_inv is not None else ops.block_inv_kernel
    if grid.p > 1:
        def ph1(L_lo, valid=None):
            with comm.on_mesh(grid.mesh):
                return inv_trsm.invert_diag_blocks_shard(
                    L_lo, n=n, n0=n0, p1=grid.p1, p2=grid.p2,
                    block_inv=binv, mode=mode, accum_dtype=accum,
                    valid=valid)
        return ph1
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
      kernel.

    A structure that leaves out blocks at n0 (:func:`structured_info`)
    gives "inv" the level-scheduled sweep (its updates narrowed to the
    spans of kept blocks) and both methods the block-masked residual;
    otherwise the program is the dense one."""
    grid = spec.grid
    n, k, n0, policy = spec.n, spec.k, spec.n0, spec.policy
    if grid.device is None:
        raise ValueError("a plan-only grid (plan_grid) cannot run a "
                         "program: build it on make_trsm_mesh")
    if grid.p > 1:
        return _build_distributed_solver(spec)
    p1, p2 = grid.p1, grid.p2
    rev = _needs_reversal(spec.lower, spec.transpose)
    compute, accum = policy.compute, policy.accumulate
    banked = spec.bank_width is not None
    info = structured_info(spec.structure, n, n0)
    spans = info.spans if info is not None else None
    mask = {}
    if info is not None and policy.refines:
        # the residual's block mask, on the device once at build time
        mask = dict(block_mask=torch.as_tensor(
            info.mask_array(), dtype=torch.int32, device=grid.device),
            bt=n0)

    fixed = dict(fixed_order=True) if spec.fixed_order else {}
    if spec.method == "inv":
        gridlib.check_divisibility(n, k, n0, grid)
        if spec.fixed_order and (policy.storage != compute or accum != (
                torch.float64 if compute == torch.float64
                else torch.float32)):
            raise ValueError(
                f"fixed_order updates take the tri-GEMM's own partial "
                f"sums: policy {policy.name} stores {policy.storage}, "
                f"computes {compute} and accumulates {accum}")

        def base_solve(L_pair, B):
            B_cyc = gridlib.cyclic_rows_device(B.to(compute), p1,
                                               reverse=rev)
            X_cyc = inv_trsm.sweep(L_pair[0], L_pair[1], B_cyc, n0=n0,
                                   accum_dtype=accum, spans=spans,
                                   **fixed)
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

        def base_solve(L_lo, B, valid=None):
            B_cyc = gridlib.cyclic_matrix_device(
                B.to(compute), p1, p1 * p2, reverse_rows=rev)
            X_cyc = rec(L_lo, B_cyc, valid=valid)
            return gridlib.cyclic_matrix_device(
                X_cyc, p1, p1 * p2, inverse=True, reverse_rows=rev)

        def sweep_factor(factor):            # (L_lo[, L_hi])
            return factor[0]
    else:
        raise ValueError(f"unknown method {spec.method!r}")

    def program(factor, B, valid=None):
        L_hi = factor[-1] if policy.refines else None
        solve = base_solve
        if valid is not None and spec.method == "rec":
            solve = functools.partial(base_solve, valid=valid)
        return refinelib.refined_solve(solve, sweep_factor(factor),
                                       L_hi, B, policy=policy, p1=p1,
                                       p2=p2, reverse=rev, **mask, **fixed)

    BUILD_COUNTS[spec] += 1
    if banked:
        return SolverProgram(key=spec, solve=program)
    preps = _factor_preps(grid, spec.lower, spec.transpose, policy,
                          *((spec.structure, n0) if info else ()))

    def prep(L):
        return tuple(pr(torch.as_tensor(L)[None]) for pr in preps)

    def solve(factor, B):
        B = torch.as_tensor(B, device=grid.device)
        return program(factor, B[None])[0]

    return SolverProgram(key=spec, solve=solve, prep=prep)


def _map_factors(body, map_mode: str):
    """A stacked shard body over its factors: "vmap" runs it once on the
    whole (M, ...) stack (every collective once for the stack); "scan"
    runs it factor by factor on (1, ...) slices of every operand, the
    same operations one factor at a time, and records the costs of the
    first alone (a scan's body prices like the vmapped one).  Both give
    the same X, bit for bit: every kernel they run works matrix by
    matrix, and a p > 1 bank's local GEMMs are ``ops.gemm``'s
    (``SolveSpec.fixed_order``), whose order does not follow the batch
    as cuBLAS's does."""
    if map_mode != "scan":
        return body

    def scanned(*stacks, **kw):
        outs = []
        for f in range(stacks[-1].shape[0]):
            one = {key: v if v is None else v[f:f + 1]
                   for key, v in kw.items()}
            with comm.unrecorded() if f else contextlib.nullcontext():
                outs.append(body(*(t[f:f + 1] for t in stacks), **one))
        return torch.cat(outs)
    return scanned


def _build_distributed_solver(spec) -> SolverProgram:
    """The program of a spec on a p > 1 grid, run in every rank (each
    call is collective: every rank calls it with the same operands).

    A banked program (``bank_width`` set) is ``solve(factor, B_nat,
    valid=None)`` against a bank's resident pieces: (L_lo, Dt[, L_hi])
    for "inv", the sweep alone with phase 1 hoisted to admission, or
    (L_lo[, L_hi]) for "rec", whose base cases take the bank's liveness
    vector ``valid`` (kernel B6), an operand, never a constant of the
    build.  ``map_mode`` "vmap" runs the stacked shard body once for
    the stack, "scan" one factor at a time (:func:`_map_factors`).  A
    one-shot program's ``prep(L_nat)`` is this rank's pieces of the
    reduced operator at the storage (and residual) dtype, and
    ``solve(pieces, B_nat)`` runs phase 1 once per call for "inv"
    (column 0's panel gather started before it under ``overlap``), then
    the same body on a stack of one.

    B (the natural right-hand sides, the same on every rank) is cut to
    this rank's piece at the compute dtype (the reversal folded into
    the cut), the shard body runs, and the natural X is assembled on
    every rank.  A refining policy runs its fixed passes with the
    distributed residual (``refine.distributed_operator``: one mm3d
    against the resident L_hi piece).  ``fixed_order`` (every banked
    spec at p > 1, ``Solver.spec_for``) forms every local GEMM, the
    sweep's trailing updates, rec's and the residual's mm3d, with
    ``ops.gemm``.

    A structure that leaves out blocks at n0 (:func:`structured_info`)
    masks the natural factor before its pieces are cut, gives "inv" the
    level-scheduled sweep (each live column's panel cut to its span's
    local rows before the z-gather; a column without a span skips its
    update and both collectives), and both methods the residual's local
    product on B4 at block size n0/p1 (``mm3d_shard(block_mask=)``); the
    recursion of "rec" is structure-blind, as in the reference."""
    from repro_torch.kernels import ops
    grid = spec.grid
    n, k, n0, policy = spec.n, spec.k, spec.n0, spec.policy
    p1, p2 = grid.p1, grid.p2
    info = structured_info(spec.structure, n, n0)
    spans = info.spans if info is not None else None
    if info is not None and n0 % p1:
        raise ValueError(f"a structured solve over p > 1 ranks needs "
                         f"p1 | n0 (n0={n0}, p1={p1}): the residual's "
                         f"blocks are n0/p1 wide on every rank")
    rev = _needs_reversal(spec.lower, spec.transpose)
    overlap = spec.overlap == "on"
    banked = spec.bank_width is not None
    compute, accum = policy.compute, policy.accumulate
    if spec.method == "inv":
        gridlib.check_divisibility(n, k, n0, grid)
        mode = spec.mode or inv_trsm.pick_phase1_mode(n, n0, grid)
        if mode == "alltoall" and (n // n0) % grid.p:
            mode = inv_trsm.pick_phase1_mode(n, n0, grid)
        binv = spec.block_inv if spec.block_inv is not None \
            else ops.block_inv_kernel
        rhs = out = None
        rhs, out = "B", "X"

        def sweep(L_lo, Dt, Bp, prefetched0=None):
            with comm.on_mesh(grid.mesh):
                return inv_trsm.sweep_shard(
                    L_lo, Dt, Bp, n=n, k=k, n0=n0, p1=p1, p2=p2,
                    accum_dtype=accum, overlap=overlap,
                    prefetched0=prefetched0, fixed_order=spec.fixed_order,
                    spans=spans)
        core = _map_factors(sweep, spec.map_mode) if banked else sweep
    elif spec.method == "rec":
        from repro_torch.core import rec_trsm
        rec = rec_trsm.rec_trsm_sharded(grid, n, k, n0, accum_dtype=accum,
                                        overlap=overlap,
                                        fixed_order=spec.fixed_order)
        rhs = out = "L"
        core = _map_factors(rec, spec.map_mode) if banked else rec
    else:
        raise ValueError(f"unknown method {spec.method!r}")

    def base_solve(sweep_factor, B, **kw):
        Bp = gridlib.local_piece(B, grid, rhs, dtype=compute,
                                 reverse_rows=rev)
        args = sweep_factor if isinstance(sweep_factor, tuple) \
            else (sweep_factor,)
        return gridlib.gather_natural(core(*args, Bp, **kw), grid, out, n,
                                      k, reverse_rows=rev)

    operator = None
    if policy.refines:
        mask = {}
        if info is not None:
            # the residual's block mask, on the device once at build time
            mask = dict(block_mask=torch.as_tensor(
                info.mask_array(), dtype=torch.int32, device=grid.device),
                bt=n0 // p1)
        operator = refinelib.distributed_operator(
            grid, n, k, reverse=rev, accum_dtype=policy.residual,
            fixed_order=spec.fixed_order, **mask)

    def run(sweep_factor, L_hi, B, **kw):
        solve = functools.partial(base_solve, **kw) if kw else base_solve
        return refinelib.refined_solve(solve, sweep_factor, L_hi, B,
                                       policy=policy, p1=p1, p2=p2,
                                       reverse=rev, operator=operator)

    BUILD_COUNTS[spec] += 1
    if banked:
        def program(factor, B, valid=None):
            B = torch.as_tensor(B, device=grid.device)
            L_hi = factor[-1] if policy.refines else None
            if spec.method == "inv":
                return run(tuple(factor[:2]), L_hi, B)
            kw = {} if valid is None else dict(valid=valid)
            return run(factor[0], L_hi, B, **kw)
        return SolverProgram(key=spec, solve=program)

    preps = _factor_preps(grid, spec.lower, spec.transpose, policy,
                          *((spec.structure, n0) if info else ()))

    def prep(L):
        return tuple(pr(torch.as_tensor(L)[None]) for pr in preps)

    def solve(factor, B):
        B = torch.as_tensor(B, device=grid.device)[None]
        L_hi = factor[-1] if policy.refines else None
        if spec.method == "rec":
            return run(factor[0], L_hi, B)[0]
        L_lo = factor[0]
        with comm.on_mesh(grid.mesh):
            Dt, pre0 = inv_trsm.phase1_prefetched(
                L_lo, n=n, n0=n0, p1=p1, p2=p2, block_inv=binv, mode=mode,
                accum_dtype=accum, overlap=overlap, spans=spans)
        first = [pre0]                   # the first sweep finishes it

        def once(pair, Bn):
            return base_solve(pair, Bn, prefetched0=first.pop()
                              if first else None)
        return refinelib.refined_solve(once, (L_lo, Dt), L_hi, B,
                                       policy=policy, p1=p1, p2=p2,
                                       reverse=rev, operator=operator)[0]

    return SolverProgram(key=spec, solve=solve, prep=prep)


def _pad_factor(L: torch.Tensor, n: int) -> torch.Tensor:
    """``blockdiag(L, I)`` at order n for a (u, d, d) stack: the padded
    tail rows are unit rows, so they solve to the (zero) padded RHS rows
    exactly, and the zero coupling blocks leave the leading d x k block
    of a solve as an unpadded order-d solve at the same n0 gives it."""
    u, d = L.shape[0], L.shape[-1]
    full = torch.zeros((u, n, n), dtype=L.dtype, device=L.device)
    full[:, :d, :d] = L
    full.diagonal(dim1=-2, dim2=-1)[:, d:] = 1
    return full


def pad_block_mask(n: int, d: int, n0: int, reverse: bool) -> list:
    """One flag per diagonal block of an order-d factor padded to
    ``blockdiag(L, I)`` at order n, after the operator reduction: 0 for
    a block that lies wholly in the identity tail, 1 otherwise.  The
    reversal gather (``_needs_reversal``) runs after the padding, so it
    moves the tail to the top: block z is pad iff z n0 >= d without it,
    iff (z + 1) n0 <= n - d with it."""
    m = n // n0
    if reverse:
        return [int((z + 1) * n0 > n - d) for z in range(m)]
    return [int(z * n0 < d) for z in range(m)]


def _build_updater(uspec) -> UpdaterProgram:
    """Build the in-place updater for a
    :class:`repro_torch.core.solver.UpdateSpec` (which is also its cache
    key and :data:`BUILD_COUNTS` key).  Natural ingestion runs the
    admission gathers (operator reduction folded in, policy casts, the
    structure's mask at the bank's n0); cyclic ingestion takes a
    producer's cyclic-layout factor and only casts (at p = 1, lower and
    not transposed, cyclic storage is the natural layout); "inv" then
    inverts the diagonal blocks (phase 1, kernel B1).  A padded updater
    with the default hook inverts with B5 instead: the blocks of the
    identity tail (:func:`pad_block_mask`, uploaded here, once) are
    never read, and their Dt is set to the identity they would invert
    to."""
    grid, policy = uspec.grid, uspec.policy
    if grid.device is None:
        raise ValueError("a plan-only grid (plan_grid) cannot run an "
                         "updater: build banks on make_trsm_mesh")
    n, u = uspec.n, uspec.chunk
    distributed = grid.p > 1
    if uspec.ingest == "natural":
        preps = _admission_preps(grid, n, uspec.n0, uspec.lower,
                                 uspec.transpose, policy, uspec.structure)
    else:
        dts = (policy.storage,) + ((policy.residual,)
                                   if policy.refines else ())
        if distributed:
            preps = tuple(functools.partial(gridlib.cyclic_piece, grid=grid,
                                            dtype=dt, n=n) for dt in dts)
        else:
            preps = tuple(functools.partial(torch.Tensor.to, dtype=dt)
                          for dt in dts)
    ph1 = None
    gate = {}
    if uspec.method == "inv":
        ph1 = _build_phase1(grid, n, uspec.n0, uspec.mode,
                            policy.accumulate, uspec.block_inv)
        # a caller's own block_inv hook takes no mask: it inverts every
        # block, the identity tail's to the identity
        if uspec.pad_from is not None and uspec.block_inv is None:
            flags = pad_block_mask(n, uspec.pad_from, uspec.n0,
                                   _needs_reversal(uspec.lower,
                                                   uspec.transpose)) * u
            valid = torch.tensor(flags, dtype=torch.int32,
                                 device=grid.device)
            # added to the diagonal of every gated (all-zero) block; at
            # p > 1 to the faces binv[y::p1, x::p1] of an identity, whose
            # diagonal is the identity's where x == y and zero elsewhere
            pad_eye = (1 - valid).to(policy.storage)[:, None]
            x, y, _ = grid.coords
            if distributed:
                valid = valid.view(u, -1)         # (u, m): routed by block
                if x != y:
                    pad_eye = None
            gate = dict(valid=valid)

    def update(stacks, slot: int, L):
        # at p > 1 the factor stays where it lives: only this rank's
        # pieces cross to the device
        L = torch.as_tensor(L)
        if not distributed:
            L = L.to(grid.device)
        L = L.reshape((u,) + tuple(L.shape[-2:]))
        if uspec.pad_from is not None:
            L = _pad_factor(L, n)
        parts = tuple(p(L) for p in preps)           # (L_lo[, L_hi])
        if ph1 is not None:
            Dt = ph1(parts[0], **gate)
            if gate and pad_eye is not None:
                Dt.view(-1, *Dt.shape[-2:]).diagonal(
                    dim1=-2, dim2=-1).add_(pad_eye)
            parts = (parts[0], Dt) + parts[1:]
        for stack, part in zip(stacks, parts):
            stack.narrow(0, slot, u).copy_(part)

    BUILD_COUNTS[uspec] += 1
    return UpdaterProgram(key=uspec, update=update)
