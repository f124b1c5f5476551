"""Recursive TRSM (paper Sec. IV), the baseline algorithm.

Solves L X = B by recursively splitting L into quadrants:

    X1  = Rec-TRSM(L11, B1)
    B2' = B2 - MM(L21, X1)          (Sec. III MM, ``core.mm3d``)
    X2  = Rec-TRSM(L22, B2')

The recursion runs in Python over static shapes; every operand stays
in L's cyclic storage (``repro_torch.core.grid``), so quadrants are
views of this rank's piece and no block is copied.  The base case
(n <= n0, paper lines 5-9) gathers L over the whole mesh, moves B by
an all-to-all over x so that each rank owns full rows of k/p columns,
solves them by substitution on the hand-written kernel B3
(``kernels.trsm_block``) at the accumulate dtype, and moves X back; at
p = 1 the gather and the all-to-alls are the identity.  n/n0 base
cases run in sequence; at p = 1 :func:`default_n0` is n, so the whole
solve is one base case.

Every tensor carries a leading factor axis (the bank width M) where
the reference maps one factor with ``vmap``; at p > 1 the axis is
optional (a one-shot solve has none) and each collective runs once for
the stack, priced per factor (``comm.vmapped``).  ``valid`` (a capacity
bank's (M,) liveness vector, on the device) reaches every base case,
which then runs the validity-gated kernel B6: an empty or evicted
slot's lane solves to zeros without reading its factor.  ``None`` (an
append-only bank, a one-shot solve) is B3 unchanged.  ``overlap``
starts a base case's L gather before the trailing-update product that
makes its right-hand side, as the reference does; at p = 1 there is
none to start.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import comm
from repro_torch.core import grid as gridlib
from repro_torch.core.comm import MESH_AXES
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.mm3d import mm3d_shard


def _base_case(Lloc: torch.Tensor, Bloc: torch.Tensor, *, n0: int, k: int,
               p1: int, p2: int, accum_dtype=None, valid=None,
               pregathered=None) -> torch.Tensor:
    """Solve an n0 x n0 subproblem by substitution (paper lines 5-9) at
    ``accum_dtype``: B is cast up, solved, and X cast back, as the
    reference does around ``solve_triangular``.  L keeps its storage
    dtype: the kernel widens it on load (exact for bf16 to fp32), so no
    widened copy of the factor is written.

    At p > 1 (under ``comm.on_mesh``) L is gathered over the whole mesh
    first, or ``pregathered`` (a ``comm.all_gather_start`` handle on
    Lloc over the mesh) is finished.  Leading axes are a stack of
    factors (a bank's, under ``comm.vmapped``): the pieces of the stack
    are gathered in one collective and assembled into contiguous
    (..., n0, n0) systems, B3's (B6's with ``valid``) input."""
    from repro_torch.kernels import ops
    acc = accum_dtype if accum_dtype is not None else Bloc.dtype
    if p1 * p1 * p2 == 1:
        X = ops.trsm_substitution(Lloc, Bloc.to(acc), accum_dtype=acc,
                                  valid=valid)
        return X.to(Bloc.dtype)
    kc = k // (p1 * p2)                # local column count
    lead = tuple(Lloc.shape[:-2])
    nd = len(lead)
    # line 6: gather L over the whole mesh and reassemble it
    if pregathered is not None:
        Lg = comm.all_gather_finish(pregathered)        # (..., p, a, b)
    else:
        Lg = comm.all_gather(Lloc, MESH_AXES, axis=0, tiled=False)
    a, b = Lloc.shape[-2:]
    R = Lg.reshape(lead + (p1, p1, p2, a, b)).permute(
        tuple(range(nd)) + tuple(nd + d for d in (3, 0, 4, 2, 1)))
    # [..., l, x, c', z, y]; B3 reads unit-stride columns, and pieces one
    # column wide (b = 1) reshape to a view whose columns lie a apart,
    # so the assembled systems are copied contiguous
    Lfull = R.reshape(lead + (n0, n0)).contiguous()
    # line 7: all-to-all over x, so each rank owns full rows of its
    # chunk x of the local columns (k/p of them)
    if p1 > 1:
        Bt = comm.all_to_all(Bloc, "x", split_axis=1, concat_axis=0,
                             tiled=True)              # x-major rows
        Bt = Bt.reshape(lead + (p1, n0 // p1, kc // p1)).transpose(
            -3, -2).reshape(lead + (n0, kc // p1))
    else:
        Bt = Bloc
    # line 8: substitution on the owned columns (kernel B3, B6 gated)
    Xt = ops.trsm_substitution(Lfull, Bt.to(acc).contiguous(),
                               accum_dtype=acc, valid=valid
                               ).to(Bloc.dtype)
    # line 9: all-to-all back to cyclic rows and local columns
    if p1 > 1:
        Xt = Xt.reshape(lead + (n0 // p1, p1, kc // p1)).transpose(
            -3, -2).reshape(lead + (n0, kc // p1))
        Xt = comm.all_to_all(Xt, "x", split_axis=0, concat_axis=1,
                             tiled=True)              # (n0/p1, kc)
    return Xt


def _rec(Lloc, Bloc, *, n, k, n0, p1, p2, accum_dtype=None, valid=None,
         overlap=False, fixed_order=False):
    if n <= n0:
        return _base_case(Lloc, Bloc, n0=n, k=k, p1=p1, p2=p2,
                          accum_dtype=accum_dtype, valid=valid)
    h = n // 2
    hl, hc = h // p1, h // (p1 * p2)
    L11 = Lloc[..., :hl, :hc]
    L21 = Lloc[..., hl:, :hc]
    L22 = Lloc[..., hl:, hc:]
    X1 = _rec(L11, Bloc[..., :hl, :], n=h, k=k, n0=n0, p1=p1, p2=p2,
              accum_dtype=accum_dtype, valid=valid, overlap=overlap,
              fixed_order=fixed_order)
    pre22 = None
    if overlap and h <= n0 and p1 * p1 * p2 > 1:
        # the second half is a base case: start its L gather now, under
        # the trailing-update product (which never reads it)
        pre22 = comm.all_gather_start(L22, MESH_AXES, axis=0, tiled=False)
    U = mm3d_shard(L21, X1, m=h, n=h, k=k, p1=p1, p2=p2,
                   accum_dtype=accum_dtype, fixed_order=fixed_order)
    if pre22 is not None:
        X2 = _base_case(L22, Bloc[..., hl:, :] - U, n0=h, k=k, p1=p1,
                        p2=p2, accum_dtype=accum_dtype, valid=valid,
                        pregathered=pre22)
    else:
        X2 = _rec(L22, Bloc[..., hl:, :] - U, n=h, k=k, n0=n0, p1=p1,
                  p2=p2, accum_dtype=accum_dtype, valid=valid,
                  overlap=overlap, fixed_order=fixed_order)
    return torch.cat([X1, X2], dim=-2)


def default_n0(n: int, k: int, p1: int, p2: int) -> int:
    """Paper Sec. IV-A base-case sizes, snapped to feasibility.

    3D: n0 = n^{1/3} (k/p)^{2/3};  2D: n0 = max(sqrt p, n log p / sqrt p).
    Feasibility: p1*p2 | n0, n0 | n, both powers of two here."""
    p = p1 * p1 * p2
    if p2 > 1:
        ideal = n ** (1 / 3) * (k / p) ** (2 / 3)
    else:
        ideal = max(math.sqrt(p), n * max(math.log2(p), 1.0) / math.sqrt(p))
    gran = p1 * p1 * p2
    n0 = gran
    while n0 * 2 <= min(ideal, n) and n % (n0 * 2) == 0:
        n0 *= 2
    while n % n0 != 0 and n0 < n:
        n0 *= 2
    return min(n0, n)


def rec_trsm_sharded(grid: TrsmGrid, n: int, k: int,
                     n0: int | None = None, accum_dtype=None,
                     overlap: bool = False, fixed_order: bool = False):
    """Rec-TRSM for fixed shapes: ``(L, B) -> X``.  At p = 1 over an
    (M, n, n) factor stack and (M, n, k) right-hand sides; at p > 1
    over this rank's pieces of one factor and its right-hand sides, or
    of an (M, ...) stack of them, all in L's cyclic layout.  A stack
    takes an optional ``valid=`` liveness vector for the base cases.
    ``accum_dtype``: precision of the MM updates
    and of the base-case substitution (defaults to the operand dtype).
    ``overlap`` starts each base case's L gather under the preceding
    trailing update (the same X, bit for bit).  ``fixed_order`` (p > 1)
    forms the updates' local GEMMs with ``ops.gemm``."""
    n0 = n0 or default_n0(n, k, grid.p1, grid.p2)
    if k % (grid.p1 * grid.p1 * grid.p2):
        raise ValueError(f"need p | k (k={k}, p={grid.p})")
    body = functools.partial(_rec, n=n, k=k, n0=n0, p1=grid.p1,
                             p2=grid.p2, accum_dtype=accum_dtype,
                             overlap=overlap, fixed_order=fixed_order)
    if grid.p == 1:
        return body
    gridlib.require_mesh(grid)

    def fn(Lloc, Bloc, valid=None):
        with comm.on_mesh(grid.mesh), \
                comm.vmapped(Lloc.ndim - 2, exact=True):
            return body(Lloc, Bloc, valid=valid)
    return fn


def solve(L, B, grid: TrsmGrid, n0: int | None = None) -> torch.Tensor:
    """Natural-layout convenience entry point: L (n, n), B (n, k), through
    the cached program of a :class:`repro_torch.core.solver.SolveSpec`
    (returned on every rank at p > 1, which needs p | k)."""
    from repro_torch.core import precision as preclib
    from repro_torch.core.solver import SolveSpec, solver_for
    L = torch.as_tensor(L)
    n, k = B.shape
    spec = SolveSpec(n=n, k=k, grid=grid,
                     policy=preclib.resolve(None, L.dtype), method="rec",
                     n0=n0 or default_n0(n, k, grid.p1, grid.p2))
    prog = solver_for(spec)
    return prog.solve(prog.prep(L), B)
