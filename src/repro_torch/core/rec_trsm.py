"""Recursive TRSM (paper Sec. IV), the baseline algorithm, on the
1 x 1 x 1 grid.

Solves L X = B by recursively splitting L into quadrants:

    X1  = Rec-TRSM(L11, B1)
    B2' = B2 - MM(L21, X1)          (Sec. III MM, ``core.mm3d``)
    X2  = Rec-TRSM(L22, B2')

The recursion runs in Python over static shapes; quadrants are views
of the resident factor, so no block is copied.  The base case
(n <= n0, paper lines 5-9) solves by substitution: at p = 1 there is
no gather of L and no all-to-all of B, so it is the hand-written
substitution kernel B3 (``kernels.trsm_block``) at the accumulate
dtype, one launch per base case and n/n0 of them in sequence.  At
p = 1 :func:`default_n0` is n: the whole solve is one base case.

Every tensor carries a leading factor axis (the bank width M) where
the reference maps one factor with ``vmap``.  The reference's
``overlap`` prefetches each base case's L-gather; at p = 1 there is
none to prefetch.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.grid import TrsmGrid
from repro_torch.core.mm3d import mm3d_shard


def _base_case(Lloc: torch.Tensor, Bloc: torch.Tensor, *, n0: int, k: int,
               p1: int, p2: int, accum_dtype=None) -> torch.Tensor:
    """Solve an n0 x n0 subproblem by substitution (paper lines 5-9) at
    ``accum_dtype``: B is cast up, solved, and X cast back, as the
    reference does around ``solve_triangular``.  L keeps its storage
    dtype: the kernel widens it on load (exact for bf16 to fp32), so no
    widened copy of the factor is written."""
    from repro_torch.kernels import ops
    if p1 * p1 * p2 != 1:
        raise NotImplementedError("the distributed base case (gather + "
                                  "all-to-all) is ROADMAP A12")
    acc = accum_dtype if accum_dtype is not None else Bloc.dtype
    X = ops.trsm_substitution(Lloc, Bloc.to(acc), accum_dtype=acc)
    return X.to(Bloc.dtype)


def _rec(Lloc, Bloc, *, n, k, n0, p1, p2, accum_dtype=None):
    if n <= n0:
        return _base_case(Lloc, Bloc, n0=n, k=k, p1=p1, p2=p2,
                          accum_dtype=accum_dtype)
    h = n // 2
    hl, hc = h // p1, h // (p1 * p2)
    L11 = Lloc[..., :hl, :hc]
    L21 = Lloc[..., hl:, :hc]
    L22 = Lloc[..., hl:, hc:]
    X1 = _rec(L11, Bloc[..., :hl, :], n=h, k=k, n0=n0, p1=p1, p2=p2,
              accum_dtype=accum_dtype)
    U = mm3d_shard(L21, X1, m=h, n=h, k=k, p1=p1, p2=p2,
                   accum_dtype=accum_dtype)
    X2 = _rec(L22, Bloc[..., hl:, :] - U, n=h, k=k, n0=n0, p1=p1, p2=p2,
              accum_dtype=accum_dtype)
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
                     n0: int | None = None, accum_dtype=None):
    """Rec-TRSM for fixed shapes: ``(L, B) -> X`` over an (M, n, n)
    factor stack and (M, n, k) right-hand sides in cyclic storage (the
    identity at p = 1).  ``accum_dtype``: precision of the MM updates
    and of the base-case substitution (defaults to the operand
    dtype)."""
    n0 = n0 or default_n0(n, k, grid.p1, grid.p2)
    if k % (grid.p1 * grid.p1 * grid.p2):
        raise ValueError(f"need p | k (k={k}, p={grid.p})")
    return functools.partial(_rec, n=n, k=k, n0=n0, p1=grid.p1,
                             p2=grid.p2, accum_dtype=accum_dtype)


def solve(L, B, grid: TrsmGrid, n0: int | None = None) -> torch.Tensor:
    """Natural-layout convenience entry point: L (n, n), B (n, k), through
    the cached program of a :class:`repro_torch.core.solver.SolveSpec`."""
    from repro_torch.core import precision as preclib
    from repro_torch.core.solver import SolveSpec, solver_for
    L = torch.as_tensor(L)
    n, k = B.shape
    spec = SolveSpec(n=n, k=k, grid=grid,
                     policy=preclib.resolve(None, L.dtype), method="rec",
                     n0=n0 or default_n0(n, k, grid.p1, grid.p2))
    prog = solver_for(spec)
    return prog.solve(prog.prep(L), B)
