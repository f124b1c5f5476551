"""Iterative refinement for the cyclic solve pipeline (DESIGN.md Sec. 7).

Classic mixed-precision refinement: solve in low precision, then repeat

    r   = B - op(A) X          (residual precision)
    d   = solve(op(A), r)      (low-precision sweep, reused)
    X  += d

a fixed number of times — no host-side convergence test, so the
steady state never waits on the device.  The residual reuses the
resident cyclic factor: for ``L_cyc = G_r op(A) G_c^T`` (reversal and
transpose folded into the admission gathers, DESIGN.md Sec. 3),
``op(A) X = G_r^-1 (L_cyc @ G_c X)`` — two row gathers around one GEMM
serve all four (lower, transpose) operator variants.
"""

from __future__ import annotations

import torch

from repro_torch.core import grid as gridlib
from repro_torch.core.precision import PrecisionPolicy, matmul_as


def apply_cyclic_operator(L_cyc: torch.Tensor, X: torch.Tensor, *, p1: int,
                          p2: int, reverse: bool,
                          accum_dtype=None) -> torch.Tensor:
    """``op(A) @ X`` (natural layout in and out) from the resident cyclic
    factor: one gather of X's rows by the factor's COLUMN map, the GEMM
    against the resident factor with partial sums at ``accum_dtype``
    (result in that dtype), and the inverse gather by the ROW map.
    Stacked operands — L_cyc (M, n, n) with X (M, n, k) — make one
    batched GEMM."""
    Xg = gridlib.cyclic_rows_device(X, p1 * p2, reverse=reverse)
    acc = accum_dtype if accum_dtype is not None else X.dtype
    Y = matmul_as(L_cyc, Xg.to(L_cyc.dtype), acc, acc)
    return gridlib.cyclic_rows_device(Y, p1, inverse=True, reverse=reverse)


def refined_solve(base_solve, L_lo, L_hi, B, *, policy: PrecisionPolicy,
                  p1: int, p2: int, reverse: bool) -> torch.Tensor:
    """The refined solve body.

    ``base_solve(L_sweep, B) -> X`` is the compute-precision sweep
    (natural layout in/out).  ``L_lo`` is what the sweep consumes,
    ``L_hi`` the resident cyclic factor at residual precision (None when
    the policy does not refine).  Returns X at ``policy.io_dtype``."""
    io = policy.io_dtype
    B = B.to(io)
    X = base_solve(L_lo, B.to(policy.compute))
    if not policy.refines:
        return X.to(io)
    res = policy.residual
    X = X.to(res)
    for _ in range(policy.refine_steps):
        r = B - apply_cyclic_operator(L_hi, X, p1=p1, p2=p2,
                                      reverse=reverse, accum_dtype=res)
        d = base_solve(L_lo, r.to(policy.compute))
        X = X + d.to(res)
    return X
