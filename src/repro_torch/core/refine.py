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
serve all four (lower, transpose) operator variants.  A structured
factor (lower, not transposed: no gathers) forms the product with the
block-masked ``trmm`` kernel, which reads only the blocks its structure
keeps.
"""

from __future__ import annotations

import torch

from repro_torch.core import grid as gridlib
from repro_torch.core.precision import PrecisionPolicy, matmul_as


def apply_cyclic_operator(L_cyc: torch.Tensor, X: torch.Tensor, *, p1: int,
                          p2: int, reverse: bool, accum_dtype=None,
                          block_mask=None, bt: int | None = None
                          ) -> torch.Tensor:
    """``op(A) @ X`` (natural layout in and out) from the resident cyclic
    factor: one gather of X's rows by the factor's COLUMN map, the GEMM
    against the resident factor with partial sums at ``accum_dtype``
    (result in that dtype), and the inverse gather by the ROW map.
    Stacked operands — L_cyc (M, n, n) with X (M, n, k) — make one
    batched GEMM.

    With a ``block_mask`` (a structure's (n/bt, n/bt) int32 mask, bt =
    n0, on the factor's device) the GEMM is the block-masked ``trmm``
    kernel, tril(L_cyc) @ X over the kept blocks only; a structure
    forbids the reversal, so the gathers are the identity.  Its partial
    sums are fp32 (fp64 for fp64 operands) and its result has the
    factor's dtype, the residual dtype."""
    Xg = gridlib.cyclic_rows_device(X, p1 * p2, reverse=reverse)
    acc = accum_dtype if accum_dtype is not None else X.dtype
    if block_mask is not None:
        from repro_torch.kernels import ops
        Y = ops.trmm(L_cyc, Xg.to(L_cyc.dtype), block_mask=block_mask,
                     bt=bt).to(acc)
    else:
        Y = matmul_as(L_cyc, Xg.to(L_cyc.dtype), acc, acc)
    return gridlib.cyclic_rows_device(Y, p1, inverse=True, reverse=reverse)


def refined_solve(base_solve, L_lo, L_hi, B, *, policy: PrecisionPolicy,
                  p1: int, p2: int, reverse: bool, block_mask=None,
                  bt: int | None = None) -> torch.Tensor:
    """The refined solve body.

    ``base_solve(L_sweep, B) -> X`` is the compute-precision sweep
    (natural layout in/out).  ``L_lo`` is what the sweep consumes,
    ``L_hi`` the resident cyclic factor at residual precision (None when
    the policy does not refine).  ``block_mask``/``bt`` (a structured
    factor's) send each residual to the block-masked kernel.  Returns X
    at ``policy.io_dtype``."""
    io = policy.io_dtype
    B = B.to(io)
    X = base_solve(L_lo, B.to(policy.compute))
    if not policy.refines:
        return X.to(io)
    res = policy.residual
    X = X.to(res)
    for _ in range(policy.refine_steps):
        r = B - apply_cyclic_operator(L_hi, X, p1=p1, p2=p2,
                                      reverse=reverse, accum_dtype=res,
                                      block_mask=block_mask, bt=bt)
        d = base_solve(L_lo, r.to(policy.compute))
        X = X + d.to(res)
    return X
