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

On a p > 1 grid (:func:`distributed_operator`) a rank holds only its
piece of the resident factor, so the product is distributed: X's "L"
piece is cut locally, one ``mm3d`` against the resident piece forms
this rank's piece of op(A) X (its collectives recorded under the
``"residual"`` label of the cost trace), and one gather assembles the
natural result on every rank.  A structured factor's local product
there is the block-masked kernel too, on rank (x, y, z)'s L[x::p1,
y::p1] at block size n0/p1.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import comm, trace
from repro_torch.core import grid as gridlib
from repro_torch.core.precision import PrecisionPolicy, matmul_as


def apply_cyclic_operator(L_cyc: torch.Tensor, X: torch.Tensor, *, p1: int,
                          p2: int, reverse: bool, accum_dtype=None,
                          block_mask=None, bt: int | None = None,
                          fixed_order: bool = False) -> torch.Tensor:
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
    factor's dtype, the residual dtype.

    ``fixed_order`` forms tril(L_cyc) @ X with ``ops.gemm`` (the
    resident factor is lower triangular), whose row sums run in an order
    that does not depend on n, in place of cuBLAS: a padded slot's
    leading rows then get the unpadded factor's bits."""
    Xg = gridlib.cyclic_rows_device(X, p1 * p2, reverse=reverse)
    acc = accum_dtype if accum_dtype is not None else X.dtype
    if block_mask is not None:
        from repro_torch.kernels import ops
        Y = ops.trmm(L_cyc, Xg.to(L_cyc.dtype), block_mask=block_mask,
                     bt=bt).to(acc)
    elif fixed_order:
        from repro_torch.kernels import ops
        Y = ops.gemm(L_cyc, Xg.to(L_cyc.dtype), lower=True).to(acc)
    else:
        Y = matmul_as(L_cyc, Xg.to(L_cyc.dtype), acc, acc)
    return gridlib.cyclic_rows_device(Y, p1, inverse=True, reverse=reverse)


def distributed_operator(grid, n: int, k: int, *, reverse: bool,
                         accum_dtype, fixed_order: bool = False,
                         block_mask=None, bt: int | None = None):
    """``apply(L_hi, X) -> op(A) @ X`` on a p > 1 grid, natural layout
    in and out on every rank, X (..., n, k) the same on every rank and
    ``L_hi`` this rank's (..., n/p1, n/(p1 p2)) piece of the resident
    reduced operator (reversal and transpose folded in at admission).

    X's "L" piece (rows reversed as the factor's) is cut locally, with
    no communication; one ``mm3d`` against the resident piece forms this
    rank's piece of the product, partial sums and the cross-y reduction
    at ``accum_dtype``, its collectives recorded under the ``"residual"``
    label; ``grid.gather_natural`` undoes the cut.  ``mm3d`` needs
    p | k, so X gets zero columns up to the next multiple of p, whose
    product columns are zero and dropped: every k of the solve is
    served.  ``fixed_order`` forms the local GEMM with ``ops.gemm``.

    A structured factor's ``block_mask`` (its (n/n0, n/n0) int32 mask
    on the device, with ``bt`` = n0/p1) forms the local product with the
    block-masked ``trmm`` (kernel B4), which reads only the kept
    blocks; as at p = 1 it takes precedence over ``fixed_order``, and
    the collectives, so the ``"residual"`` trace, are unchanged."""
    from repro_torch.core.mm3d import mm3d_shard
    p = grid.p
    kp = -(-k // p) * p

    def apply(L_hi, X):
        if kp != k:
            X = torch.cat([X, X.new_zeros(X.shape[:-1] + (kp - k,))], -1)
        Xp = gridlib.local_piece(X, grid, "L", dtype=L_hi.dtype,
                                 reverse_rows=reverse)
        with comm.on_mesh(grid.mesh), comm.labelled("residual"), \
                comm.vmapped(Xp.ndim - 2, exact=True):
            Y = mm3d_shard(L_hi, Xp, m=n, n=n, k=kp, p1=grid.p1,
                           p2=grid.p2, accum_dtype=accum_dtype,
                           fixed_order=fixed_order, block_mask=block_mask,
                           bt=bt)
        Y = gridlib.gather_natural(Y, grid, "L", n, kp,
                                   reverse_rows=reverse)
        return Y[..., :k].to(accum_dtype)
    return apply


def refined_solve(base_solve, L_lo, L_hi, B, *, policy: PrecisionPolicy,
                  p1: int, p2: int, reverse: bool, block_mask=None,
                  bt: int | None = None, fixed_order: bool = False,
                  operator=None) -> torch.Tensor:
    """The refined solve body.

    ``base_solve(L_sweep, B) -> X`` is the compute-precision sweep
    (natural layout in/out).  ``L_lo`` is what the sweep consumes,
    ``L_hi`` the resident cyclic factor at residual precision (None when
    the policy does not refine).  ``block_mask``/``bt`` (a structured
    factor's) send each residual to the block-masked kernel, and
    ``fixed_order`` to ``ops.gemm`` (``apply_cyclic_operator``).
    ``operator(L_hi, X)`` replaces ``apply_cyclic_operator`` (a p > 1
    program's :func:`distributed_operator`).  Returns X at
    ``policy.io_dtype``."""
    io = policy.io_dtype
    B = B.to(io)
    with trace.span("refine.sweep", _pass(0)):
        X = base_solve(L_lo, B.to(policy.compute))
    if not policy.refines:
        return X.to(io)
    res = policy.residual
    X = X.to(res)
    for i in range(1, policy.refine_steps + 1):
        with trace.span("refine.residual"):
            if operator is not None:
                r = B - operator(L_hi, X)
            else:
                r = B - apply_cyclic_operator(
                    L_hi, X, p1=p1, p2=p2, reverse=reverse,
                    accum_dtype=res, block_mask=block_mask, bt=bt,
                    fixed_order=fixed_order)
        with trace.span("refine.sweep", _pass(i)):
            d = base_solve(L_lo, r.to(policy.compute))
        X = X + d.to(res)
    return X


@functools.lru_cache(maxsize=None)
def _pass(i: int) -> dict:
    """The attributes of sweep ``i`` (0: the first solve), one shared
    dict each, so a disabled span allocates nothing."""
    return {"pass": i}
