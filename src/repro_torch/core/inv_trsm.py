"""It-Inv-TRSM (the paper's main contribution, Secs. VI-VII) on the
1 x 1 x 1 grid.

Two phases, split so a factor bank can run phase 1 once at admission:

1. *Diagonal-Inverter* (:func:`invert_diag_blocks`): the m = n/n0
   diagonal blocks of L are inverted in one batched call of
   ``block_inv`` — by default ``kernels.ops.block_inv_kernel``, the
   hand-written doubling kernel.  At p = 1 the reference's "alltoall"
   routing is the identity, so Dt is the stack of whole inverted blocks.
2. *Sweep* (:func:`sweep`): for each block column i, the solve step
   X_i = Dt_i @ B_i through the ``trmm`` kernel (a GEMM by the
   pre-inverted block replaces substitution), then the trailing update
   B_{>i} -= L[>i, S_i] @ X_i as a ``torch.matmul`` (a plain dot in the
   reference too).

Every tensor carries a leading factor axis (the bank width M) where
the reference maps one factor with ``vmap``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import blocked
from repro_torch.core.grid import TrsmGrid, check_divisibility
from repro_torch.core.precision import matmul_as


def invert_diag_blocks(L: torch.Tensor, *, n0: int, block_inv: Callable,
                       accum_dtype=None) -> torch.Tensor:
    """Phase 1: (M, n, n) factors -> Dt (M, m, n0, n0), the inverted
    diagonal blocks.

    When ``accum_dtype`` is wider than the operand dtype the inversion
    runs at the accumulate precision (cast up, invert, cast back): the
    inverse re-enters the sweep at compute precision, but its entries
    are formed at full accuracy (``bf16_refine`` inverts in fp32)."""
    M, n, _ = L.shape
    m = n // n0
    D = blocked.diag_blocks(L, n0).reshape(M * m, n0, n0)
    if accum_dtype is not None and accum_dtype != L.dtype:
        Dt = block_inv(D.to(accum_dtype)).to(L.dtype)
    else:
        Dt = block_inv(D.contiguous())
    return Dt.reshape(M, m, n0, n0)


def sweep(L: torch.Tensor, Dt: torch.Tensor, B: torch.Tensor, *, n0: int,
          accum_dtype=None, spans=None) -> torch.Tensor:
    """Phase 2 against ALREADY-INVERTED diagonal blocks: L (M, n, n),
    Dt (M, m, n0, n0), B (M, n, k) at the compute dtype -> X (M, n, k).

    Works on its own copy of B, so the caller's B is never written.
    The trailing update multiplies only the rows below block i: at
    p = 1 the rows the reference masks to zero are exactly the rows not
    computed here, so the values are identical.  The last column has no
    trailing rows and no update, as in the reference's unrolled sweep.

    ``spans`` makes the sweep LEVEL-SCHEDULED (DESIGN.md Sec. 14): one
    ``(lo, hi)`` range of dependent block rows (or None) per column,
    from ``structure.analyze``.  Column i then updates only the rows of
    blocks [lo, hi), and a column whose span is None issues no update
    GEMM.  Admission masked the factor, so a block row inside a span
    that does not depend on column i multiplies exact zeros.  The solve
    step is the same for every column."""
    from repro_torch.kernels import ops
    M, n, k = B.shape
    m = n // n0
    ct = B.dtype
    acc = accum_dtype if accum_dtype is not None else ct
    Bcur = B.clone()
    X = torch.empty_like(B)
    for i in range(m):
        rows = slice(i * n0, (i + 1) * n0)
        # solve via GEMM (l. 4-5): partial sums at acc, X_i at ct
        Xi = ops.trmm(Dt[:, i], Bcur[:, rows])
        X[:, rows] = Xi
        span = spans[i] if spans is not None else \
            ((i + 1, m) if i + 1 < m else None)
        if span is not None:
            # update (l. 7-8): the block rows of the span only
            below = slice(span[0] * n0, span[1] * n0)
            Bcur[:, below] -= matmul_as(L[:, below, rows], Xi, acc, ct)
    return X


def dt_shape(n: int, n0: int) -> tuple:
    """Logical shape of one factor's phase-1 output Dt: one (n0, n0)
    inverted block per diagonal block."""
    return (n // n0, n0, n0)


def pick_phase1_mode(n: int, n0: int, grid: TrsmGrid) -> str:
    """The reference's phase-1 scheme choice.  At p = 1, p | m always
    holds, so the only scheme is "alltoall" (whose routing is the
    identity here); the cooperative and allgather schemes come with the
    distributed port (ROADMAP A12)."""
    if grid.p != 1:
        raise NotImplementedError("phase-1 modes for p > 1 are ROADMAP "
                                  "A12")
    check_divisibility(n, 1, n0, grid)
    return "alltoall"
