"""3D matrix multiplication from a 2D cyclic start (paper Sec. III) on
the 1 x 1 x 1 grid.

At p = 1 every collective of the reference's schedule
(``repro.core.mm3d``: gather L over z, permute and gather X, reduce-
scatter over y) is the identity, so the per-shard body is the local
GEMM alone: partial sums at the accumulate dtype, the result rounded
once to the operand dtype.  It is a plain cuBLAS product
(``precision.matmul_as``), as the reference leaves it to ``lax.dot``
outside any Pallas kernel.  Grids with p > 1 are ROADMAP A12.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import matmul_as


def mm3d_shard(Lloc: torch.Tensor, Xloc: torch.Tensor, *, m: int, n: int,
               k: int, p1: int, p2: int, accum_dtype=None) -> torch.Tensor:
    """The cyclic piece of L @ X: Lloc (..., m, n) and Xloc (..., n, k)
    on the 1 x 1 x 1 grid, with a leading factor axis where the
    reference maps one.  ``accum_dtype`` is the GEMM precision; the
    result has X's dtype."""
    if p1 * p1 * p2 != 1:
        raise NotImplementedError("mm3d over p > 1 devices is ROADMAP A12")
    if Lloc.shape[-2:] != (m, n) or Xloc.shape[-2:] != (n, k):
        raise ValueError(f"mm3d_shard shapes {tuple(Lloc.shape)} @ "
                         f"{tuple(Xloc.shape)} for m={m}, n={n}, k={k}")
    acc = accum_dtype if accum_dtype is not None else Xloc.dtype
    return matmul_as(Lloc, Xloc, acc, Xloc.dtype)
