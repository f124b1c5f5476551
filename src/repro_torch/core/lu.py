"""LU factorization without pivoting on the paper's primitives.

The counterpart of ``repro.core.lu``:

    A = [[A11, A12], [A21, A22]]
    L11, U11 = LU(A11)                      (recursive)
    U12 = L11^{-1} A12                      (lower solve via inversion)
    L21 = A21 U11^{-1}                      (upper solve via inversion)
    A22' = A22 - L21 U12                    (Sec. III MM)
    L22, U22 = LU(A22')

Both triangular solves use selective inversion (invert + MM), the upper
one reduced to the lower case through the cyclic-storage transpose
(``repro_torch.core.cholesky``); every inversion goes through the
``tri_inv_blocks`` kernel (B1) on the card.  No pivoting: for
diagonally dominant, preconditioner-style matrices.  At p > 1 every
rank calls the entry points with the same natural A (collective), as
for ``cholesky``: the base case gathers its block over the mesh and
each rank keeps its pieces.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import precision as preclib
from repro_torch.core import tri_inv as ti
from repro_torch.core.cholesky import (base_order, cyclic_input,
                                       gather_block, natural_output,
                                       on_grid, own_piece, transpose_shard)
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.mm3d import mm3d_shard


def _lu_base(Aloc, *, n, p1, p2):
    """Base case: the reference's row-serial elimination, on the whole
    block (at p > 1 gathered over the mesh; each rank keeps its pieces
    of L and U).  Step i divides column i below the pivot by it (L's
    column i) and takes the rank-1 update off the rows below; the
    reference updates the whole matrix with those rows masked, which
    leaves the kept entries the same, and its ``triu`` discards the
    rest."""
    U = gather_block(Aloc, p1, p2).clone(
        memory_format=torch.contiguous_format)
    L = torch.eye(n, dtype=U.dtype, device=U.device)
    for i in range(n - 1):
        col = U[i + 1:, i] / U[i, i]
        L[i + 1:, i] = col
        U[i + 1:, i:].sub_(torch.outer(col, U[i, i:]))
    return own_piece(L, p1, p2), own_piece(torch.triu(U), p1, p2)


def _lu_rec(Aloc, *, n, n0, p1, p2):
    if n <= n0:
        return _lu_base(Aloc, n=n, p1=p1, p2=p2)
    h = n // 2
    hl, hc = h // p1, h // (p1 * p2)
    A11, A12 = Aloc[:hl, :hc], Aloc[:hl, hc:]
    A21, A22 = Aloc[hl:, :hc], Aloc[hl:, hc:]
    L11, U11 = _lu_rec(A11, n=h, n0=n0, p1=p1, p2=p2)
    # U12 = L11^{-1} A12 (lower solve via inversion, Sec. V + III)
    L11i = ti.tri_inv_shard(L11, n=h, p1=p1, p2=p2)
    U12 = mm3d_shard(L11i, A12, m=h, n=h, k=h, p1=p1, p2=p2)
    # L21 = A21 U11^{-1}: (A21 U11^{-1})^T = U11^{-T} A21^T, U11^T lower
    U11T = transpose_shard(U11, mr=h, nc=h, p1=p1, p2=p2)
    U11Ti = ti.tri_inv_shard(U11T, n=h, p1=p1, p2=p2)
    A21T = transpose_shard(A21, mr=h, nc=h, p1=p1, p2=p2)
    L21T = mm3d_shard(U11Ti, A21T, m=h, n=h, k=h, p1=p1, p2=p2)
    L21 = transpose_shard(L21T, mr=h, nc=h, p1=p1, p2=p2)
    # trailing update + recurse
    A22u = A22 - mm3d_shard(L21, U12, m=h, n=h, k=h, p1=p1, p2=p2)
    L22, U22 = _lu_rec(A22u, n=h, n0=n0, p1=p1, p2=p2)
    zero = torch.zeros((hl, hc), dtype=Aloc.dtype, device=Aloc.device)
    L = torch.cat([torch.cat([L11, zero], dim=1),
                   torch.cat([L21, L22], dim=1)], dim=0)
    U = torch.cat([torch.cat([U11, U12], dim=1),
                   torch.cat([zero, U22], dim=1)], dim=0)
    return L, U


def lu_fn(grid: TrsmGrid, n: int, n0: int | None = None):
    """The recursive LU for fixed shapes on ``grid``: this rank's cyclic
    piece of A in, its pieces of (L, U) out (at p = 1 the whole
    matrices)."""
    return on_grid(grid, functools.partial(
        _lu_rec, n=n, n0=base_order(grid, n, n0), p1=grid.p1, p2=grid.p2))


def lu_cyclic(A, grid: TrsmGrid, n0: int | None = None):
    """LU-factor A (natural layout, the same in every rank) on ``grid``
    and return (L_cyc, U_cyc) in CYCLIC storage: at p = 1 the whole
    matrices, at p > 1 this rank's pieces, with no gather.  ``L_cyc``
    feeds ``FactorBank.admit_cyclic`` (lower solves) with no unpermute
    -> re-permute round trip.  fp32 GEMMs run in IEEE fp32."""
    preclib.pin_matmul_numerics()
    n = torch.as_tensor(A).shape[0]
    return lu_fn(grid, n, n0)(cyclic_input(A, grid))


def lu(A, grid: TrsmGrid, n0: int | None = None):
    """Natural-layout LU without pivoting: (L, U) with A = L @ U, L unit
    lower and U upper triangular, both whole on every rank.  For
    feeding a FactorBank keep the cyclic output: :func:`lu_cyclic`."""
    n = torch.as_tensor(A).shape[0]
    return tuple(natural_output(F, grid, n)
                 for F in lu_cyclic(A, grid, n0))
