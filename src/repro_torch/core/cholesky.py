"""Cholesky factorization built on the paper's primitives, at p = 1.

The counterpart of ``repro.core.cholesky``: a recursive Cholesky whose
panel solve is *selective triangular inversion* (multiplication by an
inverted triangular factor) instead of substitution,

  chol([[A11, .], [A21, A22]]):
      L11  = chol(A11)                        (recursive)
      L21  = A21 * L11^{-T}                   (invert + MM, Secs. V/III)
      A22' = A22 - L21 * L21^T                (MM, Sec. III)
      L22  = chol(A22')                       (recursive)

the local blocked factorization the K-FAC optimizer uses (per-layer
Kronecker factors, a leading batch axis where the reference maps one
with ``vmap``), and the cyclic-storage transpose, which at p = 1 is
``.T``.  Every inversion goes through the ``tri_inv_blocks`` kernel
(B1) on the card.  A matrix that is not positive definite factors to
NaN, as ``jnp.linalg.cholesky`` gives it, without a host sync.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import precision as preclib
from repro_torch.core import tri_inv as ti
from repro_torch.core.grid import TrsmGrid, cyclic_matrix_device
from repro_torch.core.mm3d import mm3d_shard


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of each (..., n, n) matrix, NaN where
    the matrix is not positive definite.  ``cholesky_ex`` leaves its
    ``info`` on the device, so nothing waits for it."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, L, torch.full_like(L, float("nan")))


# ------------------------ local blocked Cholesky ------------------------

def chol_blocked_local(A: torch.Tensor, bs: int,
                       block_inv=None) -> torch.Tensor:
    """Left-looking blocked Cholesky of a (..., n, n) A; the panel solve
    multiplies by the inverted diagonal block (the paper's selective
    inversion), the blocks of every leading index inverted in one call
    of ``block_inv`` (default the kernel hook)."""
    n = A.shape[-1]
    if n % bs:
        raise ValueError(f"bs={bs} does not tile n={n}")
    L = torch.zeros_like(A)
    for j in range(n // bs):
        s0, s1 = j * bs, (j + 1) * bs
        Ljl = L[..., s0:s1, :s0]
        Ajj = A[..., s0:s1, s0:s1] - Ljl @ Ljl.transpose(-2, -1)
        Ljj = cholesky_nan(Ajj)
        L[..., s0:s1, s0:s1] = Ljj
        if s1 < n:
            Pj = A[..., s1:, s0:s1] - L[..., s1:, :s0] @ Ljl.transpose(-2, -1)
            Ljj_inv = ti.invert_blocks(Ljj, block_inv)
            L[..., s1:, s0:s1] = Pj @ Ljj_inv.transpose(-2, -1)
    return L


# -------------------- cyclic-storage transpose --------------------

def transpose_shard(Aloc, *, mr: int, nc: int, p1: int, p2: int):
    """Per-shard transpose: the (mr x nc) cyclic piece -> the (nc x mr)
    cyclic piece of A^T, in the same storage scheme.  At p = 1, A^T."""
    ti._check_p1(p1, p2, "transpose")
    if tuple(Aloc.shape[-2:]) != (mr, nc):
        raise ValueError(f"transpose_shard of {tuple(Aloc.shape)} for "
                         f"mr={mr}, nc={nc}")
    return Aloc.transpose(-2, -1)


def transpose_fn(grid: TrsmGrid, mr: int, nc: int):
    """The transpose of an (mr, nc) matrix in cyclic storage on
    ``grid``, as a new contiguous tensor."""
    ti._check_p1(grid.p1, grid.p2, "transpose")
    return lambda A: transpose_shard(A, mr=mr, nc=nc, p1=grid.p1,
                                     p2=grid.p2).contiguous()


# -------------------------- recursive Cholesky --------------------------

def _chol_base(Aloc, *, n, p1, p2):
    """Base case: factor the whole block (no gather at p = 1)."""
    ti._check_p1(p1, p2, "cholesky")
    return cholesky_nan(Aloc)


def _chol_rec(Aloc, *, n, n0, p1, p2):
    if n <= n0:
        return _chol_base(Aloc, n=n, p1=p1, p2=p2)
    h = n // 2
    hl, hc = h // p1, h // (p1 * p2)
    A11 = Aloc[:hl, :hc]
    A21 = Aloc[hl:, :hc]
    A22 = Aloc[hl:, hc:]
    L11 = _chol_rec(A11, n=h, n0=n0, p1=p1, p2=p2)
    # panel: L21 = A21 L11^{-T} via selective inversion (no substitution)
    L11i = ti.tri_inv_shard(L11, n=h, p1=p1, p2=p2)
    L11iT = transpose_shard(L11i, mr=h, nc=h, p1=p1, p2=p2)
    L21 = mm3d_shard(A21, L11iT, m=h, n=h, k=h, p1=p1, p2=p2)
    # trailing update: A22 - L21 L21^T
    L21T = transpose_shard(L21, mr=h, nc=h, p1=p1, p2=p2)
    A22u = A22 - mm3d_shard(L21, L21T, m=h, n=h, k=h, p1=p1, p2=p2)
    L22 = _chol_rec(A22u, n=h, n0=n0, p1=p1, p2=p2)
    top = torch.cat([L11, torch.zeros((hl, hc), dtype=Aloc.dtype,
                                      device=Aloc.device)], dim=1)
    bot = torch.cat([L21, L22], dim=1)
    return torch.cat([top, bot], dim=0)


def base_order(grid: TrsmGrid, n: int, n0: int | None = None) -> int:
    """The recursion's base-case order: n/8 (at least p) by default,
    doubled until it tiles n, at most n (the reference's rule)."""
    n0 = n0 or max(grid.p1 * grid.p1 * grid.p2, n // 8)
    while n % n0 != 0:
        n0 *= 2
    return min(n0, n)


def cholesky_fn(grid: TrsmGrid, n: int, n0: int | None = None):
    """The recursive Cholesky for fixed shapes on ``grid`` (cyclic
    storage in and out)."""
    ti._check_p1(grid.p1, grid.p2, "cholesky")
    return functools.partial(_chol_rec, n=n, n0=base_order(grid, n, n0),
                             p1=grid.p1, p2=grid.p2)


def cholesky_cyclic(A, grid: TrsmGrid, n0: int | None = None):
    """Factor A (natural layout, symmetric positive definite) on
    ``grid``'s device and return L in CYCLIC storage, the
    factorization's own working layout: the factor-producer end of the
    paper's producer -> consumer loop, fed to
    ``FactorBank.admit_cyclic`` with no unpermute -> re-permute round
    trip.  fp32 GEMMs run in IEEE fp32."""
    preclib.pin_matmul_numerics()
    A = torch.as_tensor(A, device=grid.device)
    n = A.shape[0]
    p1, p2 = grid.p1, grid.p2
    Ac = cyclic_matrix_device(A, p1, p1 * p2)
    return cholesky_fn(grid, n, n0)(Ac)


def cholesky(A, grid: TrsmGrid, n0: int | None = None):
    """Natural-layout Cholesky (A symmetric positive definite): L with
    A = L L^T.  For feeding a FactorBank keep the cyclic output:
    :func:`cholesky_cyclic`."""
    p1, p2 = grid.p1, grid.p2
    Lc = cholesky_cyclic(A, grid, n0)
    return cyclic_matrix_device(Lc, p1, p1 * p2, inverse=True)
