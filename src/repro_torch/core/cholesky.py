"""Cholesky factorization built on the paper's primitives.

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
with ``vmap``), and the cyclic-storage transpose: ``.T`` at p = 1, one
x <-> y permute and one all-to-all over z at p > 1.  Every inversion
goes through the ``tri_inv_blocks`` kernel (B1) on the card.  A matrix
that is not positive definite factors to NaN, as ``jnp.linalg.cholesky``
gives it, without a host sync.

At p > 1 every rank calls the entry points with the same natural A
(collective): each works on its cyclic piece (L's layout,
``repro_torch.core.grid``), the base case gathers its block over the
mesh, factors it whole and keeps its own piece (the reference's
``_chol_base``), and the panels run the distributed inversion and
products (``tri_inv_shard``, ``mm3d_shard``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import comm
from repro_torch.core import grid as gridlib
from repro_torch.core import precision as preclib
from repro_torch.core import tri_inv as ti
from repro_torch.core.comm import MESH_AXES
from repro_torch.core.grid import TrsmGrid, cyclic_matrix_device
from repro_torch.core.mm3d import _swap_perm, mm3d_shard


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
    """Per-shard transpose: this rank's (mr x nc) cyclic piece -> its
    (nc x mr) cyclic piece of A^T, in the same storage scheme.  At p = 1
    A^T (leading axes kept).  At p > 1 (under ``comm.on_mesh``) one
    x <-> y permute and one all-to-all over z, as the reference's:
    rank (x, y, z) holds A[x::p1, (z p1 + y)::p1 p2], and A^T's piece
    there is A[(z p1 + x)::p1 p2, y::p1]^T."""
    a, b = Aloc.shape[-2:]
    if (a, b) != (mr // p1, nc // (p1 * p2)):
        raise ValueError(f"transpose_shard of {tuple(Aloc.shape)} for "
                         f"mr={mr}, nc={nc}, p1={p1}, p2={p2}")
    if p1 * p1 * p2 == 1:
        return Aloc.transpose(-2, -1)
    if Aloc.ndim != 2:
        raise ValueError(f"transpose_shard over p > 1 ranks takes one "
                         f"(a, b) piece, got {tuple(Aloc.shape)}")
    Pc = comm.ppermute(Aloc, ("x", "y"), _swap_perm(p1)) if p1 > 1 \
        else Aloc
    if p2 > 1:
        aq = a // p2
        Q = Pc.reshape(aq, p2, b).transpose(0, 1)          # [z'', q, c']
        G = comm.all_to_all(Q.contiguous(), "z", split_axis=0,
                            concat_axis=0, tiled=True)     # [z_src, q, c']
        return G.reshape(p2, aq, b).permute(2, 0, 1).reshape(b * p2, aq)
    return Pc.transpose(0, 1)


def transpose_fn(grid: TrsmGrid, mr: int, nc: int):
    """The transpose of an (mr, nc) matrix in cyclic storage on
    ``grid``: this rank's piece in, its piece of A^T out, as a new
    contiguous tensor (at p = 1 the whole matrix)."""
    gridlib.require_mesh(grid)

    def fn(A):
        with comm.on_mesh(grid.mesh):
            return transpose_shard(A, mr=mr, nc=nc, p1=grid.p1,
                                   p2=grid.p2).contiguous()
    return fn


# -------------------------- recursive Cholesky --------------------------

def gather_block(Aloc, p1: int, p2: int) -> torch.Tensor:
    """The whole (n, n) block whose cyclic pieces the ranks hold, on
    every rank: one all-gather over the mesh, then the pieces put in
    natural order (at p = 1 the block itself)."""
    if p1 * p1 * p2 == 1:
        return Aloc
    Ag = comm.all_gather(Aloc[None], MESH_AXES, axis=0, tiled=False)
    return ti.assemble_blocks(Ag, p1, p2)[0]


def own_piece(full, p1: int, p2: int) -> torch.Tensor:
    """This rank's cyclic piece of a whole (n, n) block (at p = 1 the
    block itself), contiguous."""
    if p1 * p1 * p2 == 1:
        return full
    x, y, z = comm.current_mesh().coords
    return ti._cyclic_piece(full[None], x, y, z, p1, p2)[0].contiguous()


def _chol_base(Aloc, *, n, p1, p2):
    """Base case: gather the block, factor it whole, keep this rank's
    piece (no gather at p = 1)."""
    return own_piece(cholesky_nan(gather_block(Aloc, p1, p2)), p1, p2)


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


def on_grid(grid: TrsmGrid, body):
    """``body`` (a per-rank function of this rank's piece) run under the
    grid's mesh (at p = 1 ``body`` itself); a plan-only grid raises."""
    gridlib.require_mesh(grid)
    if grid.p == 1:
        return body

    def fn(Aloc):
        with comm.on_mesh(grid.mesh):
            return body(Aloc)
    return fn


def cholesky_fn(grid: TrsmGrid, n: int, n0: int | None = None):
    """The recursive Cholesky for fixed shapes on ``grid``: this rank's
    cyclic piece of A in, its piece of L out (at p = 1 the whole
    matrix)."""
    return on_grid(grid, functools.partial(
        _chol_rec, n=n, n0=base_order(grid, n, n0), p1=grid.p1, p2=grid.p2))


def cyclic_input(A, grid: TrsmGrid) -> torch.Tensor:
    """This rank's cyclic piece of the natural (n, n) A on the grid's
    device: the whole cyclic matrix at p = 1, the "L" piece at p > 1
    (cut where A lives, so only the piece crosses to the device)."""
    A = torch.as_tensor(A)
    if grid.p == 1:
        return cyclic_matrix_device(A.to(grid.device), grid.p1,
                                    grid.p1 * grid.p2)
    return gridlib.local_piece(A, grid, "L")


def cholesky_cyclic(A, grid: TrsmGrid, n0: int | None = None):
    """Factor A (natural layout, symmetric positive definite, the same
    in every rank) on ``grid`` and return L in CYCLIC storage, the
    factorization's own working layout: at p = 1 the whole matrix, at
    p > 1 this rank's (n/p1, n/(p1 p2)) piece, with no gather.  It is
    the factor-producer end of the paper's producer -> consumer loop,
    fed to ``FactorBank.admit_cyclic`` with no unpermute -> re-permute
    round trip.  fp32 GEMMs run in IEEE fp32."""
    preclib.pin_matmul_numerics()
    n = torch.as_tensor(A).shape[0]
    return cholesky_fn(grid, n, n0)(cyclic_input(A, grid))


def natural_output(piece, grid: TrsmGrid, n: int) -> torch.Tensor:
    """The natural (n, n) matrix from this rank's cyclic piece, on every
    rank (at p > 1 one gather, ``grid.gather_natural``)."""
    if grid.p == 1:
        return cyclic_matrix_device(piece, grid.p1, grid.p1 * grid.p2,
                                    inverse=True)
    return gridlib.gather_natural(piece, grid, "L", n, n)


def cholesky(A, grid: TrsmGrid, n0: int | None = None):
    """Natural-layout Cholesky (A symmetric positive definite): L with
    A = L L^T, the whole factor on every rank.  For feeding a
    FactorBank keep the cyclic output: :func:`cholesky_cyclic`."""
    n = torch.as_tensor(A).shape[0]
    return natural_output(cholesky_cyclic(A, grid, n0), grid, n)
