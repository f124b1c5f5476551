"""Triangular inversion (paper Sec. V) on the 1 x 1 x 1 grid.

The reference (``repro.core.tri_inv``) re-derives the paper's RecTriInv
bottom-up ("recursive doubling"):

  Phase A  invert all n/s0 diagonal s0-blocks at once;
  Phase B  for s = s0, 2*s0, ..., n/2: finalize the off-diagonal block
           of every diagonal 2s-block with two batched products,
           ``inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]``.

At p = 1 every collective of Phase A (the all-to-all or all-gather
that routes whole blocks to devices) is the identity, so the phase is
the block inverter on the (n/s0, s0, s0) diagonal blocks: on the card
the ``tri_inv_blocks`` kernel (B1) through ``kernels.ops.
block_inv_kernel`` (which meets B1's power-of-two limit with an
identity tail).  Phase B is two batched GEMMs a level through
:func:`repro_torch.core.mm3d.mm3d_shard`.  Grids with p > 1 are
ROADMAP A12.

Storage is cyclic, which at p = 1 is the natural layout.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import precision as preclib
from repro_torch.core.blocked import diag_blocks
from repro_torch.core.grid import TrsmGrid, cyclic_matrix_device
from repro_torch.core.mm3d import mm3d_shard

def _check_p1(p1: int, p2: int, what: str) -> None:
    if p1 * p1 * p2 != 1:
        raise NotImplementedError(f"{what} over p > 1 devices is ROADMAP "
                                  f"A12")


def invert_blocks(blocks: torch.Tensor, block_inv=None) -> torch.Tensor:
    """Inverses of a (..., s, s) stack of lower-triangular blocks through
    ``block_inv`` (default ``kernels.ops.block_inv_kernel``), which takes
    an (m, s, s) stack: the leading axes are flattened into m."""
    if block_inv is None:
        from repro_torch.kernels.ops import block_inv_kernel as block_inv
    s = blocks.shape[-1]
    return block_inv(blocks.reshape(-1, s, s).contiguous()).reshape(
        blocks.shape)


# --------------------------- phase A ---------------------------

def _invert_diag_blocks_inplace(L, *, s0, block_inv):
    """Invert the n/s0 diagonal s0-blocks of the contiguous L in place."""
    d = diag_blocks(L, s0)
    d.copy_(invert_blocks(d, block_inv))
    return L


# --------------------------- phase B ---------------------------

def _doubling_levels(L, *, s0, s_hi):
    """Run doubling levels s = s0 .. s_hi/2 on the contiguous (..., N, N)
    L in place, finalizing the off-diagonal block of every diagonal
    2s-block up to block size s_hi."""
    s = s0
    while s < s_hi:
        blk = diag_blocks(L, 2 * s)                # (..., nb, 2s, 2s) view
        a11 = blk[..., :s, :s]                     # inverted already
        a22 = blk[..., s:, s:]                     # inverted already
        l21 = blk[..., s:, :s]                     # original entries
        T = mm3d_shard(l21, a11, m=s, n=s, k=s, p1=1, p2=1)
        l21.copy_(-mm3d_shard(a22, T, m=s, n=s, k=s, p1=1, p2=1))
        s *= 2
    return L


# --------------------------- entry points ---------------------------

def pick_s0(n: int, p1: int, p2: int) -> int:
    """Base block size: prefer m0 = n/s0 == p (one block per device,
    all-to-all routing); fall back to the smallest feasible block."""
    p = p1 * p1 * p2
    gran = p1 * p2
    if n % p == 0:
        s0 = n // p
        if s0 % gran == 0 and s0 >= gran:
            return s0
    s0 = gran
    while n % s0 != 0 and s0 < n:
        s0 *= 2
    return min(s0, n)


def phase_a_mode(n: int, s0: int, p: int) -> str:
    """How phase A routes its blocks over p devices: all-to-all when the
    n/s0 blocks split evenly, else all-gather (at p = 1 both are the
    identity, so nothing here calls it until A12 brings p > 1)."""
    m0 = n // s0
    return "alltoall" if m0 % p == 0 else "allgather"


def _check_s0(n: int, s0: int) -> None:
    """The doubling pairs blocks level by level, so n/s0 must be a power
    of two (the reference's shapes fail an assertion otherwise)."""
    if s0 < 1 or n % s0 or (n // s0) & (n // s0 - 1):
        raise ValueError(f"s0={s0} must tile n={n} in a power-of-two "
                         f"number of blocks")


def tri_inv_shard(Lloc, *, n, p1, p2, s0=None, block_inv=None):
    """Per-shard body: the inverse of the lower-triangular (n, n) Lloc
    (a new tensor; Lloc is not written)."""
    _check_p1(p1, p2, "tri_inv")
    s0 = s0 or pick_s0(n, p1, p2)
    _check_s0(n, s0)
    L = Lloc.clone(memory_format=torch.contiguous_format)
    _invert_diag_blocks_inplace(L, s0=s0, block_inv=block_inv)
    return _doubling_levels(L, s0=s0, s_hi=n)


def block_diag_inv_shard(Lloc, *, n, n0, p1, p2, s0=None, block_inv=None):
    """Per-shard body: invert only the n/n0 diagonal n0-blocks (the
    paper's Diagonal-Inverter) by the same two phases, the doubling
    stopped at block size n0.  Off-diagonal panels between n0-blocks
    are untouched."""
    _check_p1(p1, p2, "block_diag_inv")
    if n0 < 1 or n % n0:
        raise ValueError(f"n0={n0} does not tile n={n}")
    s0 = min(s0 or pick_s0(n, p1, p2), n0)
    _check_s0(n0, s0)
    L = Lloc.clone(memory_format=torch.contiguous_format)
    _invert_diag_blocks_inplace(L, s0=s0, block_inv=block_inv)
    if s0 < n0:
        # the doubling runs on each n0-block alone: the (n/n0, n0, n0)
        # stack of them is the leading batch axis
        d = diag_blocks(L, n0)
        d.copy_(_doubling_levels(d.contiguous(), s0=s0, s_hi=n0))
    return L


def tri_inv_fn(grid: TrsmGrid, n: int, s0: int | None = None,
               block_inv=None):
    """The inversion for fixed shapes on ``grid`` (cyclic storage in,
    cyclic storage out).  ``block_inv`` defaults to the kernel hook."""
    _check_p1(grid.p1, grid.p2, "tri_inv")
    return functools.partial(tri_inv_shard, n=n, p1=grid.p1, p2=grid.p2,
                             s0=s0, block_inv=block_inv)


def invert(L, grid: TrsmGrid, s0: int | None = None):
    """L^-1 of a natural-layout lower-triangular (n, n) L on ``grid``'s
    device (the cyclic permutations are on-device gathers, the identity
    at p = 1).  fp32 GEMMs run in IEEE fp32."""
    preclib.pin_matmul_numerics()
    L = torch.as_tensor(L, device=grid.device)
    n = L.shape[0]
    p1, p2 = grid.p1, grid.p2
    Lc = cyclic_matrix_device(L, p1, p1 * p2)
    out = tri_inv_fn(grid, n, s0=s0)(Lc)
    return cyclic_matrix_device(out, p1, p1 * p2, inverse=True)
