"""Triangular inversion (paper Sec. V), bottom-up.

The reference (``repro.core.tri_inv``) re-derives the paper's RecTriInv
bottom-up ("recursive doubling"):

  Phase A  invert all n/s0 diagonal s0-blocks at once: whole blocks are
           routed to ranks with one all-to-all when p divides n/s0, or
           every rank gathers them all and inverts them redundantly;
  Phase B  for s = s0, 2*s0, ..., n/2: finalize the off-diagonal block
           of every diagonal 2s-block with two batched distributed
           products (``core.mm3d``, one collective per step for the
           whole batch),
           ``inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]``.

Phase A's leaves run on the ``tri_inv_blocks`` kernel (B1) through
``kernels.ops.block_inv_kernel``, which meets B1's power-of-two limit
with an identity tail.  At p = 1 every collective is the identity: phase
A is the block inverter on the (n/s0, s0, s0) diagonal blocks and phase
B two batched GEMMs a level.

Storage: cyclic, L's layout (``repro_torch.core.grid``): each rank holds
its (n/p1, n/(p1 p2)) piece; at p = 1 that is the natural layout.
Cholesky and LU call the per-rank bodies on their panels.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import comm
from repro_torch.core import grid as gridlib
from repro_torch.core import precision as preclib
from repro_torch.core.blocked import diag_blocks
from repro_torch.core.comm import MESH_AXES
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.mm3d import mm3d_shard, mm3d_shard_batched


def invert_blocks(blocks: torch.Tensor, block_inv=None,
                  valid=None) -> torch.Tensor:
    """Inverses of a (..., s, s) stack of lower-triangular blocks through
    ``block_inv`` (default ``kernels.ops.block_inv_kernel``), which takes
    an (m, s, s) stack: the leading axes are flattened into m.
    ``valid`` (one flag per block, in the same order) goes to the hook
    as ``valid=``: a block flagged 0 comes out as zeros (kernel B5)."""
    if block_inv is None:
        from repro_torch.kernels.ops import block_inv_kernel as block_inv
    s = blocks.shape[-1]
    gate = {} if valid is None else dict(valid=valid.reshape(-1))
    return block_inv(blocks.reshape(-1, s, s).contiguous(), **gate
                     ).reshape(blocks.shape)


# ------------------------ local-piece helpers ------------------------

def diag_pieces(Lloc: torch.Tensor, m: int) -> torch.Tensor:
    """(..., nl, ncl) cyclic piece -> (..., m, nl/m, ncl/m): this rank's
    pieces of the m diagonal blocks, as a view (writes go through)."""
    nl, ncl = Lloc.shape[-2:]
    v = Lloc.unflatten(-1, (m, ncl // m)).unflatten(-3, (m, nl // m))
    return torch.diagonal(v, dim1=-4, dim2=-2).movedim(-1, -3)


def by_rank(D: torch.Tensor, lead: int) -> torch.Tensor:
    """(*lead, p, mb, a, b) pieces, a rank axis after ``lead`` leading
    axes -> (p, (*lead) mb, a, b): the rank axis first and the leading
    axes folded into the blocks, factor-major (:func:`assemble_blocks`'s
    input)."""
    D = D.movedim(lead, 0)
    return D.reshape(D.shape[0], -1, *D.shape[-2:])


def assemble_blocks(Dg: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """(p, m, a, b) gathered pieces (x-major rank axis) -> (m, a p1,
    b p1 p2) full blocks in natural element order."""
    p, m, a, b = Dg.shape
    R = Dg.reshape(p1, p1, p2, m, a, b)            # [x, y, z, i, l, c']
    R = R.permute(3, 4, 0, 5, 2, 1)                # [i, l, x, c', z, y]
    return R.reshape(m, a * p1, b * p2 * p1)


def _cyclic_piece(blocks, x, y, z, p1: int, p2: int):
    """(m, s, s) full blocks -> the piece of rank (x, y, z): rows
    r = l p1 + x, cols c = c' p1 p2 + z p1 + y."""
    m, s, _ = blocks.shape
    a, b = s // p1, s // (p1 * p2)
    R = blocks.reshape(m, a, p1, b, p2, p1)        # [i, l, x, c', z, y]
    return R[:, :, x, :, z, y]


def _pieces_for_all(blocks, p1: int, p2: int):
    """(m, s, s) full blocks -> (p, m, s/p1, s/(p1 p2)) pieces for every
    destination rank, x-major rank order."""
    m, s, _ = blocks.shape
    a, b = s // p1, s // (p1 * p2)
    R = blocks.reshape(m, a, p1, b, p2, p1)        # [i, l, x, c', z, y]
    R = R.permute(2, 5, 4, 0, 1, 3)                # [x, y, z, i, l, c']
    return R.reshape(p1 * p1 * p2, m, a, b)


# --------------------------- phase A ---------------------------

def _invert_diag_blocks_inplace(L, *, n, s0, p1, p2, block_inv, mode=None):
    """Invert the n/s0 diagonal s0-blocks of the contiguous piece L in
    place.  At p > 1 ``mode`` routes them: "alltoall" (p | n/s0) sends
    whole blocks to ranks and their inverses back, "allgather" gathers
    them all to every rank.  Leading axes of L are a stack of factors
    (under ``comm.vmapped``), routed by the same collectives."""
    if p1 * p1 * p2 == 1:
        d = diag_blocks(L, s0)
        d.copy_(invert_blocks(d, block_inv))
        return L
    m0 = n // s0
    p = p1 * p1 * p2
    D = diag_pieces(L, m0)                         # (..., m0, a, b) view
    lead = tuple(D.shape[:-3])
    if mode == "alltoall":
        if m0 % p:
            raise ValueError(f"alltoall routing needs p | n/s0 "
                             f"(n/s0={m0}, p={p})")
        mb = m0 // p
        Dr = comm.all_to_all(D, MESH_AXES, split_axis=0, concat_axis=0,
                             tiled=True)           # (..., m0, a, b)
        Dr = by_rank(Dr.reshape(lead + (p, mb) + tuple(Dr.shape[-2:])),
                     len(lead))
        binv = invert_blocks(assemble_blocks(Dr, p1, p2), block_inv)
        S = _pieces_for_all(binv, p1, p2)          # (p, (...) mb, a, b)
        S = S.reshape((p,) + lead + (mb,) + tuple(S.shape[-2:])).movedim(
            0, len(lead))                          # (..., p, mb, a, b)
        D.copy_(comm.all_to_all(S.reshape(D.shape), MESH_AXES,
                                split_axis=0, concat_axis=0, tiled=True))
    elif mode == "allgather":
        x, y, z = comm.current_mesh().coords
        Dg = comm.all_gather(D, MESH_AXES, axis=0, tiled=False)
        binv = invert_blocks(assemble_blocks(by_rank(Dg, len(lead)), p1,
                                             p2), block_inv)
        D.copy_(_cyclic_piece(binv, x, y, z, p1, p2).reshape(D.shape))
    else:
        raise ValueError(f"unknown phase-A mode {mode!r}")
    return L


# --------------------------- phase B ---------------------------

def _doubling_levels(L, *, s0, s_hi, p1=1, p2=1):
    """Run doubling levels s = s0 .. s_hi/2 on the contiguous piece
    (..., nl, ncl) of an order-N matrix in place, finalizing the
    off-diagonal block of every diagonal 2s-block up to block size
    s_hi.  Leading axes are independent matrices (one batch of the
    products)."""
    p = p1 * p1 * p2
    N = L.shape[-1] * p1 * p2
    s = s0
    while s < s_hi:
        if p == 1:
            blk = diag_blocks(L, 2 * s)            # (..., nb, 2s, 2s) view
            a11 = blk[..., :s, :s]                 # inverted already
            a22 = blk[..., s:, s:]                 # inverted already
            l21 = blk[..., s:, :s]                 # original entries
            T = mm3d_shard(l21, a11, m=s, n=s, k=s, p1=1, p2=1)
            l21.copy_(-mm3d_shard(a22, T, m=s, n=s, k=s, p1=1, p2=1))
        else:
            blk = diag_pieces(L, N // (2 * s))     # (..., nb, al, bl) view
            al, bl = blk.shape[-2:]
            a11, a22 = blk[..., :al // 2, :bl // 2], blk[..., al // 2:,
                                                         bl // 2:]
            l21 = blk[..., al // 2:, :bl // 2]
            shape = l21.shape

            def flat(t):
                return t.reshape(-1, *t.shape[-2:])
            T = mm3d_shard_batched(flat(l21), flat(a11), m=s, n=s, k=s,
                                   p1=p1, p2=p2)
            new = mm3d_shard_batched(flat(a22), T, m=s, n=s, k=s, p1=p1,
                                     p2=p2)
            l21.copy_(-new.reshape(shape))
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
    """How phase A routes its blocks over p ranks: all-to-all when the
    n/s0 blocks split evenly, else all-gather (at p = 1 both are the
    identity)."""
    m0 = n // s0
    return "alltoall" if m0 % p == 0 else "allgather"


def _check_s0(n: int, s0: int) -> None:
    """The doubling pairs blocks level by level, so n/s0 must be a power
    of two (the reference's shapes fail an assertion otherwise)."""
    if s0 < 1 or n % s0 or (n // s0) & (n // s0 - 1):
        raise ValueError(f"s0={s0} must tile n={n} in a power-of-two "
                         f"number of blocks")


def tri_inv_shard(Lloc, *, n, p1, p2, s0=None, block_inv=None, mode=None):
    """Per-rank body: this rank's piece of the inverse of the
    lower-triangular (n, n) L whose piece is Lloc (a new tensor; Lloc is
    not written).  At p > 1 run it under ``comm.on_mesh``."""
    s0 = s0 or pick_s0(n, p1, p2)
    _check_s0(n, s0)
    mode = mode or phase_a_mode(n, s0, p1 * p1 * p2)
    L = Lloc.clone(memory_format=torch.contiguous_format)
    _invert_diag_blocks_inplace(L, n=n, s0=s0, p1=p1, p2=p2,
                                block_inv=block_inv, mode=mode)
    return _doubling_levels(L, s0=s0, s_hi=n, p1=p1, p2=p2)


def block_diag_inv_shard(Lloc, *, n, n0, p1, p2, s0=None, block_inv=None,
                         mode=None):
    """Per-rank body: invert only the n/n0 diagonal n0-blocks (the
    paper's Diagonal-Inverter) by the same two phases, the doubling
    stopped at block size n0.  Off-diagonal panels between n0-blocks
    are untouched."""
    if n0 < 1 or n % n0:
        raise ValueError(f"n0={n0} does not tile n={n}")
    s0 = min(s0 or pick_s0(n, p1, p2), n0)
    _check_s0(n0, s0)
    mode = mode or phase_a_mode(n, s0, p1 * p1 * p2)
    L = Lloc.clone(memory_format=torch.contiguous_format)
    _invert_diag_blocks_inplace(L, n=n, s0=s0, p1=p1, p2=p2,
                                block_inv=block_inv, mode=mode)
    if s0 < n0:
        # the doubling runs on each n0-block alone: the (n/n0, ...)
        # stack of their pieces is the leading batch axis
        d = diag_pieces(L, n // n0)
        d.copy_(_doubling_levels(d.contiguous(), s0=s0, s_hi=n0, p1=p1,
                                 p2=p2))
    return L


def tri_inv_fn(grid: TrsmGrid, n: int, s0: int | None = None,
               block_inv=None, mode: str | None = None):
    """The inversion for fixed shapes on ``grid``: this rank's cyclic
    piece in, its piece of the inverse out.  ``block_inv`` defaults to
    the kernel hook."""
    gridlib.require_mesh(grid)
    body = functools.partial(tri_inv_shard, n=n, p1=grid.p1, p2=grid.p2,
                             s0=s0, block_inv=block_inv, mode=mode)

    def fn(Lloc):
        with comm.on_mesh(grid.mesh):
            return body(Lloc)
    return fn


def invert(L, grid: TrsmGrid, s0: int | None = None,
           mode: str | None = None):
    """L^-1 of a natural-layout lower-triangular (n, n) L on ``grid``,
    returned on every rank (at p = 1 the cyclic permutations are the
    identity).  fp32 GEMMs run in IEEE fp32."""
    preclib.pin_matmul_numerics()
    n = L.shape[0]
    p1, p2 = grid.p1, grid.p2
    if grid.p == 1:
        L = torch.as_tensor(L, device=grid.device)
        Lc = gridlib.cyclic_matrix_device(L, p1, p1 * p2)
        out = tri_inv_fn(grid, n, s0=s0, mode=mode)(Lc)
        return gridlib.cyclic_matrix_device(out, p1, p1 * p2, inverse=True)
    Lloc = gridlib.local_piece(L, grid, "L")
    out = tri_inv_fn(grid, n, s0=s0, mode=mode)(Lloc)
    return gridlib.gather_natural(out, grid, "L", n, n)
