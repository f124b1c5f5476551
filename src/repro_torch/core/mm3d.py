"""3D matrix multiplication from a 2D cyclic start (paper Sec. III).

Computes B = L @ X on the p1 x p1 x p2 mesh ("x", "y", "z") where L, X
and B all live in L's cyclic storage (``repro_torch.core.grid``): rows
cyclic over x, columns cyclic over the pair t = z p1 + y with stride
p1 p2.  Operand and result layouts coincide, so products compose (the
triangular inversion and the recursive TRSM rely on it).

Schedule (the reference's ``repro.core.mm3d``, paper Alg. MM):

    1. Lg = allgather(L, z)       L's columns of this y-residue
    2. Xs = permute x<->y         X's rows become y-residues
    3. Xg = allgather(Xs, x)      X's columns of this z-slice
    4. P  = Lg @ Xg               local GEMM
    5. B  = reduce-scatter(P, y)  sum the partials, keep column chunk y

The local GEMM is a plain cuBLAS product (``precision.matmul_as``), as
the reference leaves it to ``lax.dot`` outside any Pallas kernel.  At
p = 1 every collective is the identity and the body is that product
alone: partial sums at the accumulate dtype, the result rounded once to
the operand dtype.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import comm
from repro_torch.core import grid as gridlib
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.precision import matmul_as


def _swap_perm(p1: int) -> list[tuple[int, int]]:
    """Permutation over the linearized ("x","y") pair sending (x,y)->(y,x)."""
    return [(x * p1 + y, y * p1 + x) for x in range(p1) for y in range(p1)]


def _local_product(A, B, acc, fixed_order: bool) -> torch.Tensor:
    """A @ B at ``acc``: cuBLAS, or with ``fixed_order`` ``ops.gemm`` on
    operands cast to ``acc`` (each element summed over the contraction
    in one order, whatever the shapes)."""
    if not fixed_order:
        return matmul_as(A, B, acc, acc)
    from repro_torch.kernels import ops
    lead = A.shape[:-2]
    # the tri-GEMM reads A's columns at unit stride: a gathered panel
    # one column wide can reshape to a view whose columns lie apart
    out = ops.gemm(A.to(acc).reshape(-1, *A.shape[-2:]).contiguous(),
                   B.to(acc).reshape(-1, *B.shape[-2:]).contiguous())
    return out.reshape(lead + out.shape[-2:])


def _masked_product(Lg, Xg, block_mask, bt: int) -> torch.Tensor:
    """tril(Lg) @ Xg over the blocks ``block_mask`` keeps (kernel B4),
    leading axes flattened into B4's batch; the result has Xg's dtype,
    its partial sums fp32 (fp64 for fp64 operands)."""
    from repro_torch.kernels import ops
    lead = Lg.shape[:-2]
    out = ops.trmm(Lg.reshape(-1, *Lg.shape[-2:]).contiguous(),
                   Xg.to(Lg.dtype).reshape(-1, *Xg.shape[-2:]).contiguous(),
                   block_mask=block_mask, bt=bt)
    return out.reshape(lead + out.shape[-2:])


def mm3d_shard(Lloc: torch.Tensor, Xloc: torch.Tensor, *, m: int, n: int,
               k: int, p1: int, p2: int, accum_dtype=None,
               fixed_order: bool = False, block_mask=None,
               bt: int | None = None) -> torch.Tensor:
    """The per-rank body: Lloc (..., m/p1, n/(p1 p2)) and Xloc
    (..., n/p1, k/(p1 p2)), this rank's cyclic pieces, -> its piece of
    L @ X, (..., m/p1, k/(p1 p2)).  Leading axes (a bank's factor axis
    at p = 1, :func:`mm3d_shard_batched`'s batch, a stack under
    ``comm.vmapped``) multiply alike.  ``accum_dtype`` is the precision
    of the partial sums and of the cross-y reduction; the result has X's
    dtype.  ``fixed_order`` forms the local GEMM with ``ops.gemm``
    (:func:`_local_product`).

    ``block_mask`` (an (m/bt', m/bt') int32 mask on the device, bt' =
    bt p1, with m == n) forms the local product of a lower-triangular L
    that a structure masks with the block-masked ``trmm`` (kernel B4)
    at block size ``bt``, and takes precedence over ``fixed_order``.
    It is exact there: after step 1, Lg = L[x::p1, y::p1] in natural
    order, so its (bt x bt) block (I, J) is the (x, y) sub-lattice of
    the global block (I, J) and the global mask is every rank's; and
    each diagonal block of Lg is lower triangular (strictly so where
    x < y), so B4's tril drops nothing."""
    acc = accum_dtype if accum_dtype is not None else Xloc.dtype
    if p1 * p1 * p2 == 1:
        if Lloc.shape[-2:] != (m, n) or Xloc.shape[-2:] != (n, k):
            raise ValueError(f"mm3d_shard shapes {tuple(Lloc.shape)} @ "
                             f"{tuple(Xloc.shape)} for m={m}, n={n}, k={k}")
        if block_mask is not None:
            return _masked_product(Lloc, Xloc, block_mask, bt).to(
                Xloc.dtype)
        if fixed_order:
            return _local_product(Lloc, Xloc, acc, True).to(Xloc.dtype)
        return matmul_as(Lloc, Xloc, acc, Xloc.dtype)
    ml, ncl = Lloc.shape[-2:]
    nl, kcl = Xloc.shape[-2:]
    if (ml, ncl, nl, kcl) != (m // p1, n // (p1 * p2), n // p1,
                              k // (p1 * p2)):
        raise ValueError(f"mm3d_shard pieces {tuple(Lloc.shape)} @ "
                         f"{tuple(Xloc.shape)} for m={m}, n={n}, k={k}, "
                         f"p1={p1}, p2={p2}")
    lead = Lloc.shape[:-2]
    # 1. replicate L over z; realign the gathered columns (z-major) to
    #    X's row order l = c' p2 + z
    if p2 > 1:
        Lg = comm.all_gather(Lloc, "z", axis=1, tiled=True)
        Lg = Lg.reshape(*lead, ml, p2, ncl).transpose(-1, -2).reshape(
            *lead, ml, ncl * p2)
    else:
        Lg = Lloc
    # 2-3. move X's rows from x-residues to y-residues, then replicate
    #      the z-slice's columns over x (columns end x'-major)
    if p1 > 1:
        Xs = comm.ppermute(Xloc, ("x", "y"), _swap_perm(p1))
        Xg = comm.all_gather(Xs, "x", axis=1, tiled=True)
    else:
        Xg = Xloc
    # 4. local GEMM over the y-residue class of the contraction
    if block_mask is not None:
        Pp = _masked_product(Lg, Xg, block_mask, bt).to(acc)
    else:
        Pp = _local_product(Lg, Xg, acc, fixed_order)
    # 5. finish the contraction over y; keep column chunk x' == y, which
    #    is the input layout
    if p1 > 1:
        Pp = comm.psum_scatter(Pp, "y", scatter_dimension=1, tiled=True)
    return Pp.to(Xloc.dtype)


def mm3d_shard_batched(Lloc, Xloc, *, m, n, k, p1, p2, accum_dtype=None):
    """:func:`mm3d_shard` over ONE leading batch axis, one collective
    per step for the whole batch, priced per example (the reference's
    vmap of the body).  The operands' leading axes are the whole batch,
    so it counts one batch axis whatever vmapped body encloses it."""
    with comm.vmapped(1, exact=True):
        return mm3d_shard(Lloc, Xloc, m=m, n=n, k=k, p1=p1, p2=p2,
                          accum_dtype=accum_dtype)


def mm3d_fn(grid: TrsmGrid, m: int, n: int, k: int):
    """The distributed product for fixed shapes on ``grid``: this rank's
    cyclic pieces of L and X in, its piece of L @ X out."""
    gridlib.require_mesh(grid)
    body = functools.partial(mm3d_shard, m=m, n=n, k=k, p1=grid.p1,
                             p2=grid.p2)

    def fn(Lloc, Xloc):
        with comm.on_mesh(grid.mesh):
            return body(Lloc, Xloc)
    return fn


def matmul(L, X, grid: TrsmGrid) -> torch.Tensor:
    """Natural-layout entry point: L (m, n) @ X (n, k) on ``grid``,
    returned on every rank.  Each rank cuts its cyclic pieces, the
    product runs distributed, and one gather assembles the result (in
    real use operands stay in cyclic storage across calls)."""
    L, X = torch.as_tensor(L), torch.as_tensor(X)
    m, n = L.shape
    if X.shape[0] != n:
        raise ValueError(f"matmul shapes {tuple(L.shape)} @ "
                         f"{tuple(X.shape)}")
    k = X.shape[1]
    Lloc = gridlib.local_piece(L, grid, "L")
    Xloc = gridlib.local_piece(X, grid, "L")
    Bloc = mm3d_fn(grid, m, n, k)(Lloc, Xloc)
    if grid.p == 1:
        return Bloc
    return gridlib.gather_natural(Bloc, grid, "L", m, k)
