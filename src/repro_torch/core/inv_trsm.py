"""It-Inv-TRSM (the paper's main contribution, Secs. VI-VII).

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

At p = 1 (:func:`invert_diag_blocks`, :func:`sweep`) every tensor
carries a leading factor axis (the bank width M) where the reference
maps one factor with ``vmap``.

At p > 1 (:func:`invert_diag_blocks_shard`, :func:`sweep_shard`, one
factor or a leading stack of them, a bank's, each collective once for
the stack and priced per factor) each rank runs the body on its cyclic
pieces (``repro_torch.core.grid``): L's, B's (rows cyclic over x, columns
blocked over z) and X's (rows cyclic over y).  Phase 1 has the
reference's three modes:

* "alltoall" (p | m): one all-to-all routes whole blocks to ranks, B1
  inverts them, one all-to-all routes the transposed-face pieces back;
* "doubling" (m < p): ``tri_inv.block_diag_inv_shard`` inverts the
  diagonal blocks cooperatively, then the faces are formed by one x<->y
  permute and one all-gather over z;
* "allgather" (any m): every rank gathers all diagonal blocks and B1
  inverts them redundantly.

Phase 1 leaves each rank the transposed face Dt_i = binv_i[y::p1, x::p1]
of every inverted block: rows of y's residue, columns of x's.  Being a
lower-triangular matrix's, it is itself lower triangular (strictly so
where y < x), so the sweep's solve step X_i = psum_x(Dt_i B_i) runs on
B2 (``ops.trmm``), which reads nothing it skips.  The update gathers
the panel over z (the paper's bcast), multiplies it with cuBLAS, sums
it over y and takes it off the rows below block i.  The per-iteration
collectives are the paper's: one allreduce over x, one gather over z,
one allreduce over y.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import blocked, comm
from repro_torch.core import tri_inv as ti
from repro_torch.core.comm import MESH_AXES
from repro_torch.core.grid import TrsmGrid, check_divisibility
from repro_torch.core.mm3d import _local_product, _swap_perm
from repro_torch.core.precision import matmul_as


def invert_diag_blocks(L: torch.Tensor, *, n0: int, block_inv: Callable,
                       accum_dtype=None, valid=None) -> torch.Tensor:
    """Phase 1: (M, n, n) factors -> Dt (M, m, n0, n0), the inverted
    diagonal blocks.

    When ``accum_dtype`` is wider than the operand dtype the inversion
    runs at the accumulate precision (cast up, invert, cast back): the
    inverse re-enters the sweep at compute precision, but its entries
    are formed at full accuracy (``bf16_refine`` inverts in fp32).

    ``valid`` (an (M * m,) mask over the blocks, factor-major) is passed
    through to the hook as ``block_inv(blocks, valid=valid)``: a block
    flagged 0 comes out as zeros without being read (kernel B5)."""
    M, n, _ = L.shape
    m = n // n0
    D = blocked.diag_blocks(L, n0).reshape(M * m, n0, n0)
    gate = {} if valid is None else dict(valid=valid)
    if accum_dtype is not None and accum_dtype != L.dtype:
        Dt = block_inv(D.to(accum_dtype), **gate).to(L.dtype)
    else:
        Dt = block_inv(D.contiguous(), **gate)
    return Dt.reshape(M, m, n0, n0)


def sweep(L: torch.Tensor, Dt: torch.Tensor, B: torch.Tensor, *, n0: int,
          accum_dtype=None, spans=None,
          fixed_order: bool = False) -> torch.Tensor:
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
    step is the same for every column.

    ``fixed_order`` forms each update with ``ops.gemm``, whose sums run
    in an order that does not depend on the number of trailing rows, in
    place of cuBLAS; it needs the kernel's own partial-sum dtype (fp32,
    fp64 for fp64 operands) as ``accum_dtype``."""
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
            Lb = L[:, below, rows]
            Bcur[:, below] -= ops.gemm(Lb, Xi) if fixed_order \
                else matmul_as(Lb, Xi, acc, ct)
    return X


def dt_shape(n: int, n0: int) -> tuple:
    """Logical shape of one factor's phase-1 output Dt: one (n0, n0)
    inverted block per diagonal block."""
    return (n // n0, n0, n0)


def pick_phase1_mode(n: int, n0: int, grid: TrsmGrid) -> str:
    """The reference's phase-1 scheme: "alltoall" when p | m (always at
    p = 1, where its routing is the identity), else "doubling" when the
    cooperative inversion's blocks tile n0, else "allgather"."""
    check_divisibility(n, grid.p2, n0, grid)
    if (n // n0) % grid.p == 0:
        return "alltoall"
    s0 = min(ti.pick_s0(n, grid.p1, grid.p2), n0)
    feasible = (s0 % (grid.p1 * grid.p2) == 0 and n0 % s0 == 0
                and (n0 // s0) & (n0 // s0 - 1) == 0)
    return "doubling" if feasible else "allgather"


# ------------------------------- p > 1 -------------------------------

def _pieces_all_dests(binv: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """For every destination (xd, yd, zd), the transposed-face piece
    (rows of yd's residue, columns of xd's) of each local block:
    (mb, n0, n0) -> (p, mb, a, a)."""
    mb, n0, _ = binv.shape
    a = n0 // p1
    R = binv.reshape(mb, a, p1, a, p1)             # (i, l, roff, c, coff)
    R = R.permute(4, 2, 0, 1, 3)                   # (xd, yd, i, l, c)
    R = R[:, :, None].expand(p1, p1, p2, mb, a, a)
    return R.reshape(p1 * p1 * p2, mb, a, a)


def invert_diag_blocks_shard(Lloc, *, n, n0, p1, p2, block_inv, mode,
                             accum_dtype=None, overlap=False, valid=None):
    """Phase 1 at p > 1: this rank's L piece (..., n/p1, n/(p1 p2)) ->
    Dt (..., m, n0/p1, n0/p1), the transposed faces of the inverted
    diagonal blocks.  Runs under ``comm.on_mesh``; leading axes are a
    stack of factors, which the body counts as ``comm.vmapped`` batch
    axes (one collective per step for the stack, priced per factor).  When ``accum_dtype`` is wider than L's dtype
    the blocks are inverted at it (cast up, invert, cast back), as the
    reference does.

    ``valid`` (..., m) flags the diagonal blocks (a padded admission's
    ``session.pad_block_mask``): a block flagged 0 gets a zero face.
    "alltoall" and "allgather" route the flags with the blocks to the
    hook (``block_inv(blocks, valid=...)``, kernel B5): rank f takes the
    flags of its blocks [f mb, (f + 1) mb), every rank all of them.
    The cooperative "doubling" inverts every block (B1 at its leaves:
    the flags cannot follow a block through the doubling's products)
    and zeroes the flagged faces after."""
    with comm.vmapped(Lloc.ndim - 2, exact=True):
        return _invert_diag_blocks_shard(
            Lloc, n=n, n0=n0, p1=p1, p2=p2, block_inv=block_inv, mode=mode,
            accum_dtype=accum_dtype, overlap=overlap, valid=valid)


def _invert_diag_blocks_shard(Lloc, *, n, n0, p1, p2, block_inv, mode,
                              accum_dtype, overlap, valid):
    if accum_dtype is not None and accum_dtype != Lloc.dtype:
        inner, ldt = block_inv, Lloc.dtype

        def block_inv(blocks, **gate):
            return inner(blocks.to(accum_dtype), **gate).to(ldt)
    m = n // n0
    p = p1 * p1 * p2
    a = n0 // p1
    x, y, _ = comm.current_mesh().coords
    D = ti.diag_pieces(Lloc, m)                    # (..., m, a, b) tiles
    lead = tuple(D.shape[:-3])
    if mode == "alltoall":
        if m % p:
            raise ValueError(f"alltoall phase 1 needs p | m (m={m}, p={p})")
        mb = m // p
        f = comm.axis_index(MESH_AXES)
        # rank f receives the pieces of blocks [f mb, (f + 1) mb)
        Dr = comm.all_to_all(D, MESH_AXES, split_axis=0, concat_axis=0,
                             tiled=True)
        Dr = ti.by_rank(Dr.reshape(lead + (p, mb) + tuple(D.shape[-2:])),
                        len(lead))
        mine = None if valid is None else valid[..., f * mb:(f + 1) * mb]
        binv = ti.invert_blocks(ti.assemble_blocks(Dr, p1, p2), block_inv,
                                mine)                  # ((...) mb, n0, n0)
        S = _pieces_all_dests(binv, p1, p2)        # (p, (...) mb, a, a)
        S = S.reshape((p,) + lead + (mb, a, a)).movedim(0, len(lead))
        return comm.all_to_all(S.reshape(lead + (p * mb, a, a)), MESH_AXES,
                               split_axis=0, concat_axis=0, tiled=True)
    if mode == "doubling":
        Linv = ti.block_diag_inv_shard(Lloc, n=n, n0=n0, p1=p1, p2=p2,
                                       block_inv=block_inv)
        Dd = ti.diag_pieces(Linv, m)               # (..., m, a, b) cyclic
        if p1 > 1:
            if overlap:
                Dd = comm.ppermute_finish(
                    comm.ppermute_start(Dd, ("x", "y"), _swap_perm(p1)))
            else:
                Dd = comm.ppermute(Dd, ("x", "y"), _swap_perm(p1))
        if p2 > 1:
            Dg = comm.all_gather(Dd, "z", axis=2, tiled=True)  # (m,a,p2 b)
            Dd = Dg.reshape(lead + (m, a, p2, -1)).transpose(-1, -2).reshape(
                lead + (m, a, a))
        Dd = Dd.contiguous()
        if valid is not None:
            Dd.mul_((valid != 0).to(Dd.dtype)[..., None, None])
        return Dd
    if mode == "allgather":
        Dg = comm.all_gather(D, MESH_AXES, axis=0, tiled=False)
        binv = ti.invert_blocks(ti.assemble_blocks(
            ti.by_rank(Dg, len(lead)), p1, p2), block_inv, valid)
        return binv[:, y::p1, x::p1].reshape(lead + (m, a, a)).contiguous()
    raise ValueError(f"unknown phase-1 mode {mode!r}")


def sweep_shard(Lloc, Dt, Bloc, *, n, k, n0, p1, p2, accum_dtype=None,
                overlap=False, prefetched0=None, fixed_order=False,
                spans=None):
    """Phase 2 at p > 1, unrolled, against the faces Dt of
    :func:`invert_diag_blocks_shard`: this rank's pieces of L, Dt and B
    (..., n/p1, k/p2) -> its piece of X (..., n/p1, k/p2), rows of y's
    residue.  Runs under ``comm.on_mesh``; B is not written.  Leading
    axes are a stack of factors (a bank), counted as ``comm.vmapped``
    batch axes: B2 on the stacked faces, one batched product per
    update, each collective once for the stack.

    The last column's update would only touch rows below the last
    block, so it is left out.  ``spans`` (from ``structure.analyze``,
    one ``(lo, hi)`` or None per column) makes the sweep
    LEVEL-SCHEDULED, as the reference's: block row g lives on the local
    rows [g a, (g + 1) a) of every rank (a = n0/p1), so column i's
    panel is cut to the rows of blocks [lo, hi) BEFORE its z-gather
    (fewer bytes staged, not only fewer flops), only those rows are
    updated, and a column whose span is None skips its update and both
    of the update's collectives.  ``overlap`` starts the next live
    column's panel gather before this column's update runs
    (``prefetched0``: the first live column's, started by the caller
    before phase 1); the operations and operands are those of the
    sequential sweep, so X is the same, bit for bit.  ``fixed_order``
    forms each update's local product with ``ops.gemm``
    (``mm3d._local_product``), its sums in an order that does not depend
    on the panel's row count."""
    with comm.vmapped(Bloc.ndim - 2, exact=True):
        return _sweep_shard(Lloc, Dt, Bloc, n=n, k=k, n0=n0, p1=p1, p2=p2,
                            accum_dtype=accum_dtype, overlap=overlap,
                            prefetched0=prefetched0, fixed_order=fixed_order,
                            spans=spans)


def _live_columns(m: int, spans) -> list:
    """The columns whose update runs: every one but the last, or, level
    scheduled, those with a span."""
    return [i for i in range(m - 1) if spans is None or spans[i] is not None]


def _panel_rows(i: int, nl: int, a: int, spans) -> tuple:
    """The local rows [r0, r1) of column i's panel: all of them, or the
    rows of the blocks in its span."""
    if spans is None:
        return 0, nl
    lo, hi = spans[i]
    return lo * a, hi * a


def _panel_start(Lloc, i: int, *, n, n0, p1, p2, spans):
    """Issue column i's panel z-gather (it reads only Lloc)."""
    b = n0 // (p1 * p2)
    r0, r1 = _panel_rows(i, n // p1, n0 // p1, spans)
    return comm.all_gather_start(Lloc[..., r0:r1, i * b:(i + 1) * b], "z",
                                 axis=0, tiled=False)


def _sweep_shard(Lloc, Dt, Bloc, *, n, k, n0, p1, p2, accum_dtype, overlap,
                 prefetched0, fixed_order, spans):
    from repro_torch.kernels import ops
    m = n // n0
    nl = n // p1
    a = n0 // p1
    ct = Bloc.dtype
    acc = accum_dtype if accum_dtype is not None else ct
    lead = tuple(Bloc.shape[:-2])

    def panel_start(i):
        return _panel_start(Lloc, i, n=n, n0=n0, p1=p1, p2=p2, spans=spans)

    live = _live_columns(m, spans)
    updates, succ = set(live), dict(zip(live, live[1:]))
    Bcur = Bloc.clone()
    X = torch.empty_like(Bloc)
    pending = None
    if live and overlap:
        pending = prefetched0 if prefetched0 is not None \
            else panel_start(live[0])
    for i in range(m):
        rows = slice(i * a, (i + 1) * a)
        # solve via GEMM (l. 4-5): the face is lower triangular, so B2;
        # partials and the cross-x sum at acc, X_i at ct
        part = ops.trmm(Dt[..., i, :, :].to(acc), Bcur[..., rows, :].to(acc))
        Xi = comm.psum(part, "x").to(ct)
        X[..., rows, :] = Xi
        if i not in updates:
            continue
        # update (l. 6-8): panel gathered over z, its columns t' = c p2 + z
        if overlap:
            pg = comm.all_gather_finish(pending)
            pending = panel_start(succ[i]) if i in succ else None
        else:
            pg = comm.all_gather_finish(panel_start(i))
        r0, r1 = _panel_rows(i, nl, a, spans)
        pg = pg.movedim(len(lead), -1).reshape(lead + (r1 - r0, a))
        upd = comm.psum(_local_product(pg, Xi, acc, fixed_order),
                        "y").to(ct)
        if spans is None:
            # the rows of the blocks below i (global row l p1 + x >=
            # (i+1) n0)
            Bcur[..., (i + 1) * a:, :] -= upd[..., (i + 1) * a:, :]
        else:
            # every span row is strictly below block i (lo >= i + 1)
            Bcur[..., r0:r1, :] -= upd
    return X


def phase1_prefetched(Lloc, *, n, n0, p1, p2, block_inv, mode,
                      accum_dtype=None, overlap=False, spans=None):
    """A one-shot solve's phase 1 at p > 1 (under ``comm.on_mesh``):
    ``(Dt, pre0)``, with ``pre0`` the first live column's panel gather
    (narrowed to its span under ``spans``) started before phase 1,
    which never reads it, when ``overlap`` (else None); the first
    :func:`sweep_shard` takes it as ``prefetched0``."""
    pre0 = None
    live = _live_columns(n // n0, spans)
    if overlap and live:
        with comm.vmapped(Lloc.ndim - 2, exact=True):
            pre0 = _panel_start(Lloc, live[0], n=n, n0=n0, p1=p1, p2=p2,
                                spans=spans)
    Dt = invert_diag_blocks_shard(Lloc, n=n, n0=n0, p1=p1, p2=p2,
                                  block_inv=block_inv, mode=mode,
                                  accum_dtype=accum_dtype, overlap=overlap)
    return Dt, pre0


def solve(L, B, grid: TrsmGrid, n0: int, *, block_inv=None,
          mode: str | None = None) -> torch.Tensor:
    """Natural-layout entry point: L (n, n), B (n, k) -> X, through the
    cached program of a :class:`repro_torch.core.solver.SolveSpec`
    (returned on every rank at p > 1)."""
    from repro_torch.core import precision as preclib
    from repro_torch.core.solver import SolveSpec, solver_for
    L = torch.as_tensor(L)
    n, k = B.shape
    spec = SolveSpec(n=n, k=k, grid=grid,
                     policy=preclib.resolve(None, L.dtype), method="inv",
                     n0=n0, mode=mode, block_inv=block_inv)
    prog = solver_for(spec)
    return prog.solve(prog.prep(L), B)
