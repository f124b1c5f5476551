"""Processor grids and cyclic layouts for the TRSM algorithms.

The paper runs on a p1 x p1 x p2 grid with *cyclic* data layouts,
realized as permuted storage: the global array is stored
row/column-permuted so that a contiguous block shard corresponds to a
stride-p cyclic index set (ScaLAPACK-style block-cyclic storage).

Conventions used by all distributed algorithms (as in the reference's
``repro.core.grid``):

* mesh axes ("x", "y", "z") with sizes (p1, p1, p2), one process per
  rank, rank = (x p1 + y) p2 + z (``comm.rank_of``);
* L: rows cyclic over x (global row g = l p1 + x), columns cyclic over
  the pair rank t = z p1 + y with stride p1 p2 -- the reference's
  P("x", ("z", "y"));
* B: rows cyclic over x, columns blocked over z, replicated over y --
  P("x", "z");
* X (It-Inv's output): rows cyclic over y, columns blocked over z,
  replicated over x -- P("y", "z");
* the recursive TRSM's B and X: L's layout, P("x", ("z", "y")).

:func:`local_piece` cuts this rank's piece of a natural-layout matrix
with one ``index_select`` per axis (the reversal of the upper and
transposed solves folded in); :func:`gather_natural` is its inverse,
one all-gather over the mesh.  At p = 1 every cyclic permutation is the
identity, and the only gather left is the reversal (DESIGN.md Sec. 3).
A grid of any p without a device (``solver.plan_grid``) carries the
processor arithmetic of a plan.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core import precision as preclib


@dataclasses.dataclass(frozen=True)
class TrsmGrid:
    """A p1 x p1 x p2 processor grid, seen from one rank: this rank's
    ``device`` and, at p > 1, its :class:`~repro_torch.core.comm.Mesh`
    (coordinates and process groups).  ``device=None`` marks a
    plan-only grid: specs can be planned on it, programs cannot be
    built."""
    device: torch.device | None
    p1: int
    p2: int
    mesh: comm.Mesh | None = None

    @property
    def p(self) -> int:
        return self.p1 * self.p1 * self.p2

    @property
    def coords(self) -> tuple:
        """This rank's (x, y, z)."""
        return self.mesh.coords if self.mesh is not None else (0, 0, 0)


def make_trsm_mesh(p1: int, p2: int, device=None,
                   timeout=None) -> TrsmGrid:
    """The grid every solve runs on.  ``device`` defaults to ``cuda:0``
    and raises when CUDA is missing; pass ``device="cpu"`` to run the
    kernels' plain versions on the CPU.

    A grid with p = p1 * p1 * p2 > 1 runs one rank per process: call it
    in each of the p processes of an initialized ``torch.distributed``
    world of size p (otherwise it raises).  Ranks may share a device
    (gloo, which stages CUDA tensors through the host) or have one each
    (``device=f"cuda:{local_rank}"``, NCCL).  ``timeout`` (a
    ``timedelta``) bounds each collective of the mesh's groups."""
    mesh = comm.make_mesh(p1, p2, timeout) if p1 * p1 * p2 > 1 else None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        device = "cuda:0"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    preclib.pin_matmul_numerics()
    return TrsmGrid(device, p1, p2, mesh)


# ------------------------- cyclic storage helpers -------------------------

def cyclic_perm(n: int, p: int) -> np.ndarray:
    """Permutation mapping storage order -> global index for a stride-p
    cyclic layout: storage position (chunk r, slot l) holds global r + l*p."""
    return np.concatenate([np.arange(r, n, p) for r in range(p)])


def inv_perm(perm: np.ndarray) -> np.ndarray:
    out = np.empty_like(perm)
    out[perm] = np.arange(perm.size)
    return out


def to_cyclic_matrix(L, p_row: int, p_col: int):
    """Natural -> cyclic storage of a matrix (rows stride p_row, columns
    stride p_col), whole, where it lives.  This changes storage, not the
    operator: the algorithms index pieces with the cyclic map."""
    return L[cyclic_perm(L.shape[0], p_row)][:, cyclic_perm(L.shape[1],
                                                           p_col)]


def from_cyclic_matrix(L, p_row: int, p_col: int):
    """Cyclic -> natural storage: the inverse of :func:`to_cyclic_matrix`."""
    return L[inv_perm(cyclic_perm(L.shape[0], p_row))][
        :, inv_perm(cyclic_perm(L.shape[1], p_col))]


def cyclic_row_index(n: int, p: int, *, inverse: bool = False,
                     reverse: bool = False) -> np.ndarray:
    """Gather index realizing the cyclic-storage permutation along one
    axis, optionally composed with the reversal identity into a SINGLE
    gather.

    forward (natural -> cyclic):  out[i] = a[idx[i]], idx = perm or
        (n-1-perm) when ``reverse``.
    inverse (cyclic -> natural):  idx = perm^-1, or perm^-1 reversed
        when ``reverse``.
    The two compose to the identity for matching flags."""
    perm = cyclic_perm(n, p)
    if inverse:
        idx = inv_perm(perm)
        return np.ascontiguousarray(idx[::-1]) if reverse else idx
    return (n - 1 - perm) if reverse else perm


@functools.lru_cache(maxsize=256)
def _gather_index(n: int, p: int, inverse: bool, reverse: bool,
                  device: torch.device) -> torch.Tensor:
    """The gather index on ``device``, uploaded once per (shape, flags,
    device): a program's first call builds it, every later call reuses
    it, so the steady state uploads nothing."""
    idx = cyclic_row_index(n, p, inverse=inverse, reverse=reverse)
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def cyclic_rows_device(a: torch.Tensor, p: int, *, inverse: bool = False,
                       reverse: bool = False) -> torch.Tensor:
    """Natural <-> cyclic storage permutation along the row axis (axis 0
    of an (n, k) operand, axis -2 of a stacked (..., n, k) operand) as
    one ``index_select`` where the operand lives.  The identity (p = 1
    without reversal) returns ``a`` itself."""
    if p == 1 and not reverse:
        return a
    axis = max(a.ndim - 2, 0)
    idx = _gather_index(a.shape[axis], p, inverse, reverse, a.device)
    return a.index_select(axis, idx)


def cyclic_matrix_device(A: torch.Tensor, p_row: int, p_col: int, *,
                         inverse: bool = False, reverse_rows: bool = False,
                         reverse_cols: bool = False,
                         transpose: bool = False) -> torch.Tensor:
    """Natural <-> cyclic storage permutation of a matrix, or of a stack
    of matrices (the permutations apply to the trailing two axes).

    Composes (optional) transposition, applied first, and (optional)
    per-axis reversal with the two cyclic gathers, so an upper or
    transposed factor is admitted by the same gathers as a lower one.
    The result is contiguous."""
    if transpose:
        A = A.transpose(-2, -1)
    if p_row > 1 or reverse_rows:
        A = A.index_select(A.ndim - 2, _gather_index(
            A.shape[-2], p_row, inverse, reverse_rows, A.device))
    if p_col > 1 or reverse_cols:
        A = A.index_select(A.ndim - 1, _gather_index(
            A.shape[-1], p_col, inverse, reverse_cols, A.device))
    return A.contiguous()


# what a p > 1 grid does not run yet says so with this
NEXT_SLICE = ("comes with the next slice of the distributed port (ROADMAP "
              "A12)")


def require_mesh(grid: TrsmGrid) -> None:
    """Raise unless ``grid`` can run a program: a device and, at p > 1,
    this rank's mesh (a ``solver.plan_grid`` has neither)."""
    if grid.device is None or (grid.p > 1 and grid.mesh is None):
        raise ValueError("a plan-only grid (plan_grid) cannot run a "
                         "program: build it on make_trsm_mesh")


# --------------------------- local pieces (p > 1) ---------------------------
#
# A layout names, per axis, which mesh coordinate owns a row or column
# and how: ("x", p1) rows g = l p1 + x; ("t", p1 p2) columns c p1 p2 + t
# with t = z p1 + y; ("zblock", p2) the z-th of p2 contiguous column
# blocks.  An axis's owners that do not appear are replicated over.

LAYOUTS = {
    "L": ("x", "t"),             # P("x", ("z", "y")): factors, rec's B/X
    "B": ("x", "zblock"),        # P("x", "z"): It-Inv's right-hand side
    "X": ("y", "zblock"),        # P("y", "z"): It-Inv's solution
}


def _owner(kind: str, x: int, y: int, z: int, p1: int, p2: int) -> tuple:
    """(owner index, count of owners) of one axis of a layout."""
    return {"x": (x, p1), "y": (y, p1), "t": (z * p1 + y, p1 * p2),
            "zblock": (z, p2)}[kind]


def _axis_index(kind: str, n: int, owner: int, count: int,
                reverse: bool) -> np.ndarray:
    """The natural indices, in piece order, of one owner's part of an
    axis of length n (reversed: the indices of the reversed array)."""
    if kind == "zblock":
        w = n // count
        idx = np.arange(owner * w, (owner + 1) * w)
        return (n - 1 - idx) if reverse else idx
    return cyclic_row_index(n, count, reverse=reverse)[
        owner * (n // count):(owner + 1) * (n // count)]


@functools.lru_cache(maxsize=256)
def _piece_index(layout: str, n: int, p1: int, p2: int, coords: tuple,
                 reverse: bool, axis: int, device: torch.device):
    x, y, z = coords
    kind = LAYOUTS[layout][axis]
    idx = _axis_index(kind, n, *_owner(kind, x, y, z, p1, p2), reverse)
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def local_piece(A, grid: TrsmGrid, layout: str, *, dtype=None,
                reverse_rows: bool = False, reverse_cols: bool = False,
                transpose: bool = False) -> torch.Tensor:
    """This rank's piece of the natural-layout matrix ``A`` (transposed
    first if ``transpose``, then each axis reversed as asked) in
    ``layout`` ("L", "B" or "X"), contiguous, on the grid's device at
    ``dtype``: one ``index_select`` per axis, run where ``A`` lives, so
    only the piece crosses to the device."""
    A = torch.as_tensor(A)
    if transpose:
        A = A.transpose(-2, -1)
    coords = grid.coords
    for axis, rev in ((0, reverse_rows), (1, reverse_cols)):
        idx = _piece_index(layout, A.shape[axis - 2], grid.p1, grid.p2,
                           coords, rev, axis, A.device)
        A = A.index_select(A.ndim - 2 + axis, idx)
    return A.to(grid.device, dtype).contiguous()


@functools.lru_cache(maxsize=64)
def _natural_index(layout: str, n: int, k: int, p1: int, p2: int,
                   reverse_rows: bool, device: torch.device):
    """(ranks, flat natural index of every element of their pieces):
    one owning rank per piece (replicas left out), x-major order."""
    ranks, dest = [], []
    seen = set()
    for r in range(p1 * p1 * p2):
        x, y, z = comm.coords_of(r, p1, p2)
        owners = tuple(_owner(kind, x, y, z, p1, p2)
                       for kind in LAYOUTS[layout])
        if owners in seen:
            continue
        seen.add(owners)
        rows = _axis_index(LAYOUTS[layout][0], n, *owners[0], reverse_rows)
        cols = _axis_index(LAYOUTS[layout][1], k, *owners[1], False)
        ranks.append(r)
        dest.append((rows[:, None] * k + cols[None, :]).reshape(-1))
    return (torch.as_tensor(ranks, dtype=torch.int64, device=device),
            torch.as_tensor(np.concatenate(dest), dtype=torch.int64,
                            device=device))


def gather_natural(piece: torch.Tensor, grid: TrsmGrid, layout: str, n: int,
                   k: int, *, reverse_rows: bool = False) -> torch.Tensor:
    """The natural (n, k) matrix whose ``layout`` pieces the ranks hold,
    on every rank: one all-gather of the pieces over the mesh (not
    recorded in a cost trace), then one scatter into place.  Inverse of
    :func:`local_piece` with the same ``reverse_rows``.  Leading axes
    of the piece (a stack) are kept: (..., n, k) out."""
    with comm.on_mesh(grid.mesh), comm.vmapped(0, exact=True):
        G = comm.gather_all_unrecorded(piece)       # (p, ..., nl, kl)
    ranks, dest = _natural_index(layout, n, k, grid.p1, grid.p2,
                                 reverse_rows, piece.device)
    lead = tuple(piece.shape[:-2])
    src = G.index_select(0, ranks).movedim(0, len(lead))
    out = torch.empty(lead + (n * k,), dtype=piece.dtype,
                      device=piece.device)
    out[..., dest] = src.reshape(lead + (-1,))
    return out.view(lead + (n, k))


def cyclic_piece(L_cyc, grid: TrsmGrid, *, dtype=None) -> torch.Tensor:
    """This rank's "L" piece of a factor already in the whole cyclic
    storage the producers emit (``to_cyclic_matrix(L, p1, p1 p2)``, the
    same on every rank), or of an (..., n, n) stack of them: cyclic
    storage holds each rank's piece as one contiguous block, rows x's
    and columns t's (t = z p1 + y), so the piece is a slice, cut where
    ``L_cyc`` lives, then moved to the grid's device at ``dtype``."""
    L_cyc = torch.as_tensor(L_cyc)
    x, y, z = grid.coords
    nl = L_cyc.shape[-2] // grid.p1
    ncl = L_cyc.shape[-1] // (grid.p1 * grid.p2)
    t = z * grid.p1 + y
    piece = L_cyc[..., x * nl:(x + 1) * nl, t * ncl:(t + 1) * ncl]
    return piece.to(grid.device, dtype, copy=True).contiguous()


def check_divisibility(n: int, k: int, n0: int, grid: TrsmGrid) -> None:
    p1, p2 = grid.p1, grid.p2
    if n % n0:
        raise ValueError(f"n0={n0} does not tile n={n}")
    if n0 % (p1 * p2):
        raise ValueError(f"need p1*p2 | n0 for contiguous local diagonal "
                         f"blocks (n0={n0}, p1={p1}, p2={p2})")
    if k % p2:
        raise ValueError(f"need p2 | k (k={k}, p2={p2})")
