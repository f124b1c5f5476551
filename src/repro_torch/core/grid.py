"""Processor grids and cyclic layouts for the TRSM algorithms.

The paper runs on a p1 x p1 x p2 grid with *cyclic* data layouts,
realized as permuted storage: the global array is stored
row/column-permuted so that a contiguous block shard corresponds to a
stride-p cyclic index set (ScaLAPACK-style block-cyclic storage).

This package runs the 1 x 1 x 1 grid on one device.  There every
cyclic permutation is the identity, and the only gather left is the
reversal that reduces upper / transposed solves to the lower case
(DESIGN.md Sec. 3).  A grid of any p without a device
(``solver.plan_grid``) carries the processor arithmetic of a plan;
running on grids with p > 1 waits for the distributed port (ROADMAP
A12).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import precision as preclib


@dataclasses.dataclass(frozen=True)
class TrsmGrid:
    """A p1 x p1 x p2 processor grid; at p = 1 it is one ``device``.
    ``device=None`` marks a plan-only grid: specs can be planned on it,
    programs cannot be built."""
    device: torch.device | None
    p1: int
    p2: int

    @property
    def p(self) -> int:
        return self.p1 * self.p1 * self.p2


def make_trsm_mesh(p1: int, p2: int, device=None) -> TrsmGrid:
    """The grid every solve runs on.  ``device`` defaults to ``cuda:0``
    and raises when CUDA is missing; pass ``device="cpu"`` to run the
    kernels' plain versions on the CPU."""
    if p1 * p1 * p2 != 1:
        raise NotImplementedError(
            f"grid p1={p1}, p2={p2} spans {p1 * p1 * p2} devices; only the "
            f"1 x 1 x 1 grid is ported (distribution on torch.distributed "
            f"is ROADMAP A12)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        device = "cuda:0"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    preclib.pin_matmul_numerics()
    return TrsmGrid(device, p1, p2)


# ------------------------- cyclic storage helpers -------------------------

def cyclic_perm(n: int, p: int) -> np.ndarray:
    """Permutation mapping storage order -> global index for a stride-p
    cyclic layout: storage position (chunk r, slot l) holds global r + l*p."""
    return np.concatenate([np.arange(r, n, p) for r in range(p)])


def inv_perm(perm: np.ndarray) -> np.ndarray:
    out = np.empty_like(perm)
    out[perm] = np.arange(perm.size)
    return out


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


def check_divisibility(n: int, k: int, n0: int, grid: TrsmGrid) -> None:
    p1, p2 = grid.p1, grid.p2
    if n % n0:
        raise ValueError(f"n0={n0} does not tile n={n}")
    if n0 % (p1 * p2):
        raise ValueError(f"need p1*p2 | n0 for contiguous local diagonal "
                         f"blocks (n0={n0}, p1={p1}, p2={p2})")
    if k % p2:
        raise ValueError(f"need p2 | k (k={k}, p2={p2})")
