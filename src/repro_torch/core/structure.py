"""Block structure of triangular factors (DESIGN.md Sec. 14), the
counterpart of ``repro.core.structure``.

:class:`FactorStructure` is a frozen, hashable description of where
the nonzero blocks of a lower-triangular factor live:

  * ``dense``              — every block at or below the diagonal;
  * ``banded(bandwidth)``  — element band: L[i, j] == 0 when
                             i - j > bandwidth;
  * ``block_sparse(mask)`` — an explicit boolean block mask at the
                             mask's own granularity (n / len(mask)).

:func:`analyze` runs once per (structure, n, n0) at admission and is
lru-cached; everything it returns is plain Python data, so a program
makes its skip decisions when it is built.  It gives the block mask at
the serving block size n0 (OR-coarsened from another granularity, the
diagonal blocks always present), a level schedule of the block rows,
per-column update spans ``(lo, hi)`` (or None: column i has no
off-diagonal block, so the sweep skips its update) and the nonzero
counts the cost model prices.

Structure is a promise enforced at admission: :func:`apply_block_mask`
zeroes every element outside the block mask with ``torch.where`` —
never a multiply, which would leak 0 * NaN and flip -0.0 — so the
skipped blocks are exact zeros.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["FactorStructure", "StructureInfo", "analyze", "block_counts",
           "apply_block_mask"]

_KINDS = ("dense", "banded", "block_sparse")


@dataclass(frozen=True)
class FactorStructure:
    """Frozen, hashable block-structure descriptor; part of the
    ``SolveSpec`` cache key, so two factors with the same structure
    share one program.  Construct it with ``FactorStructure.dense()``,
    ``.banded(bw)``, ``.block_sparse(mask)`` or :meth:`parse`."""

    kind: str = "dense"
    bandwidth: int | None = None          # banded: element band width
    mask: tuple | None = None             # block_sparse: nested bools

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"structure kind must be one of {_KINDS}, got "
                f"{self.kind!r}")
        if self.kind == "banded":
            if self.bandwidth is None or int(self.bandwidth) < 1:
                raise ValueError(
                    "banded structure needs bandwidth >= 1 "
                    f"(got {self.bandwidth!r})")
            object.__setattr__(self, "bandwidth", int(self.bandwidth))
        elif self.bandwidth is not None:
            raise ValueError(f"{self.kind} structure takes no bandwidth")
        if self.kind == "block_sparse":
            m = np.asarray(self.mask, dtype=bool)
            if m.ndim != 2 or m.shape[0] != m.shape[1] or m.shape[0] < 1:
                raise ValueError(
                    f"block_sparse mask must be square 2-D, got shape "
                    f"{m.shape}")
            # nested tuples: hashable, and equality is structural
            object.__setattr__(
                self, "mask", tuple(tuple(bool(x) for x in row)
                                    for row in m))
        elif self.mask is not None:
            raise ValueError(f"{self.kind} structure takes no mask")

    @classmethod
    def dense(cls) -> "FactorStructure":
        return cls("dense")

    @classmethod
    def banded(cls, bandwidth: int) -> "FactorStructure":
        return cls("banded", bandwidth=bandwidth)

    @classmethod
    def block_sparse(cls, mask) -> "FactorStructure":
        return cls("block_sparse", mask=mask)

    @classmethod
    def parse(cls, text: str, n: int | None = None) -> "FactorStructure":
        """Parse a CLI string: ``dense``, ``banded``/``banded:BW``,
        ``block-sparse``/``block_sparse``.

        Bare ``banded`` takes bandwidth n//8 (so it needs ``n``) and
        bare ``block-sparse`` an 8x8 mask: the diagonal, the first
        subdiagonal and the bottom-left corner block."""
        text = text.strip().lower().replace("-", "_")
        if text == "dense":
            return cls.dense()
        if text.startswith("banded"):
            _, _, bw = text.partition(":")
            if bw:
                return cls.banded(int(bw))
            if n is None:
                raise ValueError("bare 'banded' needs n for the n//8 "
                                 "default; use banded:<bandwidth>")
            return cls.banded(max(1, n // 8))
        if text == "block_sparse":
            g = 8
            m = np.eye(g, dtype=bool) | np.eye(g, k=-1, dtype=bool)
            m[g - 1, 0] = True
            return cls.block_sparse(m)
        raise ValueError(f"unknown structure {text!r} (want dense, "
                         "banded[:BW], block-sparse)")

    @property
    def is_dense(self) -> bool:
        return self.kind == "dense"

    def validate_for(self, n: int, *, lower: bool = True,
                     transpose: bool = False) -> None:
        """Check this structure fits an order-n factor.  A non-dense
        structure takes the plain lower, non-transposed operator only:
        the reversal gather of the other variants would invalidate the
        mask."""
        if self.is_dense:
            return
        if not lower or transpose:
            raise ValueError(
                "structured factors support lower=True, "
                "transpose=False only (the reversal gather would "
                "invalidate the block mask)")
        if self.kind == "banded" and self.bandwidth >= n:
            raise ValueError(
                f"bandwidth {self.bandwidth} >= n {n}: use dense")
        if self.kind == "block_sparse":
            g = len(self.mask)
            if n % g:
                raise ValueError(
                    f"block_sparse mask granularity {g} must divide "
                    f"n={n}")

    def block_mask(self, n: int, n0: int) -> np.ndarray:
        """(m, m) bool mask at block size n0 (m = n // n0): block (i, j)
        is True when the factor may hold a nonzero there.  Diagonal
        blocks are always True and blocks above the diagonal always
        False; a block_sparse mask of another granularity is
        OR-coarsened (a block is kept if any cell it overlaps is)."""
        if n % n0:
            raise ValueError(f"n0={n0} must divide n={n}")
        m = n // n0
        ii = np.arange(m)
        if self.kind == "dense":
            out = ii[:, None] >= ii[None, :]
        elif self.kind == "banded":
            # the nearest element pair of block (i, j), j < i, is
            # (i n0, (j + 1) n0 - 1): distance (i - j) n0 - (n0 - 1)
            d = ii[:, None] - ii[None, :]
            out = (d >= 0) & (d * n0 - (n0 - 1) <= self.bandwidth)
        else:
            src = np.asarray(self.mask, dtype=bool)
            g = n // src.shape[0]          # element rows per mask cell
            # cover[i, c]: block i's rows [i n0, (i + 1) n0) meet cell c;
            # block (i, j) is kept when a cell of i's rows and j's
            # columns is set (float32 counts are exact here)
            cells = np.arange(src.shape[0])
            lo, hi = ii * n0 // g, ((ii + 1) * n0 + g - 1) // g
            cover = ((cells >= lo[:, None])
                     & (cells < hi[:, None])).astype(np.float32)
            out = (cover @ src.astype(np.float32) @ cover.T) > 0
        out = np.array(out, dtype=bool)
        np.fill_diagonal(out, True)
        return np.tril(out)

    def nnz_blocks(self, n: int, n0: int) -> int:
        return int(self.block_mask(n, n0).sum())


@dataclass(frozen=True)
class StructureInfo:
    """The admission-time analysis of one (structure, n, n0): plain,
    hashable Python data."""

    n: int
    n0: int
    mask: tuple                       # (m, m) nested bool tuples
    levels: tuple                     # level[i] per block row
    spans: tuple                      # per column: (lo, hi) or None
    nnz_offdiag: int                  # off-diagonal nonzero blocks
    update_cols: int                  # columns with >= 1 dependent

    @property
    def m(self) -> int:
        return self.n // self.n0

    @property
    def n_levels(self) -> int:
        return 1 + max(self.levels) if self.levels else 0

    @property
    def full(self) -> bool:
        """True when no block at or below the diagonal is left out: the
        structure is dense at this block size."""
        return self.nnz_offdiag == self.m * (self.m - 1) // 2

    def mask_array(self) -> np.ndarray:
        return np.asarray(self.mask, dtype=bool)


@functools.lru_cache(maxsize=512)
def analyze(structure: FactorStructure, n: int, n0: int) -> StructureInfo:
    """Block mask, level schedule, update spans and nonzero counts of a
    structure at block size n0; pure and cached, run once at
    admission."""
    bm = structure.block_mask(n, n0)
    m = n // n0
    levels = np.zeros(m, dtype=int)
    for i in range(m):
        deps = np.nonzero(bm[i, :i])[0]
        if deps.size:
            levels[i] = 1 + int(levels[deps].max())
    spans = []
    for j in range(m):
        dep = np.nonzero(bm[j + 1:, j])[0]
        if dep.size:
            spans.append((j + 1 + int(dep[0]), j + 2 + int(dep[-1])))
        else:
            spans.append(None)
    return StructureInfo(
        n=n, n0=n0,
        mask=tuple(tuple(bool(x) for x in row) for row in bm),
        levels=tuple(int(x) for x in levels),
        spans=tuple(spans),
        nnz_offdiag=int(bm.sum() - m),
        update_cols=sum(1 for s in spans if s is not None),
    )


@functools.lru_cache(maxsize=512)
def block_counts(structure: FactorStructure, n: int, n0: int) -> tuple:
    """``(m, nnz_offdiag, update_cols)`` of :func:`analyze`, the counts
    the cost model prices, without the schedule's per-block tuples
    (the planner scans block sizes down to n0 = 1)."""
    bm = structure.block_mask(n, n0)
    m = n // n0
    return m, int(bm.sum()) - m, int(np.tril(bm, -1).any(axis=0).sum())


def apply_block_mask(L: torch.Tensor, structure: FactorStructure,
                     n0: int) -> torch.Tensor:
    """Zero every element of L (an (n, n) factor or a stack of them)
    outside the structure's block mask at block size n0.

    ``torch.where``, not a multiply: 0 * NaN would leak into the zero
    blocks and a multiply flips -0.0, breaking the full-mask == dense
    identity.  The mask goes to L's device as (m, m) blocks and is
    expanded there.  A dense structure returns L itself."""
    if structure.is_dense:
        return L
    n = L.shape[-1]
    bm = torch.as_tensor(structure.block_mask(n, n0), device=L.device)
    elem = bm.repeat_interleave(n0, 0).repeat_interleave(n0, 1)
    return torch.where(elem, L, torch.zeros((), dtype=L.dtype,
                                            device=L.device))
