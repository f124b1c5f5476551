"""Local (single-device) blocked triangular primitives.

The numerical building blocks and oracles of the solve path:

* ``tri_inv_doubling`` — bottom-up ("recursive doubling") triangular
  inversion, the SPMD-friendly re-derivation of the paper's RecTriInv
  (Sec. V): level ``s`` finalizes the off-diagonal block of every
  diagonal ``2s``-block with two batched GEMMs
  (``inv([[A,0],[B,C]]) = [[A^-1,0],[-C^-1 B A^-1, C^-1]]``).
* ``block_diag_invert`` — invert only the ``n/n0`` diagonal blocks
  (the paper's Diagonal-Inverter output ``L~``).
* ``it_inv_trsm_local`` — the single-device schedule of It-Inv-TRSM
  (Sec. VI): multiply by pre-inverted diagonal blocks + trailing GEMM
  updates; no substitution in the sweep.
* ``rec_trsm_local`` / ``forward_substitution`` — the recursive
  baseline (Sec. IV) and the row-by-row substitution it bottoms out in,
  as single-device oracles.
* reversal identities reducing upper/transposed solves to the lower case.

Every function takes a leading batch of matrices where the reference
maps one with ``vmap``.
"""

from __future__ import annotations

import torch


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def diag_blocks(a: torch.Tensor, s: int) -> torch.Tensor:
    """The (..., n/s, s, s) diagonal blocks of a (..., n, n) matrix, as
    a view."""
    n = a.shape[-1]
    nb = n // s
    v = a.reshape(*a.shape[:-2], nb, s, nb, s)
    return torch.diagonal(v, dim1=-4, dim2=-2).movedim(-1, -3)


def _set_diag_blocks(a: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    out = a.clone(memory_format=torch.contiguous_format)  # reshape = view
    diag_blocks(out, blocks.shape[-1]).copy_(blocks)
    return out


def tri_inv_doubling(L: torch.Tensor) -> torch.Tensor:
    """Invert a lower-triangular matrix (or a (..., n, n) stack) by
    bottom-up block doubling: log2(n) levels, each two batched GEMMs
    over all off-diagonal blocks at that level.  Pads to the next power
    of two with an identity block (``inv([[L,0],[0,I]]) =
    [[L^-1,0],[0,I]]``)."""
    n = L.shape[-1]
    N = next_pow2(n)
    if N != n:
        Lp = torch.eye(N, dtype=L.dtype, device=L.device).expand(
            *L.shape[:-2], N, N).clone()
        Lp[..., :n, :n] = L
        L = Lp
    eye = torch.eye(N, dtype=L.dtype, device=L.device)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    A = L * (1.0 - eye) + torch.diag_embed(1.0 / d)
    s = 1
    while s < N:
        blk = diag_blocks(A, 2 * s)            # (..., nb, 2s, 2s)
        a11i = blk[..., :s, :s]                # already inverted
        a22i = blk[..., s:, s:]                # already inverted
        l21 = blk[..., s:, :s]                 # still original L entries
        new21 = -(a22i @ l21 @ a11i)
        blk = blk.clone()
        blk[..., s:, :s] = new21
        A = _set_diag_blocks(A, blk)
        s *= 2
    return A[..., :n, :n] if N != n else A


def tri_inv_batched(Ls: torch.Tensor) -> torch.Tensor:
    """tri_inv_doubling over a stack (m, n0, n0)."""
    return tri_inv_doubling(Ls)


def block_diag_invert(L: torch.Tensor, n0: int) -> torch.Tensor:
    """Return L~: L with every (n0 x n0) diagonal block inverted in
    place (the output contract of the paper's Diagonal-Inverter: the
    off-diagonal panels are untouched)."""
    n = L.shape[-1]
    if n % n0:
        raise ValueError(f"n0={n0} does not tile n={n}")
    return _set_diag_blocks(L, tri_inv_batched(diag_blocks(L, n0)))


def it_inv_trsm_local(L: torch.Tensor, B: torch.Tensor, n0: int,
                      block_inv=None) -> torch.Tensor:
    """It-Inv-TRSM (paper Sec. VI) on one device: solve L X = B.

    1. Invert the diagonal n0-blocks (the "inversion" phase).
    2. Sweep i = 0..n/n0-1:  X_i = L~_ii @ B_i (GEMM, not substitution),
       then the trailing update B_{>i} -= L[>i, S_i] @ X_i.

    ``block_inv``: optional override for the batched diagonal-block
    inverter (e.g. ``kernels.ops.block_inv_kernel``); defaults to
    :func:`tri_inv_batched`.  L (..., n, n) and B (..., n, k) may carry
    leading batch axes: the diagonal blocks of every system go to the
    inverter as one (M, n0, n0) stack."""
    n = L.shape[-1]
    if n % n0:
        raise ValueError(f"n0={n0} does not tile n={n}")
    m = n // n0
    inv_fn = block_inv if block_inv is not None else tri_inv_batched
    d = diag_blocks(L, n0)                                # (..., m, n0, n0)
    dblocks = inv_fn(d.reshape(-1, n0, n0).contiguous()).reshape(d.shape)
    Bcur = B.clone()
    X = torch.zeros_like(B)
    for i in range(m):
        rows = slice(i * n0, (i + 1) * n0)
        Xi = dblocks[..., i, :, :] @ Bcur[..., rows, :]   # solve via GEMM
        X[..., rows, :] = Xi
        Bcur[..., (i + 1) * n0:, :] -= L[..., (i + 1) * n0:, rows] @ Xi
    return X


def rec_trsm_local(L: torch.Tensor, B: torch.Tensor, n0: int) -> torch.Tensor:
    """Recursive TRSM baseline (paper Sec. IV) on one device.

    Splits L into quadrants until n <= n0; the base case is a library
    triangular solve.  Python recursion over static shapes, as in the
    paper's recursion."""
    n = L.shape[-1]
    if n <= n0:
        return torch.linalg.solve_triangular(L, B, upper=False)
    h = n // 2
    L11, L21, L22 = L[..., :h, :h], L[..., h:, :h], L[..., h:, h:]
    X1 = rec_trsm_local(L11, B[..., :h, :], n0)
    B2 = B[..., h:, :] - L21 @ X1
    X2 = rec_trsm_local(L22, B2, n0)
    return torch.cat([X1, X2], dim=-2)


def forward_substitution(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Row-by-row forward substitution with the full-length row dot
    (the rows of X not yet solved are zero).  Reference only."""
    X = torch.zeros_like(B)
    for i in range(L.shape[-1]):
        X[..., i, :] = (B[..., i, :] - (L[..., i:i + 1, :] @ X)[..., 0, :]) \
            / L[..., i, i, None]
    return X


# ----- reductions of the other triangular cases to the lower-left one -----

def solve_lower(L, B, solver, **kw):
    return solver(L, B, **kw)


def solve_upper(U, B, solver, **kw):
    """U X = B via the reversal identity: J U J is lower-triangular."""
    Lr = U.flip(-2, -1)
    return solver(Lr, B.flip(-2), **kw).flip(-2)


def solve_lower_t(L, B, solver, **kw):
    """L^T X = B (upper solve with the lower factor) via reversal."""
    return solve_upper(L.transpose(-2, -1), B, solver, **kw)


def spd_solve(L_chol, B, solver, **kw):
    """A^-1 B given A = L L^T: two triangular solves (the K-FAC use)."""
    Y = solve_lower(L_chol, B, solver, **kw)
    return solve_lower_t(L_chol, Y, solver, **kw)
