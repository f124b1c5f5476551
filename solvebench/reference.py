"""The plain reference: plain PyTorch, in float64, independent of the
program.

It works the served factor out again from the statistics the benchmark
made, with a frozen copy of the damping rule, and judges each solution
the program returned by its residual against that factor:

    L = chol(M + lam I),   lam = damping * (trace(M) / d + 1e-12)
    relres(x, b) = ||L x - b|| / ||b||
"""

from __future__ import annotations

import torch


def damped(M: torch.Tensor, damping: float) -> torch.Tensor:
    """M + lam I with the preconditioner's trace-scaled damping (a
    frozen copy of the rule, not an import of it)."""
    d = M.shape[-1]
    lam = damping * (torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
                     / d + 1e-12)
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    return M + lam[..., None, None] * eye


def factor64(M: torch.Tensor, damping: float) -> torch.Tensor:
    """The damped factor in float64."""
    return torch.linalg.cholesky(damped(M.double(), damping))


def relres(L64: torch.Tensor, X: torch.Tensor, B: torch.Tensor) \
        -> torch.Tensor:
    """Each column's ||L X - B|| / ||B|| in float64; X and B (n, j) or
    stacks (..., n, j) of the same shape, leading n rows of X taken
    where the program padded it."""
    X64 = X[..., :L64.shape[-1], :].double()
    B64 = B.double()
    return torch.linalg.vector_norm(L64 @ X64 - B64, dim=-2) \
        / torch.linalg.vector_norm(B64, dim=-2)
