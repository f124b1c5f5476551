"""Eager PyTorch oracles for every kernel of the port (the counterparts
of ``repro.kernels.ref``): library solves and products the tests hold
the kernels' plain versions against."""

from __future__ import annotations

import torch


def trmm_ref(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """C = tril(L) @ X."""
    return torch.tril(L) @ X


def tri_inv_blocks_ref(Ls: torch.Tensor) -> torch.Tensor:
    """Batched lower-triangular inversion: (m, n0, n0) -> inverses."""
    eye = torch.eye(Ls.shape[-1], dtype=Ls.dtype, device=Ls.device)
    return torch.linalg.solve_triangular(torch.tril(Ls),
                                         eye.expand_as(Ls), upper=False)


def trsm_ref(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with tril(L) X = B."""
    return torch.linalg.solve_triangular(torch.tril(L), B, upper=False)
