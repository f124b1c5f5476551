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


def tri_inv_blocks_valid_ref(Ls: torch.Tensor, valid) -> torch.Tensor:
    """Batched inversion of the blocks flagged 1 in ``valid`` and zeros
    for the blocks flagged 0 (inverted as the identity in their place,
    so their L never enters the solve)."""
    v = torch.as_tensor(valid, device=Ls.device).reshape(-1, 1, 1) != 0
    eye = torch.eye(Ls.shape[-1], dtype=Ls.dtype, device=Ls.device)
    inv = tri_inv_blocks_ref(torch.where(v, Ls, eye))
    return torch.where(v, inv, torch.zeros_like(inv))


def trsm_ref(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with tril(L) X = B."""
    return torch.linalg.solve_triangular(torch.tril(L), B, upper=False)


def trmm_masked_ref(L: torch.Tensor, X: torch.Tensor, block_mask,
                    bt: int) -> torch.Tensor:
    """C = tril(L) @ X with the (bt x bt) blocks whose mask entry is 0
    taken as zero."""
    mask = torch.as_tensor(block_mask, device=L.device).bool()
    elem = mask.repeat_interleave(bt, 0).repeat_interleave(bt, 1)
    return torch.where(elem, torch.tril(L), torch.zeros_like(L)) @ X


def trsm_valid_ref(L: torch.Tensor, B: torch.Tensor, valid) -> torch.Tensor:
    """X with tril(L) X = B for each system of an (m, n0, n0) stack
    flagged 1 in ``valid``, and X = 0 for each one flagged 0 (solved
    against the identity, so its L never enters the solve)."""
    v = torch.as_tensor(valid, device=L.device).reshape(-1, 1, 1) != 0
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    X = trsm_ref(torch.where(v, L, eye), B)
    return torch.where(v, X, torch.zeros_like(X))
