"""Carry state across from the JAX package.

:func:`bank_from_reference` builds a :class:`FactorBank` from another
bank's resident stacks given as NumPy arrays — ``(L_lo, Dt[, L_hi])``
as ``repro``'s ``FactorBank.stacks()`` returns them — so the port's
sweep can be held against the reference's on the SAME inverted blocks.
Nothing here imports ``jax``: the caller converts the arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bank import FactorBank
from repro_torch.core.grid import make_trsm_mesh


def to_tensor(a, device=None) -> torch.Tensor:
    """A NumPy array as a torch tensor on ``device``.  bfloat16 arrays
    (NumPy's ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    go through a uint16 view of the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device) if device is not None else t


def bank_from_reference(arrays, spec_fields: dict, device) -> FactorBank:
    """An append-only bank holding the given resident stacks verbatim.

    ``arrays``: ``(L_lo, Dt[, L_hi])``, each with a leading factor axis
    (M, ...), in the 1 x 1 x 1 grid's storage (which is natural layout
    with the operator reduction folded in).  ``spec_fields``: the
    :class:`FactorBank` keywords the stacks were admitted under —
    ``n`` plus any of ``n0``, ``lower``, ``transpose``, ``precision``,
    ``dtype``.  Raises when the stacks do not fit the fields."""
    fields = dict(spec_fields)
    n = fields.pop("n")
    bank = FactorBank(make_trsm_mesh(1, 1, device=device), n, **fields)
    stacks = tuple(to_tensor(a, bank.grid.device) for a in arrays)
    pol = bank.policy
    want = [((n, n), pol.storage),
            ((n // bank.n0, bank.n0, bank.n0), pol.storage)]
    if pol.refines:
        want.append(((n, n), pol.residual))
    M = stacks[0].shape[0] if stacks else 0
    if len(stacks) != len(want) or M < 1 or any(
            tuple(t.shape) != (M,) + shape or t.dtype != dt
            for t, (shape, dt) in zip(stacks, want)):
        raise ValueError(
            f"stacks {[(tuple(t.shape), t.dtype) for t in stacks]} do not "
            f"match the roles {[((M,) + s, d) for s, d in want]}")
    bank._chunks.append(stacks)
    bank._size = M
    return bank
