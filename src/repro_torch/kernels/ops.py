"""Public wrappers for the hand-written kernels.

``trmm`` (with ``block_mask=``, the masked kernel ``trmm_masked``),
``tri_inv_blocks`` (with ``valid=``, the validity-gated kernel B5),
``trsm_substitution`` (with ``valid=``, the validity-gated kernel B6)
and ``gemm`` (the tri-GEMM's tiles as a product summed in one order
whatever the shape) run the CUDA kernel on a CUDA tensor and the
kernel's plain PyTorch version on a CPU tensor; a meta tensor gets an
empty meta result of the kernel's shape and dtype, and no launch
(``comm.traced_cost`` runs programs so).
``block_inv_kernel`` is the drop-in hook for the solvers' ``block_inv=``
parameter, and the port's default diagonal-block inverter.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.tri_inv_block import tri_inv_blocks  # noqa: F401
from repro_torch.kernels.trmm import gemm, trmm, trmm_masked  # noqa: F401
from repro_torch.kernels.trsm_block import trsm_substitution  # noqa: F401


def block_inv_kernel(blocks: torch.Tensor, valid=None) -> torch.Tensor:
    """Hook matching the ``block_inv`` signature of the solvers:
    (m, n0, n0) -> batched inverses, through :func:`tri_inv_blocks` on
    every device.  B1 takes powers of two only (1 included), so a block
    of another order goes in as ``blockdiag(L, I)`` of the next power of
    two (``inv([[L, 0], [0, I]]) = [[L^-1, 0], [0, I]]``) and its
    leading block comes back.  ``valid`` (an (m,) mask on the blocks'
    device) zeroes every block flagged 0 without reading it (kernel B5).

    Degenerate blocks are rejected eagerly: a zero-sized batch or a
    0x0 / non-square block would otherwise reach a launch with a
    0-extent grid."""
    if blocks.ndim != 3:
        raise ValueError(
            f"block_inv_kernel expects a (m, n0, n0) stack of blocks, "
            f"got ndim={blocks.ndim} shape={tuple(blocks.shape)}")
    m, r, n0 = blocks.shape
    if r != n0:
        raise ValueError(
            f"diagonal blocks must be square, got {r}x{n0} "
            f"(shape={tuple(blocks.shape)})")
    if m == 0 or n0 == 0:
        raise ValueError(
            f"degenerate block batch {tuple(blocks.shape)}: zero-sized "
            f"batches cannot be inverted — check n0 / grid divisibility "
            f"upstream")
    if n0 & (n0 - 1) == 0:
        return tri_inv_blocks(blocks.contiguous(), valid)
    N = 1 << (n0 - 1).bit_length()
    padded = torch.eye(N, dtype=blocks.dtype, device=blocks.device).repeat(
        m, 1, 1)
    padded[:, :n0, :n0] = blocks
    return tri_inv_blocks(padded, valid)[:, :n0, :n0]
