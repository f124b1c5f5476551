"""Triangular matrix-matrix product  C = tril(L) @ X  (kernels B2, B4).

B2 is the It-Inv-TRSM solve step X_i = Dt_i @ B_i: Dt_i is the
inverted lower-triangular diagonal block, so the product skips every
tile above the diagonal.  B4 (:func:`trmm_masked`, or :func:`trmm` with
``block_mask=``) also skips every (bt x bt) block whose entry in a block
mask is 0, and never reads it: the refinement residual of a structured
factor, with the structure's mask at bt = n0.  Both launch the
hand-written CUDA kernels of ``csrc/trmm.cu`` (replacing the Pallas
kernels of ``repro.kernels.trmm``) on CUDA tensors and run their plain
PyTorch versions, :func:`trmm_plain` and :func:`trmm_masked_plain`, on
CPU tensors.

Partial sums are fp32 for fp32 and bf16 operands (double for fp64);
the result has X's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float64: "f64"}


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def trmm_plain(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """C = tril(L) @ X with fp32 (fp64) partial sums, in X's dtype."""
    acc = _acc(X.dtype)
    return torch.matmul(torch.tril(L).to(acc), X.to(acc)).to(X.dtype)


def trmm_masked_plain(L: torch.Tensor, X: torch.Tensor, block_mask,
                      bt: int) -> torch.Tensor:
    """C = tril(L) @ X with the (bt x bt) blocks whose ``block_mask``
    entry is 0 left out: a ``torch.where`` on the element-expanded mask
    (so NaN in a left-out block does not reach C), then the product
    with fp32 (fp64) partial sums, in X's dtype."""
    acc = _acc(X.dtype)
    mask = torch.as_tensor(block_mask, device=L.device).bool()
    elem = mask.repeat_interleave(bt, 0).repeat_interleave(bt, 1)
    Lm = torch.where(elem, torch.tril(L),
                     torch.zeros((), dtype=L.dtype, device=L.device))
    return torch.matmul(Lm.to(acc), X.to(acc)).to(X.dtype)


@functools.cache
def _entry(dtype: torch.dtype, masked: bool = False):
    name = "repro_trmm_masked_" if masked else "repro_trmm_"
    fn = getattr(build.library("trmm"), name + _SUFFIX[dtype])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, P, LL, P, LL, I, I] + ([P, I] if masked
                                                 else []) + [P]
    fn.restype = I
    return fn


def _check(L: torch.Tensor, X: torch.Tensor) -> None:
    if L.device != X.device:
        raise ValueError(f"L on {L.device}, X on {X.device}")
    if L.dtype != X.dtype or L.dtype not in _SUFFIX:
        raise TypeError(f"trmm takes matching float32/bfloat16/float64 "
                        f"operands, got {L.dtype} and {X.dtype}")
    if L.ndim not in (2, 3) or X.ndim != L.ndim:
        raise ValueError(f"trmm takes (n, n) @ (n, k) or (b, n, n) @ "
                         f"(b, n, k), got {tuple(L.shape)} and "
                         f"{tuple(X.shape)}")
    n, k = X.shape[-2:]
    if L.shape[-2:] != (n, n) or L.shape[:-2] != X.shape[:-2] \
            or n < 1 or k < 1:
        raise ValueError(f"shape mismatch: L {tuple(L.shape)}, X "
                         f"{tuple(X.shape)}")
    for name, t, cols in (("L", L, n), ("X", X, k)):
        if t.stride(-1) != 1 or (t.shape[-2] > 1 and t.stride(-2) != cols):
            raise ValueError(f"{name} must have contiguous rows, got "
                             f"strides {t.stride()}")


def _launch(L: torch.Tensor, X: torch.Tensor, *mask_args) -> torch.Tensor:
    """Launch B2, or B4 when ``mask_args`` is (mask pointer, bt), on
    checked CUDA operands; returns C."""
    batched = L.ndim == 3
    n, k = X.shape[-2:]
    b = L.shape[0] if batched else 1
    C = torch.empty((b, n, k) if batched else (n, k), dtype=X.dtype,
                    device=X.device)
    with torch.cuda.device(L.device):
        status = _entry(L.dtype, bool(mask_args))(
            L.data_ptr(), L.stride(0) if batched else 0,
            X.data_ptr(), X.stride(0) if batched else 0,
            C.data_ptr(), b, n, k, *mask_args,
            torch.cuda.current_stream(L.device).cuda_stream)
    build.check(status, "trmm_masked" if mask_args else "trmm")
    return C


def trmm(L: torch.Tensor, X: torch.Tensor, block_mask=None,
         bt: int | None = None) -> torch.Tensor:
    """C = tril(L) @ X for L (n, n), X (n, k), or batches (b, n, n) and
    (b, n, k) whose matrices have contiguous rows (the batch stride is
    free, so slices of a stacked bank pass without a copy).  With a
    ``block_mask`` this is :func:`trmm_masked` (kernel B4, counted
    there); without one, kernel B2."""
    if block_mask is not None:
        return trmm_masked(L, X, block_mask, bt)
    if L.device.type == "cpu" and X.device.type == "cpu":
        return trmm_plain(L, X)
    _check(L, X)
    if L.device.type != "cuda":
        raise ValueError(f"trmm runs on CUDA or CPU tensors, got "
                         f"{L.device}")
    C = _launch(L, X)
    trmm.launches += 1
    return C


trmm.launches = 0


def trmm_masked(L: torch.Tensor, X: torch.Tensor, block_mask: torch.Tensor,
                bt: int) -> torch.Tensor:
    """C = tril(L) @ X with every (bt x bt) block whose ``block_mask``
    entry is 0 skipped and never read (kernel B4).  Operands as for
    :func:`trmm`; ``bt`` divides n and the (n/bt, n/bt) mask, shared by
    a batch, is an int32 tensor on the operands' device (so a launch
    copies nothing from the host)."""
    if L.device.type == "cpu" and X.device.type == "cpu":
        return trmm_masked_plain(L, X, block_mask, bt)
    _check(L, X)
    if L.device.type != "cuda":
        raise ValueError(f"trmm_masked runs on CUDA or CPU tensors, got "
                         f"{L.device}")
    n = X.shape[-2]
    if not isinstance(bt, int) or bt < 1 or n % bt:
        raise ValueError(f"block size bt={bt!r} must divide n={n}")
    if not isinstance(block_mask, torch.Tensor) \
            or block_mask.dtype != torch.int32 \
            or block_mask.device != L.device \
            or tuple(block_mask.shape) != (n // bt, n // bt) \
            or not block_mask.is_contiguous():
        raise ValueError(
            f"block_mask must be a contiguous ({n // bt}, {n // bt}) "
            f"int32 tensor on {L.device}, got "
            f"{getattr(block_mask, 'dtype', type(block_mask))} "
            f"{tuple(getattr(block_mask, 'shape', ()))} on "
            f"{getattr(block_mask, 'device', None)}")
    C = _launch(L, X, block_mask.data_ptr(), bt)
    trmm_masked.launches += 1
    return C


trmm_masked.launches = 0
