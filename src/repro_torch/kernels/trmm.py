"""Triangular matrix-matrix product  C = tril(L) @ X  (kernel B2).

The It-Inv-TRSM solve step X_i = Dt_i @ B_i: Dt_i is the inverted
lower-triangular diagonal block, so the product skips every tile above
the diagonal.  :func:`trmm` launches the hand-written CUDA kernel
(``csrc/trmm.cu``, replacing the Pallas kernel of
``repro.kernels.trmm``) on CUDA tensors and runs :func:`trmm_plain`,
the same function in plain PyTorch, on CPU tensors.

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


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(build.library("trmm"), f"repro_trmm_{_SUFFIX[dtype]}")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, P, LL, P, LL, I, I, P]
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


def trmm(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """C = tril(L) @ X for L (n, n), X (n, k), or batches (b, n, n) and
    (b, n, k) whose matrices have contiguous rows (the batch stride is
    free, so slices of a stacked bank pass without a copy)."""
    if L.device.type == "cpu" and X.device.type == "cpu":
        return trmm_plain(L, X)
    _check(L, X)
    if L.device.type != "cuda":
        raise ValueError(f"trmm runs on CUDA or CPU tensors, got "
                         f"{L.device}")
    batched = L.ndim == 3
    n, k = X.shape[-2:]
    b = L.shape[0] if batched else 1
    C = torch.empty((b, n, k) if batched else (n, k), dtype=X.dtype,
                    device=X.device)
    with torch.cuda.device(L.device):
        status = _entry(L.dtype)(
            L.data_ptr(), L.stride(0) if batched else 0,
            X.data_ptr(), X.stride(0) if batched else 0,
            C.data_ptr(), b, n, k,
            torch.cuda.current_stream(L.device).cuda_stream)
    build.check(status, "trmm")
    trmm.launches += 1
    return C


trmm.launches = 0
