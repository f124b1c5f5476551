"""Base-case TRSM by forward substitution  (kernel B3).

The row-serial solve the paper REPLACES with multiplications by
inverted blocks, kept as the recursive baseline's base case
(``repro_torch.core.rec_trsm``).  Row r of tril(L) X = B is

    x_r = (b_r - L[r, :r] . X[:r]) / L[r, r]

with the dot and the subtraction at ``accum_dtype`` and x_r stored in
X's dtype (B's), as the Pallas kernel of ``repro.kernels.trsm_block``
computes it.  The upper triangle of L is never read.

:func:`trsm_substitution` launches the hand-written CUDA kernel
(``csrc/trsm_block.cu``: a chain of row-block CTAs with ready flags,
see the note there) on CUDA tensors and runs
:func:`trsm_substitution_plain`, the same recurrence in plain PyTorch,
on CPU tensors.  The kernel carries X at the accumulate dtype (B must
have it) and takes L as float32, float64, or bfloat16 widened on load
to a float32 accumulation; bf16 to fp32 is exact, so the plain version
widens L the same way and the values match.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# (L dtype, X dtype) -> C entry suffix; the accumulate dtype is X's
_ENTRY = {(torch.float32, torch.float32): "f32",
          (torch.bfloat16, torch.float32): "bf16_f32",
          (torch.float64, torch.float64): "f64"}
KT = 16                                      # columns per chain
ROWS = {torch.float32: 64, torch.float64: 32}  # rows per CTA, by X dtype


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def trsm_substitution_plain(L: torch.Tensor, B: torch.Tensor,
                            accum_dtype=None) -> torch.Tensor:
    """X with tril(L) X = B by the row recurrence, for L (..., n0, n0)
    and B (..., n0, k): dots and subtractions at ``accum_dtype``
    (default fp32, fp64 for fp64 B), X in B's dtype."""
    acc = accum_dtype if accum_dtype is not None else _acc(B.dtype)
    X = torch.zeros_like(B)
    for r in range(L.shape[-1]):
        d = (L[..., r:r + 1, :r].to(acc) @ X[..., :r, :].to(acc))[..., 0, :]
        xr = (B[..., r, :].to(acc) - d) / L[..., r, r, None].to(acc)
        X[..., r, :] = xr.to(X.dtype)
    return X


@functools.cache
def _entry(suffix: str):
    fn = getattr(build.library("trsm_block"), f"repro_trsm_{suffix}")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, LL, P, LL, LL, P, P, LL, I, I, P]
    fn.restype = I
    return fn


def _check(L: torch.Tensor, B: torch.Tensor, acc: torch.dtype) -> str:
    """The C entry for these operands; raises on what the kernel does
    not take."""
    if L.device != B.device:
        raise ValueError(f"L on {L.device}, B on {B.device}")
    suffix = _ENTRY.get((L.dtype, B.dtype))
    if suffix is None or acc != B.dtype:
        raise TypeError(f"the trsm_substitution kernel takes (L, B, accum) "
                        f"in {sorted((str(a), str(b)) for a, b in _ENTRY)} "
                        f"with accum = B's dtype, got {L.dtype}, {B.dtype},"
                        f" {acc}")
    for name, t in (("L", L), ("B", B)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit column stride, got "
                             f"strides {t.stride()}")
    return suffix


def trsm_substitution(L: torch.Tensor, B: torch.Tensor, *,
                      accum_dtype=None, valid=None) -> torch.Tensor:
    """Solve tril(L) X = B for L (n0, n0) and B (n0, k), or batches
    (m, n0, n0) and (m, n0, k).  Rows of L and B may be strided (the
    recursion passes quadrant views of a resident factor); columns must
    be contiguous.  ``valid`` (the gated variant, kernel B6) is not
    ported: ROADMAP B5."""
    if valid is not None:
        raise NotImplementedError("trsm_substitution(valid=) is the gated "
                                  "kernel B6, ROADMAP B5")
    squeeze = L.ndim == 2
    if squeeze:
        L, B = L[None], B[None]
    if L.ndim != 3 or B.ndim != 3 or L.shape[1] != L.shape[2] \
            or B.shape[:2] != L.shape[:2]:
        raise ValueError(f"trsm_substitution takes (m, n0, n0) and (m, n0, "
                         f"k), got {tuple(L.shape)} and {tuple(B.shape)}")
    acc = accum_dtype if accum_dtype is not None else _acc(B.dtype)
    if L.device.type == "cpu" and B.device.type == "cpu":
        X = trsm_substitution_plain(L, B, acc)
        return X[0] if squeeze else X
    suffix = _check(L, B, acc)
    if L.device.type != "cuda":
        raise ValueError(f"trsm_substitution runs on CUDA or CPU tensors, "
                         f"got {L.device}")
    m, n0, k = B.shape
    X = torch.empty((m, n0, k), dtype=B.dtype, device=B.device)
    if m * n0 * k:
        R = ROWS[B.dtype]
        blocks = m * -(-k // KT) * -(-n0 // R)   # CTAs: one flag each
        flags = torch.zeros(1 + blocks, dtype=torch.int32, device=B.device)
        with torch.cuda.device(L.device):
            status = _entry(suffix)(
                L.data_ptr(), L.stride(0), L.stride(1),
                B.data_ptr(), B.stride(0), B.stride(1),
                X.data_ptr(), flags.data_ptr(), m, n0, k,
                torch.cuda.current_stream(L.device).cuda_stream)
        build.check(status, "trsm_substitution")
        trsm_substitution.launches += 1
    return X[0] if squeeze else X


trsm_substitution.launches = 0
