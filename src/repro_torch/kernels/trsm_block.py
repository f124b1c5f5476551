"""Base-case TRSM by forward substitution  (kernel B3).

The row-serial solve the paper REPLACES with multiplications by
inverted blocks, kept as the recursive baseline's base case
(``repro_torch.core.rec_trsm``).  Row r of tril(L) X = B is

    x_r = (b_r - L[r, :r] . X[:r]) / L[r, r]

with the dot and the subtraction at ``accum_dtype`` and x_r stored in
X's dtype (B's), as the Pallas kernel of ``repro.kernels.trsm_block``
computes it.  The upper triangle of L is never read.

:func:`trsm_substitution` launches the hand-written CUDA kernel
(``csrc/trsm_chain.cu``: per system and column tile a chain of
row-block CTAs that hand X on in sub-blocks with ready flags, the
chains of a stack side by side; see the note there) on CUDA tensors
and runs
:func:`trsm_substitution_plain`, the same recurrence in plain PyTorch,
on CPU tensors.  The kernel carries X at the accumulate dtype (B must
have it) and takes L as float32, float64, or bfloat16 widened on load
to a float32 accumulation; bf16 to fp32 is exact, so the plain version
widens L the same way and the values match.

``valid=`` (an (m,) mask, kernel B6: the counterpart of the reference's
``_trsm_valid_kernel``) gates each system of the stack: one flagged 0
gets X = 0 and its L and B are never read, so a zero-filled or stale
factor of an empty or evicted bank slot cannot divide by zero.  The
kernel reads the mask on the device; its launches are counted apart
(``trsm_substitution.valid_launches``) from B3's (``.launches``).
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
SUB_ROWS = 16                     # rows per published sub-block of X


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def trsm_substitution_plain(L: torch.Tensor, B: torch.Tensor,
                            accum_dtype=None, valid=None) -> torch.Tensor:
    """X with tril(L) X = B by the row recurrence, for L (..., n0, n0)
    and B (..., n0, k): dots and subtractions at ``accum_dtype``
    (default fp32, fp64 for fp64 B), X in B's dtype.  ``valid`` (an (m,)
    mask over a stack (m, n0, n0)) zeroes the X of every system flagged
    0; such a system is solved against the identity, so nothing of its
    L or B enters an operation."""
    acc = accum_dtype if accum_dtype is not None else _acc(B.dtype)
    if valid is not None:
        v = torch.as_tensor(valid, device=L.device).reshape(-1, 1, 1) != 0
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        X = trsm_substitution_plain(torch.where(v, L, eye),
                                    torch.where(v, B, torch.zeros_like(B)),
                                    acc)
        return torch.where(v, X, torch.zeros_like(X))
    X = torch.zeros_like(B)
    for r in range(L.shape[-1]):
        d = (L[..., r:r + 1, :r].to(acc) @ X[..., :r, :].to(acc))[..., 0, :]
        xr = (B[..., r, :].to(acc) - d) / L[..., r, r, None].to(acc)
        X[..., r, :] = xr.to(X.dtype)
    return X


@functools.cache
def _entry(suffix: str, gated: bool = False):
    name = f"repro_trsm_valid_{suffix}" if gated else f"repro_trsm_{suffix}"
    fn = getattr(build.library("trsm_chain"), name)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, LL, P, LL, LL, P, P, LL, I, I] + [P] * (1 + gated)
    fn.restype = I
    return fn


def kernel_info(ldtype: torch.dtype, dtype: torch.dtype,
                gated: bool = False) -> dict:
    """The compiled kernel's registers per thread, resident CTAs per SM
    (CUDA's occupancy calculator), threads per CTA, static shared bytes
    and spilled (local) bytes per thread, for (L dtype, X dtype); builds
    the library and needs a CUDA device."""
    fn = getattr(build.library("trsm_chain"),
                 f"repro_trsm_info_{_ENTRY[ldtype, dtype]}")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    build.check(fn(int(gated), ctypes.addressof(out)), "trsm kernel_info")
    return dict(zip(("registers", "ctas_per_sm", "threads", "shared_bytes",
                     "local_bytes"), out))


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
    _check_columns(L, B)
    return suffix


def _check_columns(L: torch.Tensor, B: torch.Tensor) -> None:
    for name, t in (("L", L), ("B", B)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit column stride, got "
                             f"strides {t.stride()}")


def trsm_substitution(L: torch.Tensor, B: torch.Tensor, *,
                      accum_dtype=None, valid=None) -> torch.Tensor:
    """Solve tril(L) X = B for L (n0, n0) and B (n0, k), or batches
    (m, n0, n0) and (m, n0, k).  Rows of L and B may be strided (the
    recursion passes quadrant views of a resident factor); columns must
    be contiguous.  ``valid``: an (m,) mask on L's device (kernel B6);
    a system flagged 0 gets X = 0 and its L and B are never read."""
    squeeze = L.ndim == 2
    if squeeze:
        L, B = L[None], B[None]
    if L.ndim != 3 or B.ndim != 3 or L.shape[1] != L.shape[2] \
            or B.shape[:2] != L.shape[:2]:
        raise ValueError(f"trsm_substitution takes (m, n0, n0) and (m, n0, "
                         f"k), got {tuple(L.shape)} and {tuple(B.shape)}")
    if valid is not None:
        valid = torch.as_tensor(valid)
        if valid.shape != (L.shape[0],):
            raise ValueError(f"valid must be ({L.shape[0]},), one flag per "
                             f"system, got {tuple(valid.shape)}")
        if valid.device != L.device:
            raise ValueError(f"valid on {valid.device}, L on {L.device}")
    acc = accum_dtype if accum_dtype is not None else _acc(B.dtype)
    _check_columns(L, B)        # the kernel's layout, held on every device
    if L.device.type == "cpu" and B.device.type == "cpu":
        X = trsm_substitution_plain(L, B, acc, valid)
        return X[0] if squeeze else X
    suffix = _check(L, B, acc)
    if L.device.type not in ("cuda", "meta"):
        raise ValueError(f"trsm_substitution runs on CUDA or CPU tensors "
                         f"(meta for shapes), got {L.device}")
    m, n0, k = B.shape
    X = torch.empty((m, n0, k), dtype=B.dtype, device=B.device)
    # meta operands compute nothing: the result's shape, no launch
    if m * n0 * k and X.device.type != "meta":
        R = ROWS[B.dtype]
        blocks = m * -(-k // KT) * -(-n0 // R)   # CTAs
        # the ticket counter, then one flag per sub-block of each CTA
        flags = torch.zeros(1 + blocks * (R // SUB_ROWS), dtype=torch.int32,
                            device=B.device)
        args = (L.data_ptr(), L.stride(0), L.stride(1),
                B.data_ptr(), B.stride(0), B.stride(1),
                X.data_ptr(), flags.data_ptr(), m, n0, k)
        gated = valid is not None
        if gated:
            # a device-side cast: the mask is never read on the host
            valid = valid.to(torch.int32).contiguous()
            args += (valid.data_ptr(),)
        with torch.cuda.device(L.device):
            status = _entry(suffix, gated)(
                *args, torch.cuda.current_stream(L.device).cuda_stream)
        build.check(status, "trsm_substitution")
        if gated:
            trsm_substitution.valid_launches += 1
        else:
            trsm_substitution.launches += 1
    return X[0] if squeeze else X


trsm_substitution.launches = 0
trsm_substitution.valid_launches = 0
