"""Triangular matrix-matrix product  C = tril(L) @ X  (kernels B2, B4).

B2 is the It-Inv-TRSM solve step X_i = Dt_i @ B_i: Dt_i is the
inverted lower-triangular diagonal block, so the product skips every
tile above the diagonal.  B4 (:func:`trmm_masked`, or :func:`trmm` with
``block_mask=``) also skips every (bt x bt) block whose entry in a block
mask is 0, and never reads it: the refinement residual of a structured
factor, with the structure's mask at bt = n0.  Both launch
hand-written CUDA kernels from ``csrc/trmm_tri.cu`` (replacing the
Pallas kernels of ``repro.kernels.trmm``) on CUDA tensors, and run
their plain PyTorch versions, :func:`trmm_plain` and
:func:`trmm_masked_plain`, on CPU tensors.

Partial sums are fp32 for fp32 and bf16 operands (double for fp64);
the result has X's dtype.  An output's sum order depends only on its
row and its (kept) k-steps, never on n, the batch or the operands'
alignment, so B4 under a mask that keeps every lower block gives B2's
bits.

:func:`gemm` (``csrc/trmm.cu``) is the ordered product for a
row-strided A, dense or lower triangular: no TPU kernel's port, but a
product whose sums run in one order whatever the shape, which the
trailing updates and residuals of a capacity bank need
(``SolveSpec.fixed_order``) so that a padded slot solves as the
unpadded factor does, bit for bit.  Its kernel cuts k into chunks of a
fixed depth (:data:`GEMM_KC`), sums each chunk as one FMA chain and
adds the chunk sums in order, from a workspace it takes from torch's
allocator; :func:`gemm_order_checks` holds that order.
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


# KC, the ordered product's chunk depth by dtype: csrc/trmm.cu's Chunk
# (gemm_info reports the compiled one)
GEMM_KC = {torch.float32: 512, torch.bfloat16: 512, torch.float64: 256}


def gemm_plain(A: torch.Tensor, X: torch.Tensor,
               lower: bool = False) -> torch.Tensor:
    """C = A @ X (tril(A) @ X when ``lower``) with fp32 (fp64) partial
    sums in X's dtype, each output element summed over k in ascending
    order, one rank-1 term at a time: the order does not depend on A's
    shape, as the CPU's BLAS order does."""
    acc = _acc(X.dtype)
    A = (torch.tril(A) if lower else A).to(acc)
    X = X.to(acc)
    C = torch.zeros(A.shape[:-1] + X.shape[-1:], dtype=acc,
                    device=X.device)
    for k in range(A.shape[-1]):
        C += A[..., :, k:k + 1] * X[..., k:k + 1, :]
    return C.to(X.dtype)


@functools.cache
def _gemm_entry(dtype: torch.dtype):
    fn = getattr(build.library("trmm"), "repro_gemm_" + _SUFFIX[dtype])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, LL, P, LL, P, P, LL, I, I, I, I, I, P]
    fn.restype = I
    return fn


def gemm_workspace_bytes(dtype: torch.dtype, b: int, M: int, K: int,
                         N: int) -> int:
    """The bytes of the kernel's chunk partials: ceil(K / KC) * b * M *
    N accumulators, or 0 where K fits in one chunk and the kernel writes
    C itself."""
    chunks = -(-K // GEMM_KC[dtype])
    return chunks * b * M * N * _acc(dtype).itemsize if chunks > 1 else 0


def gemm_info(dtype: torch.dtype, wide: bool = False,
              lower: bool = False) -> dict:
    """The ordered product's kernel for N <= 16 (``wide``: N > 16) and a
    dense A (``lower``: a lower one, a shallower ring): registers per
    thread, resident CTAs per SM (CUDA's occupancy calculator), threads
    per CTA, shared bytes per CTA, spilled (local) bytes per thread, and
    its constants: KC (the chunk depth), the tile's rows and columns, BK
    and the ring's stages.  Builds the library and needs a CUDA
    device."""
    fn = getattr(build.library("trmm"), "repro_gemm_info_" + _SUFFIX[dtype])
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 10)()
    build.check(fn(int(wide), int(lower), ctypes.addressof(vals)),
                "gemm_info")
    return dict(zip(("registers", "ctas_per_sm", "threads", "shared_bytes",
                     "local_bytes", "kc", "tile_rows", "tile_cols", "bk",
                     "stages"), vals))


def _check_gemm_layout(A: torch.Tensor, X: torch.Tensor) -> None:
    if A.stride(-1) != 1 or not X.is_contiguous():
        raise ValueError(f"gemm takes A with unit column stride and a "
                         f"contiguous X, got strides {A.stride()} and "
                         f"{X.stride()}")


def gemm(A: torch.Tensor, X: torch.Tensor, *,
         lower: bool = False) -> torch.Tensor:
    """C = A @ X, or tril(A) @ X when ``lower``, for A (b, M, K) with
    contiguous columns (its row and batch strides are free: a block
    column of a resident stack passes without a copy) and X (b, K, N)
    contiguous: fp32 (fp64) partial sums in a fixed k order that does
    not depend on M, N, b or the strides, the result in X's dtype.  On
    the card ``csrc/trmm.cu``'s chunked order (a lower A's units above
    its diagonal never exist), on the CPU :func:`gemm_plain`.  The
    layout is held on every device, so a CPU run refuses what the
    kernel would; meta operands give C's shape with no launch and no
    workspace."""
    _check_gemm_layout(A, X)
    if A.device.type == "cpu" and X.device.type == "cpu":
        return gemm_plain(A, X, lower)
    if A.device != X.device or A.device.type not in ("cuda", "meta"):
        raise ValueError(f"gemm runs on CUDA or CPU tensors (meta for "
                         f"shapes), got {A.device} and {X.device}")
    if A.dtype != X.dtype or A.dtype not in _SUFFIX:
        raise TypeError(f"gemm takes matching float32/bfloat16/float64 "
                        f"operands, got {A.dtype} and {X.dtype}")
    if A.ndim != 3 or X.ndim != 3 or A.shape[0] != X.shape[0] \
            or A.shape[2] != X.shape[1] or min(A.shape) < 1 \
            or X.shape[2] < 1:
        raise ValueError(f"gemm takes (b, M, K) @ (b, K, N), got "
                         f"{tuple(A.shape)} and {tuple(X.shape)}")
    b, M, K = A.shape
    N = X.shape[2]
    C = torch.empty((b, M, N), dtype=X.dtype, device=X.device)
    if C.device.type == "meta":
        return C                 # meta operands compute nothing: no launch
    # the chunk partials, from torch's caching allocator: no cudaMalloc a
    # call, and freed in stream order after the launch
    nbytes = gemm_workspace_bytes(A.dtype, b, M, K, N)
    W = torch.empty((nbytes,), dtype=torch.uint8, device=A.device) \
        if nbytes else None
    # the C entry makes A's device current for its launches itself, and
    # takes the device's current stream as a raw pointer: the host's
    # share of a call is what bounds the small products of a p > 1 sweep
    dev = A.device.index
    status = _gemm_entry(A.dtype)(
        A.data_ptr(), A.stride(0), A.stride(1), X.data_ptr(), X.stride(0),
        C.data_ptr(), 0 if W is None else W.data_ptr(), b, M, K, N,
        int(lower), dev, torch._C._cuda_getCurrentRawStream(dev))
    build.check(status, "gemm")
    gemm.launches += 1
    return C


gemm.launches = 0


def _offset_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a storage one element past its base: a view
    whose base breaks 16-byte alignment (the element-load path)."""
    flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def gemm_order_checks(dtype: torch.dtype, device, seed: int = 0) -> dict:
    """The ordered product's contract, bit for bit, on ``device`` (the
    kernel on the card, :func:`gemm_plain` on the CPU): an element
    depends on its row of A, its column of X and K only.  Each entry
    says whether two products that must agree do: two launches; rows
    shared with a shorter operand; a batch entry against its matrix
    alone; N = 8 against 16 and 16 against 48 columns; K not a multiple
    of KC (two chunk edges crossed) against A and X padded with zeros to
    whole chunks, and K inside one chunk against the same padded past
    three; an order-d operand padded with the identity into order n
    (``lower`` and dense); ``lower`` with NaN above the diagonal against
    explicit zeros; a strided view and a view whose base is not 16-byte
    aligned against a contiguous copy."""
    g = torch.Generator(device=device).manual_seed(seed)
    kc = GEMM_KC[dtype]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    def padded(T, rows, cols):
        out = torch.zeros(T.shape[:-2] + (rows, cols), dtype=dtype,
                          device=device)
        out[..., :T.shape[-2], :T.shape[-1]] = T
        return out

    M, K = 640, 5 * kc // 2 + 37
    A, X = rnd(2, M, K), rnd(2, K, 16)
    C = gemm(A, X)
    out = dict(two_launches=torch.equal(C, gemm(A, X)),
               shorter_operand=torch.equal(C[:, :300], gemm(A[:, :300], X)),
               batch_entry=torch.equal(C[1:], gemm(A[1:], X[1:])),
               n8_vs_n16=torch.equal(C[..., :8],
                                     gemm(A, X[..., :8].contiguous())),
               n16_vs_n48=torch.equal(
                   C, gemm(A, torch.cat([X, rnd(2, K, 32)], -1))[..., :16]),
               k_ragged_vs_padded=torch.equal(
                   C, gemm(padded(A, M, 4 * kc), padded(X, 4 * kc, 16))))
    k1 = kc // 2 + 3
    A1, X1 = A[..., :k1].contiguous(), X[:, :k1].contiguous()
    out["one_chunk_vs_several"] = torch.equal(
        gemm(A1, X1), gemm(padded(A1, M, 3 * kc + 5),
                           padded(X1, 3 * kc + 5, 16)))
    d, n = kc + 188, 2 * kc + 76
    T = rnd(1, d, d).tril_()
    big = padded(T, n, n)
    big[0, d:, d:] = torch.eye(n - d, dtype=dtype, device=device)
    Xd = rnd(1, d, 16)
    Xn = torch.cat([Xd, rnd(1, n - d, 16)], 1)
    out["padded_identity_lower"] = torch.equal(
        gemm(big, Xn, lower=True)[:, :d], gemm(T, Xd, lower=True))
    out["padded_identity_dense"] = torch.equal(gemm(big, Xn)[:, :d],
                                               gemm(T, Xd))
    S = rnd(1, n, n)
    upper = torch.ones((n, n), dtype=torch.bool, device=device).triu_(1)
    out["lower_vs_explicit_zeros"] = torch.equal(
        gemm(S.masked_fill(upper, float("nan")), Xn, lower=True),
        gemm(S.tril(), Xn))
    V = rnd(2, 900, 1300)[:, 100:, 200:1200]
    Xv = rnd(2, 1000, 16)
    Cv = gemm(V.contiguous(), Xv)
    out["strided_view"] = torch.equal(gemm(V, Xv), Cv)
    out["misaligned_view"] = torch.equal(
        gemm(_offset_copy(V.contiguous()), _offset_copy(Xv)), Cv)
    return out


@functools.cache
def _entry(dtype: torch.dtype, masked: bool = False):
    name = "repro_trmm_masked_" if masked else "repro_trmm_"
    fn = getattr(build.library("trmm_tri"), name + _SUFFIX[dtype])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, P, LL, P, LL, I, I] + ([P, I] if masked
                                                 else []) + [P]
    fn.restype = I
    return fn


def kernel_info(dtype: torch.dtype) -> dict:
    """B4's compiled kernel on each of its load paths ("16-byte",
    "element", and "gated" where bt is not a multiple of the k-step):
    registers per thread, resident CTAs per SM (CUDA's occupancy
    calculator), threads per CTA, shared bytes per CTA and spilled
    (local) bytes per thread; builds the library and needs a CUDA
    device."""
    fn = getattr(build.library("trmm_tri"),
                 "repro_trmm_masked_info_" + _SUFFIX[dtype])
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for path, name in enumerate(("16-byte", "element", "gated")):
        vals = (ctypes.c_int * 5)()
        build.check(fn(path, ctypes.addressof(vals)), "trmm kernel_info")
        out[name] = dict(zip(("registers", "ctas_per_sm", "threads",
                              "shared_bytes", "local_bytes"), vals))
    return out


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


def _meta_result(X: torch.Tensor) -> torch.Tensor:
    """C's shape for meta operands, which compute nothing: no launch."""
    return torch.empty(X.shape, dtype=X.dtype, device=X.device)


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
    if L.device.type == "meta":
        return _meta_result(X)
    if L.device.type != "cuda":
        raise ValueError(f"trmm runs on CUDA or CPU tensors (meta for "
                         f"shapes), got {L.device}")
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
    if L.device.type not in ("cuda", "meta"):
        raise ValueError(f"trmm_masked runs on CUDA or CPU tensors (meta "
                         f"for shapes), got {L.device}")
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
    if L.device.type == "meta":
        return _meta_result(X)
    C = _launch(L, X, block_mask.data_ptr(), bt)
    trmm_masked.launches += 1
    return C


trmm_masked.launches = 0
