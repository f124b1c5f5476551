"""Batched inversion of lower-triangular blocks  (kernel B1).

Phase 1 of It-Inv-TRSM (the paper's Diagonal-Inverter): every
(n0, n0) diagonal block of the factor is inverted by bottom-up
doubling.  Level 0 takes the reciprocal of the diagonal; level s sets,
for every diagonal 2s-block [[A, 0], [B, C]] whose A and C are already
inverted, B' = -C^-1 (B A^-1) with fp32 partial sums and the inner
product t = B A^-1 rounded to the operand dtype, as the Pallas kernel
of ``repro.kernels.tri_inv_block`` does.

:func:`tri_inv_blocks` launches the hand-written CUDA kernels
(``csrc/tri_inv_levels.cu``) on CUDA tensors and runs
:func:`tri_inv_blocks_plain`, the same levels in plain PyTorch, on CPU
tensors.  On the card one block no longer fits on-chip memory
(an fp32 block of order 4096 is 64 MiB), so :func:`_schedule` splits
the levels: a leaf kernel inverts the S x S diagonal sub-blocks
(S <= 64) in shared memory, and each level s >= S is two batched
triangular products addressed into the output in place: register
tiles of up to 128 x 128 fed by a cp.async ring, a pair of tiles per
CTA along the triangle where a level has many, each output one FMA
chain over k ascending, so the bits do not depend on the tile a level
takes (see the note in the source).

Both versions compute the inverse of ``tril(L)``: the input's upper
triangle is never read and the output's is zero.

``valid=`` (an (m,) mask, kernel B5: the counterpart of the reference's
``_tri_inv_valid_kernel``) gates each block of the stack: one flagged 0
comes out as zeros, and none of its L is read, so no reciprocal of its
diagonal is taken.  Padded admission flags the diagonal blocks that lie
wholly in a padded factor's identity tail.  The kernel reads the mask
on the device; its launches are counted apart
(``tri_inv_blocks.valid_launches``) from B1's (``.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.blocked import diag_blocks
from repro_torch.kernels import build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float64: "f64"}
# largest leaf order: the leaf keeps two (S, S+1) accumulator tiles in
# static shared memory (csrc/tri_inv_levels.cu, leaf_max)
LEAF = {torch.float32: 64, torch.bfloat16: 64, torch.float64: 32}


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def tri_inv_blocks_plain(Ls: torch.Tensor, valid=None) -> torch.Tensor:
    """(m, n0, n0) -> inverses of the tril of each block, by the TPU
    kernel's doubling levels (n0 a power of two).  ``valid`` (an (m,)
    mask) zeroes every block flagged 0; such a block is inverted as the
    identity in its place, so nothing of its L enters an operation."""
    dt, acc = Ls.dtype, _acc(Ls.dtype)
    n0 = Ls.shape[-1]
    eye = torch.eye(n0, dtype=dt, device=Ls.device)
    if valid is not None:
        v = torch.as_tensor(valid, device=Ls.device).reshape(-1, 1, 1) != 0
        A = tri_inv_blocks_plain(torch.where(v, Ls, eye))
        return torch.where(v, A, torch.zeros_like(A))
    L = torch.tril(Ls)
    A = L * (1.0 - eye) + torch.diag_embed(1.0 / torch.diagonal(
        L, dim1=-2, dim2=-1))
    s = 1
    while s < n0:
        blk = diag_blocks(A, 2 * s)                 # view into A
        t = (blk[..., s:, :s].to(acc) @ blk[..., :s, :s].to(acc)).to(dt)
        n21 = -(blk[..., s:, s:].to(acc) @ t.to(acc))
        blk[..., s:, :s] = n21.to(dt)
        s *= 2
    return A


def _schedule(Ls, out, scratch, leaf, gemm) -> None:
    """The kernel path's launches, in order.

    ``leaf(Ls, out, S)`` inverts the S x S diagonal sub-blocks of every
    block into ``out`` and zeroes ``out`` right of them.  ``gemm(a, b,
    c, s, nq, batch, tri_a, tri_b, negate)`` is one batched product of
    s x s operands; each operand is ``(tensor, offset, ld, sb, sq)``
    and batch entry z sits at ``offset + (z // nq) * sb + (z % nq) *
    sq``.  The kernel's level products read the triangular operand's
    upper triangle, which the leaf has zeroed, as its zeros.  Kept apart
    from the launches so the CPU tests can replay the addressing with
    plain products."""
    m, n0, _ = Ls.shape
    S = min(n0, LEAF[Ls.dtype])
    leaf(Ls, out, S)
    blk = n0 * n0
    s = S
    while s < n0:
        nq = n0 // (2 * s)
        sq = 2 * s * (n0 + 1)                    # next 2s-block on the diagonal
        # T = L21 @ tril(A11^-1), rounded to the operand dtype
        gemm((Ls, s * n0, n0, blk, sq), (out, 0, n0, blk, sq),
             (scratch, 0, s, nq * s * s, s * s), s, nq, m * nq,
             tri_a=False, tri_b=True, negate=False)
        # N21 = -(tril(A22^-1) @ T), over the L21 position of the output
        gemm((out, s * n0 + s, n0, blk, sq),
             (scratch, 0, s, nq * s * s, s * s),
             (out, s * n0, n0, blk, sq), s, nq, m * nq,
             tri_a=True, tri_b=False, negate=True)
        s *= 2


@functools.cache
def _entries(dtype: torch.dtype, gated: bool = False):
    lib = build.library("tri_inv_levels")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    suffix = ("valid_" if gated else "") + _SUFFIX[dtype]
    leaf = getattr(lib, f"repro_tri_inv_leaf_{suffix}")
    leaf.argtypes = [P, P, LL, I, I] + [P] * (1 + gated)
    leaf.restype = I
    level = getattr(lib, f"repro_tri_inv_level_{suffix}")
    level.argtypes = [P, LL, LL, LL] * 3 + [I, I, LL, I, I, I] \
        + [P] * (1 + gated)
    level.restype = I
    return leaf, level


# the kernels kernel_info reports, by the C entry's index
_KERNELS = ("leaf", "level_large", "level_medium", "level_small")


def kernel_info(dtype: torch.dtype, gated: bool = False) -> dict:
    """{kernel: its registers per thread, resident CTAs per SM (CUDA's
    occupancy calculator), threads per CTA, shared bytes per CTA, spilled
    (local) bytes per thread and tile rows and columns} for the leaf and
    the three level tiles at ``dtype``, B5's when ``gated``; builds the
    library and needs a CUDA device."""
    fn = getattr(build.library("tri_inv_levels"),
                 f"repro_tri_inv_info_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = {}
    for which, name in enumerate(_KERNELS):
        out = (ctypes.c_int * 7)()
        build.check(fn(int(gated), which, ctypes.addressof(out)),
                    "tri_inv_blocks kernel_info")
        info[name] = dict(zip(("registers", "ctas_per_sm", "threads",
                               "shared_bytes", "local_bytes", "rows",
                               "cols"), out))
    return info


def _cuda_launchers(dtype: torch.dtype, stream: int, valid=None):
    """The leaf and level launchers of B1, or of B5 when ``valid`` (a
    contiguous int32 mask on the device) is given."""
    leaf_fn, level_fn = _entries(dtype, valid is not None)
    gate = () if valid is None else (valid.data_ptr(),)

    def leaf(Ls, out, S):
        m, n0, _ = Ls.shape
        build.check(leaf_fn(Ls.data_ptr(), out.data_ptr(), m, n0, S,
                            *gate, stream), "tri_inv_blocks leaf")

    def gemm(a, b, c, s, nq, batch, *, tri_a, tri_b, negate):
        args = []
        for t, off, ld, sb, sq in (a, b, c):
            args += [t.data_ptr() + off * t.element_size(), ld, sb, sq]
        build.check(level_fn(*args, s, nq, batch, int(tri_a), int(tri_b),
                             int(negate), *gate, stream),
                    "tri_inv_blocks level")

    return leaf, gemm


def tri_inv_blocks(Ls: torch.Tensor, valid=None) -> torch.Tensor:
    """Invert a contiguous stack (m, n0, n0) of lower-triangular blocks,
    n0 a power of two; the result has the input's dtype.  ``valid``: an
    (m,) mask on Ls's device (kernel B5); a block flagged 0 comes out as
    zeros and its L is never read."""
    if Ls.ndim != 3 or Ls.shape[1] != Ls.shape[2]:
        raise ValueError(f"tri_inv_blocks takes an (m, n0, n0) stack, got "
                         f"{tuple(Ls.shape)}")
    m, n0, _ = Ls.shape
    if m < 1 or n0 < 1 or n0 & (n0 - 1):
        raise ValueError(f"need m >= 1 and n0 a power of two, got "
                         f"{tuple(Ls.shape)}")
    if valid is not None:
        valid = torch.as_tensor(valid)
        if valid.shape != (m,):
            raise ValueError(f"valid must be ({m},), one flag per block, "
                             f"got {tuple(valid.shape)}")
        if valid.device != Ls.device:
            raise ValueError(f"valid on {valid.device}, Ls on {Ls.device}")
    if Ls.device.type == "cpu":
        return tri_inv_blocks_plain(Ls, valid)
    if Ls.device.type not in ("cuda", "meta"):
        raise ValueError(f"tri_inv_blocks runs on CUDA or CPU tensors "
                         f"(meta for shapes), got {Ls.device}")
    if Ls.dtype not in _SUFFIX:
        raise TypeError(f"tri_inv_blocks takes float32/bfloat16/float64, "
                        f"got {Ls.dtype}")
    if Ls.device.type == "meta":
        # a meta stack computes nothing: the result's shape, no launch
        return torch.empty_like(Ls)
    if not Ls.is_contiguous():
        raise ValueError("tri_inv_blocks takes a contiguous stack")
    # a launch's 1-D grid: the leaf's m * n0 / S CTAs, a level's at most
    # m * n0 * s / 2048 <= m * n0^2 / 4096 (32 x 32 tiles, in pairs)
    if m * max(n0 * n0 // 4096, n0 // 32, 1) > 2**31 - 1:
        raise ValueError(f"{m} blocks of order {n0} exceed one launch's "
                         f"2^31 - 1 CTAs")
    if Ls.data_ptr() % 16:
        # the levels copy 16-byte rows: a storage offset that breaks the
        # alignment gets a copy (the same values, so the same bits)
        Ls = torch.empty_like(Ls).copy_(Ls)
    if valid is not None:
        # a device-side cast: the mask is never read on the host
        valid = valid.to(torch.int32).contiguous()
    out = torch.empty_like(Ls)
    # the widest level's T: m * n0/(2s) blocks of s x s, s <= n0/2
    scratch = torch.empty(max(m * n0 * n0 // 4, 1), dtype=Ls.dtype,
                          device=Ls.device)
    with torch.cuda.device(Ls.device):
        stream = torch.cuda.current_stream(Ls.device).cuda_stream
        _schedule(Ls, out, scratch,
                  *_cuda_launchers(Ls.dtype, stream, valid))
    if valid is None:
        tri_inv_blocks.launches += 1
    else:
        tri_inv_blocks.valid_launches += 1
    return out


tri_inv_blocks.launches = 0
tri_inv_blocks.valid_launches = 0
