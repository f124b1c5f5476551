"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; those are
held against ``repro``'s Pallas kernels in interpret mode at the
tolerances of tests/test_kernels.py (fp32 2e-5, bf16 2e-2; 1e-4 for
the inverse).  An inverse is compared with an absolute term scaled to
its largest entry, and its strictly lower part against that part's own
largest entry (``torch_parity``): its entries are about 1/n0 on the
diagonal and 1/n0^2 below it.  The CUDA kernels' launch schedule (leaf + per-level
products addressed in place) is replayed with plain products, so its
offsets and strides are checked here too; tests/test_torch_gpu.py runs
the CUDA kernels themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.tri_inv_block import tri_inv_blocks as jax_tri_inv
from repro.kernels.trmm import trmm as jax_trmm
from repro_torch.convert import to_tensor
from repro_torch.kernels import ops, tri_inv_block, trmm, trsm_block
from torch_parity import assert_inverse_close

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _tril(rng, n, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    return np.tril(rng.standard_normal(shape)) \
        + n * np.broadcast_to(np.eye(n), shape)


def _as(a, dtype):
    """numpy f64 -> the same values rounded to ``dtype``, as numpy (for
    jax) and as a torch tensor."""
    t = torch.as_tensor(a).to(dtype)
    return np.asarray(jnp.asarray(t.float().numpy(), JAX_DT[dtype])), t


# ------------------------------ trmm ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,bt,bn", [(128, 16, 32, 16), (256, 64, 64, 64),
                                       (64, 32, 32, 32)])
def test_trmm_plain_matches_pallas(n, k, bt, bn, dtype):
    rng = np.random.default_rng(n + k)
    Lj, L = _as(_tril(rng, n), dtype)
    Xj, X = _as(rng.standard_normal((n, k)), dtype)
    want = jax_trmm(jnp.asarray(Lj), jnp.asarray(Xj), bt=bt, bn=bn,
                    interpret=True)
    launches = trmm.trmm.launches
    got = trmm.trmm(L, X)
    assert got.dtype == dtype and trmm.trmm.launches == launches
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_trmm_plain_batched_and_ignores_upper():
    rng = np.random.default_rng(1)
    L = torch.as_tensor(rng.standard_normal((3, 32, 32)), dtype=torch.float32)
    X = torch.as_tensor(rng.standard_normal((3, 32, 5)), dtype=torch.float32)
    got = ops.trmm(L, X)
    want = torch.tril(L) @ X
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# --------------------------- tri_inv_blocks ---------------------------

@pytest.mark.parametrize("m,n0", [(1, 8), (4, 16), (2, 64), (3, 32)])
def test_tri_inv_plain_matches_pallas(m, n0):
    rng = np.random.default_rng(m * n0)
    Ls = _tril(rng, n0, batch=m).astype(np.float32)
    want = np.asarray(jax_tri_inv(jnp.asarray(Ls), interpret=True))
    got = tri_inv_block.tri_inv_blocks(torch.as_tensor(Ls))
    assert_inverse_close(got, want, 1e-4)
    prod = np.einsum("bij,bjk->bik", Ls.astype(np.float64),
                     got.numpy().astype(np.float64))
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(n0), prod.shape),
                               atol=1e-4)


def test_tri_inv_plain_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    Lj, L = _as(_tril(rng, 32, batch=2), torch.bfloat16)
    want = jax_tri_inv(jnp.asarray(Lj), interpret=True)
    got = tri_inv_block.tri_inv_blocks(L)
    assert_inverse_close(got, want, 2e-2)


def _emulated_launchers(batch_dtype, mask_triangles=True):
    """Plain-PyTorch stand-ins with the CUDA launches' addressing.  With
    ``mask_triangles=False`` a level product reads its triangular operand
    as stored, upper triangle included, as the CUDA level kernel does."""
    acc = torch.float64 if batch_dtype == torch.float64 else torch.float32

    def leaf(Ls, out, S):
        n0 = Ls.shape[-1]
        for j in range(n0 // S):
            d = slice(j * S, (j + 1) * S)
            out[:, d, d] = tri_inv_block.tri_inv_blocks_plain(
                Ls[:, d, d].contiguous())
            out[:, d, (j + 1) * S:] = 0

    def gemm(a, b, c, s, nq, batch, *, tri_a, tri_b, negate):
        def view(op):
            t, off, ld, sb, sq = op
            return torch.as_strided(t, (batch // nq, nq, s, s),
                                    (sb, sq, ld, 1),
                                    t.storage_offset() + off)
        A, B, C = view(a), view(b), view(c)
        A = torch.tril(A) if tri_a and mask_triangles else A
        B = torch.tril(B) if tri_b and mask_triangles else B
        r = A.to(acc) @ B.to(acc)
        C.copy_((-r if negate else r).to(C.dtype))

    return leaf, gemm


@pytest.mark.parametrize("dtype,m,n0", [(torch.float32, 2, 256),
                                        (torch.float32, 3, 128),
                                        (torch.float64, 2, 128),
                                        (torch.bfloat16, 2, 128),
                                        (torch.float32, 4, 32)])
def test_kernel_schedule_matches_plain(dtype, m, n0):
    """The leaf + level-product schedule the CUDA path launches, with
    each launch replayed as plain products, equals the plain doubling
    (same levels, same roundings)."""
    rng = np.random.default_rng(n0 + m)
    Ls = torch.as_tensor(_tril(rng, n0, batch=m)).to(dtype)
    Ls[:, 0, -1] = 123.0                   # the upper triangle is ignored
    out = torch.full_like(Ls, float("nan"))
    scratch = torch.full((m * n0 * n0 // 4,), float("nan"), dtype=dtype)
    tri_inv_block._schedule(Ls, out, scratch, *_emulated_launchers(dtype))
    want = tri_inv_block.tri_inv_blocks_plain(Ls)
    assert torch.equal(torch.triu(out, 1), torch.zeros_like(out))
    assert_inverse_close(out, want, 2e-2 if dtype == torch.bfloat16
                         else 1e-6)


@pytest.mark.parametrize("dtype,m,n0", [(torch.float32, 2, 256),
                                        (torch.float32, 3, 128),
                                        (torch.float64, 2, 128),
                                        (torch.bfloat16, 2, 128),
                                        (torch.float32, 4, 32)])
def test_kernel_schedule_needs_no_triangle_mask(dtype, m, n0):
    """The CUDA level products read the triangular operand's upper
    triangle as stored: the leaf has zeroed it before any level runs, so
    the replay with unmasked operands gives the masked replay's bits
    (NaN left there would reach the output)."""
    rng = np.random.default_rng(n0 + m + 1)
    Ls = torch.as_tensor(_tril(rng, n0, batch=m)).to(dtype)
    Ls[:, 0, -1] = 123.0
    outs = []
    for mask in (True, False):
        out = torch.full_like(Ls, float("nan"))
        scratch = torch.full((m * n0 * n0 // 4,), float("nan"), dtype=dtype)
        tri_inv_block._schedule(Ls, out, scratch,
                                *_emulated_launchers(dtype, mask))
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    assert not outs[1].isnan().any()


# --------------------------- block_inv_kernel ---------------------------

def test_block_inv_kernel_rejects_degenerate_blocks():
    with pytest.raises(ValueError, match="degenerate"):
        ops.block_inv_kernel(torch.zeros((4, 0, 0)))
    with pytest.raises(ValueError, match="degenerate"):
        ops.block_inv_kernel(torch.zeros((0, 4, 4)))
    with pytest.raises(ValueError, match="square"):
        ops.block_inv_kernel(torch.zeros((2, 4, 8)))
    with pytest.raises(ValueError, match="stack"):
        ops.block_inv_kernel(torch.zeros((4, 4)))
    out = ops.block_inv_kernel(torch.ones((3, 1, 1)))
    np.testing.assert_allclose(out.numpy(), np.ones((3, 1, 1)))


def test_block_inv_kernel_takes_powers_of_two_off_the_cpu(monkeypatch):
    """Off the CPU every block size goes to tri_inv_blocks, a power of
    two (1 included) as it is and another padded to one with an identity
    tail; on a meta stack tri_inv_blocks returns the stack's shape
    without a launch and never runs the plain version."""
    def plain(*a, **k):
        raise AssertionError("a meta stack reached the plain version")
    monkeypatch.setattr(tri_inv_block, "tri_inv_blocks_plain", plain)
    seen = []

    def record(Ls, valid=None):
        seen.append(tuple(Ls.shape))
        return tri_inv_block.tri_inv_blocks(Ls, valid)
    monkeypatch.setattr(ops, "tri_inv_blocks", record)
    before = tri_inv_block.tri_inv_blocks.launches
    for n0 in (1, 3, 4):
        out = ops.block_inv_kernel(torch.zeros((2, n0, n0), device="meta"))
        assert out.device.type == "meta" and out.shape == (2, n0, n0)
    assert seen == [(2, 1, 1), (2, 4, 4), (2, 4, 4)]
    assert tri_inv_block.tri_inv_blocks.launches == before


@pytest.mark.parametrize("n0", [3, 6, 16])
def test_block_inv_kernel_matches_reference_hook(n0):
    """Non-power-of-two n0 goes to padded doubling, powers of two to the
    kernel path; both equal the reference hook."""
    rng = np.random.default_rng(n0)
    Ls = _tril(rng, n0, batch=3).astype(np.float32)
    want = np.asarray(jax.jit(jops.block_inv_kernel)(jnp.asarray(Ls)))
    got = ops.block_inv_kernel(torch.as_tensor(Ls))
    assert_inverse_close(got, want, 1e-4)


def test_bfloat16_numpy_round_trip():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("strided", ["A", "X"])
def test_gemm_holds_the_kernel_layout_on_the_cpu(strided):
    """``ops.gemm`` refuses on the CPU what the tri-GEMM refuses on the
    card (A with non-unit column stride, X not contiguous), so a CPU run
    finds a layout the card would reject: a distributed trailing update
    once handed it a one-column panel whose reshape left its columns
    apart.  The conforming operands give A @ X."""
    A = torch.randn(2, 6, 4, dtype=torch.float64)
    X = torch.randn(2, 4, 3, dtype=torch.float64)
    torch.testing.assert_close(ops.gemm(A, X), A @ X)
    bad_A = A.transpose(-1, -2).contiguous().transpose(-1, -2)
    bad_X = X.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="unit column stride"):
        ops.gemm(bad_A, X) if strided == "A" else ops.gemm(A, bad_X)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


META_CALLS = {
    "tri_inv_blocks": (tri_inv_block, "tri_inv_blocks_plain",
                       lambda: ops.tri_inv_blocks(_meta(3, 16, 16)),
                       (3, 16, 16)),
    "tri_inv_blocks_valid": (tri_inv_block, "tri_inv_blocks_plain",
                             lambda: ops.tri_inv_blocks(
                                 _meta(3, 16, 16),
                                 _meta(3, dtype=torch.int32)), (3, 16, 16)),
    "trmm": (trmm, "trmm_plain",
             lambda: ops.trmm(_meta(2, 32, 32), _meta(2, 32, 8)), (2, 32, 8)),
    "trmm_masked": (trmm, "trmm_masked_plain",
                    lambda: ops.trmm(_meta(32, 32), _meta(32, 8),
                                     block_mask=_meta(4, 4,
                                                      dtype=torch.int32),
                                     bt=8), (32, 8)),
    "gemm": (trmm, "gemm_plain",
             lambda: ops.gemm(_meta(2, 16, 32), _meta(2, 32, 8)), (2, 16, 8)),
    "trsm_substitution": (trsm_block, "trsm_substitution_plain",
                          lambda: ops.trsm_substitution(
                              _meta(2, 16, 16), _meta(2, 16, 4)), (2, 16, 4)),
}


@pytest.mark.parametrize("name", sorted(META_CALLS))
def test_meta_call_launches_nothing_and_skips_the_plain_version(
        monkeypatch, name):
    """``comm.traced_cost`` runs programs on meta tensors: each wrapper
    returns an empty meta result of the kernel's shape and dtype,
    counts no launch and never runs its plain version (B3's plain loop
    alone would run n rows of meta ops)."""
    module, plain, call, shape = META_CALLS[name]

    def refuse(*a, **k):
        raise AssertionError(f"{name}: a meta call reached {plain}")
    monkeypatch.setattr(module, plain, refuse)
    wrappers = (tri_inv_block.tri_inv_blocks, trmm.trmm, trmm.trmm_masked,
                trmm.gemm, trsm_block.trsm_substitution)
    before = [(w.launches, getattr(w, "valid_launches", 0))
              for w in wrappers]
    out = call()
    assert out.device.type == "meta" and tuple(out.shape) == shape
    assert out.dtype == torch.float32
    assert [(w.launches, getattr(w, "valid_launches", 0))
            for w in wrappers] == before


# ------------------------- the ordered product -------------------------

GEMM_DTYPES = [torch.float32, torch.bfloat16, torch.float64]


@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("dtype", GEMM_DTYPES)
def test_gemm_meta_path_launches_nothing_and_takes_no_workspace(
        monkeypatch, dtype, lower):
    """Meta operands deep enough for several chunks (K > KC) give C's
    shape and dtype with no launch: the kernels' library is never
    loaded and no workspace is sized or taken."""
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a meta gemm reached the kernel's path")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(trmm, "gemm_workspace_bytes", refuse)
    monkeypatch.setattr(trmm, "gemm_plain", refuse)
    before = trmm.gemm.launches
    k = 3 * trmm.GEMM_KC[dtype] + 1
    out = ops.gemm(_meta(2, k, k, dtype=dtype), _meta(2, k, 16, dtype=dtype),
                   lower=lower)
    assert out.device.type == "meta" and out.dtype == dtype
    assert tuple(out.shape) == (2, k, 16)
    assert trmm.gemm.launches == before


@pytest.mark.parametrize("case", ["float16", "mixed", "int32", "rank2",
                                  "inner", "batch", "empty"])
def test_gemm_refuses_dtypes_and_shapes(case):
    """What the kernel does not take is refused before any launch (on
    meta operands, the shapes a card would get): float16, mixed or
    integer operands (TypeError); operands not (b, M, K) @ (b, K, N), or
    empty (ValueError)."""
    A, X = (2, 16, 32), (2, 32, 8)
    dt = (torch.float32, torch.float32)
    if case == "float16":
        dt = (torch.float16, torch.float16)
    elif case == "mixed":
        dt = (torch.float32, torch.float64)
    elif case == "int32":
        dt = (torch.int32, torch.int32)
    elif case == "rank2":
        A, X = (16, 32), (32, 8)
    elif case == "inner":
        X = (2, 31, 8)
    elif case == "batch":
        X = (3, 32, 8)
    else:
        X = (2, 32, 0)
    err = TypeError if case in ("float16", "mixed", "int32") else ValueError
    with pytest.raises(err, match="gemm takes"):
        ops.gemm(_meta(*A, dtype=dt[0]), _meta(*X, dtype=dt[1]))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_gemm_layout_refusals_and_a_row_strided_view(device):
    """A with a non-unit column stride and X not contiguous are refused
    on the CPU and on meta operands alike, as the kernel refuses them;
    a block column of a stack (free row and batch strides) passes as it
    is and, on the CPU, gives tril(A) @ X."""
    L = torch.randn(3, 12, 12, dtype=torch.float64, device=device)
    A = L[:, 4:, :6]                              # row stride 12
    X = torch.randn(3, 6, 5, dtype=torch.float64, device=device)
    out = ops.gemm(A, X, lower=True)
    assert tuple(out.shape) == (3, 8, 5)
    if device == "cpu":
        torch.testing.assert_close(out, torch.tril(A) @ X)
    with pytest.raises(ValueError, match="unit column stride"):
        ops.gemm(A.transpose(-1, -2)[:, :6, :6], X[:, :, :])
    with pytest.raises(ValueError, match="unit column stride"):
        ops.gemm(A, X.transpose(-1, -2).contiguous().transpose(-1, -2))


@pytest.mark.parametrize("dtype", GEMM_DTYPES)
def test_gemm_workspace_is_the_chunk_partials(dtype):
    """The kernel writes C itself where K fits in one chunk (no
    workspace), else ceil(K / KC) * b * M * N partials in the
    accumulator type: 8 MiB at the fp32 residual (1, 8192^2) x 16."""
    kc = trmm.GEMM_KC[dtype]
    acc = 8 if dtype == torch.float64 else 4
    assert trmm.gemm_workspace_bytes(dtype, 4, 100, kc, 16) == 0
    assert trmm.gemm_workspace_bytes(dtype, 4, 100, kc + 1, 16) \
        == 2 * 4 * 100 * 16 * acc
    assert trmm.gemm_workspace_bytes(dtype, 1, 8192, 8192, 16) \
        == 8192 // kc * 8192 * 16 * acc
    assert trmm.gemm_workspace_bytes(torch.float32, 1, 8192, 8192, 16) \
        == 8 * 2**20


@pytest.mark.parametrize("dtype", GEMM_DTYPES)
def test_gemm_order_checks_hold_for_the_plain_version(dtype):
    """``trmm.gemm_order_checks`` (the ordered product's contract, bit
    for bit) on the CPU, where ``ops.gemm`` is ``gemm_plain``: one
    rank-1 term at a time in ascending k, so every pair agrees there as
    the kernel's must on the card."""
    checks = trmm.gemm_order_checks(dtype, "cpu")
    assert checks and all(checks.values()), checks


def test_local_product_copies_only_what_gemm_refuses(monkeypatch):
    """``mm3d._local_product`` with ``fixed_order`` hands ``ops.gemm`` a
    row-strided A and a contiguous X as they are (no copy), copies an A
    whose columns lie apart and a non-contiguous X, and gives a
    one-column panel whose column stride is not 1 (a view torch calls
    contiguous) unit stride, which ``ops.gemm`` needs."""
    from repro_torch.core import mm3d
    seen = []
    real = ops.gemm

    def spy(A, X, **kw):
        seen.append((A.data_ptr(), X.data_ptr()))
        return real(A, X, **kw)
    monkeypatch.setattr(ops, "gemm", spy)
    acc = torch.float64
    L = torch.randn(2, 10, 10, dtype=acc)
    A, X = L[:, 2:, :4], torch.randn(2, 4, 3, dtype=acc)
    torch.testing.assert_close(mm3d._local_product(A, X, acc, True), A @ X)
    assert seen[-1] == (A.data_ptr(), X.data_ptr())
    At = A.transpose(-1, -2).contiguous().transpose(-1, -2)
    Xt = X.transpose(-1, -2).contiguous().transpose(-1, -2)
    torch.testing.assert_close(mm3d._local_product(At, Xt, acc, True),
                               A @ X)
    assert seen[-1][0] != At.data_ptr() and seen[-1][1] != Xt.data_ptr()
    panel = torch.randn(3, 5, dtype=acc).t()[:, :1].unsqueeze(0)
    assert panel.is_contiguous() and panel.stride(-1) != 1
    Y = torch.randn(1, 1, 2, dtype=acc)
    torch.testing.assert_close(mm3d._local_product(panel, Y, acc, True),
                               panel @ Y)
