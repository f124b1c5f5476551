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
from repro_torch.kernels import ops, tri_inv_block, trmm
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


def test_block_inv_kernel_takes_powers_of_two_off_the_cpu():
    """Off the CPU every block size goes to tri_inv_blocks, a power of
    two (1 included) as it is and another padded to one with an identity
    tail (tri_inv_blocks raises on a meta tensor because it runs on CUDA
    or CPU only: no plain fallback)."""
    for n0 in (1, 3, 4):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            ops.block_inv_kernel(torch.zeros((2, n0, n0), device="meta"))


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
