"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked ``gpu``: each test builds the kernels with nvcc and runs them on
the card, so it skips where there is none.  Imports no JAX, so it runs
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: trmm and the block-masked trmm 2e-5 (fp32, fp64) and 2e-2
(bf16) relative, with an absolute term scaled by sqrt(n) for the
reordered sums (the masked one of its largest entry); the inverse
1e-4 (fp32, fp64) and 2e-2 (bf16) of its largest entry, and its
strictly lower part the same share of that part's largest entry; the
substitution 1e-4 (fp32) and 1e-10 (fp64) of max|X|: its dots are
sequential FMA chains, the plain version's cuBLAS sums in another
order, and the recurrence carries each difference into later rows.
The validity-gated inversion (B5) is held as the inverse, and bit for
bit, in its one valid block, against B1 on that block alone; the
ordered product (``ops.gemm``) as trmm, and its order bit for bit.
"""

import pytest
import torch

from repro_torch.kernels import tri_inv_block, trmm, trsm_block


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a and run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("b,n,k", [(1, 256, 16), (2, 200, 7), (1, 96, 40),
                                   (1, 4096, 16), (16, 1024, 16)])
def test_trmm_kernel_matches_plain(cuda, dtype, b, n, k):
    """Ragged and unaligned shapes, the main path's solve step (one
    4096 x 4096 block, 16 columns) and a 16-wide stack."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L = torch.randn((b, n, n), generator=g, device=cuda).to(dtype)
    X = torch.randn((b, n, k), generator=g, device=cuda).to(dtype)
    got = trmm.trmm(L, X)
    want = trmm.trmm_plain(L, X)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.double(), want.double(), rtol=tol,
                               atol=tol * n ** 0.5)


_DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _offset_copy(t):
    """``t`` copied into a storage one element past the allocator's
    aligned base: a view whose base breaks 16-byte alignment."""
    flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_trmm_kernel_takes_misaligned_views(cuda, dtype):
    """Dt[:, i] @ B[:, rows] on storages offset by one element, so the
    base pointers are not 16-byte aligned: the element-load path, held
    against the plain version and bit for bit against the 16-byte path
    on contiguous copies (the same sums in the same order)."""
    g = torch.Generator(device=cuda).manual_seed(21)
    Dt = _offset_copy(torch.randn((2, 4, 64, 64), generator=g,
                                  device=cuda).to(dtype))
    B = _offset_copy(torch.randn((2, 256, 16), generator=g,
                                 device=cuda).to(dtype))
    L, X = Dt[:, 1], B[:, 64:128]
    assert L.data_ptr() % 16 and X.data_ptr() % 16
    got = trmm.trmm(L, X)
    want = trmm.trmm_plain(L, X)
    aligned = trmm.trmm(L.contiguous(), X.contiguous())
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.double(), want.double(), rtol=tol,
                               atol=tol * 8)
    assert torch.equal(got, aligned)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_trmm_kernel_two_launches_are_bit_equal(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(22)
    L = torch.randn((4, 1024, 1024), generator=g, device=cuda).to(dtype)
    X = torch.randn((4, 1024, 16), generator=g, device=cuda).to(dtype)
    first, second = trmm.trmm(L, X), trmm.trmm(L, X)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b,n,k", [(1, 512, 16), (2, 200, 7)])
def test_trmm_kernel_never_reads_above_the_diagonal(cuda, dtype, b, n, k):
    """NaN planted strictly above L's diagonal changes no bit of C."""
    g = torch.Generator(device=cuda).manual_seed(23)
    L = torch.randn((b, n, n), generator=g, device=cuda).to(dtype)
    X = torch.randn((b, n, k), generator=g, device=cuda).to(dtype)
    upper = torch.ones((n, n), dtype=torch.bool, device=cuda).triu(1)
    poisoned = L.masked_fill(upper, float("nan"))
    want, got = trmm.trmm(L, X), trmm.trmm(poisoned, X)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_trmm_kernel_rows_do_not_depend_on_n(cuda, dtype):
    """The leading r rows of tril(L) @ X are bit-equal to the product of
    the leading r x r triangle: a row's sums run in one order whatever
    n is."""
    g = torch.Generator(device=cuda).manual_seed(24)
    n, r = 512, 128
    L = torch.randn((2, n, n), generator=g, device=cuda).to(dtype)
    X = torch.randn((2, n, 16), generator=g, device=cuda).to(dtype)
    full = trmm.trmm(L, X)
    part = trmm.trmm(L[:, :r, :r].contiguous(), X[:, :r].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(full[:, :r], part)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_trmm_kernel_batch_entry_does_not_depend_on_the_stack(cuda, dtype):
    """One batch entry launched alone is bit-equal to the same entry
    inside a stack of 16."""
    g = torch.Generator(device=cuda).manual_seed(25)
    L = torch.randn((16, 512, 512), generator=g, device=cuda).to(dtype)
    X = torch.randn((16, 512, 16), generator=g, device=cuda).to(dtype)
    stack = trmm.trmm(L, X)
    alone = trmm.trmm(L[5], X[5])
    torch.cuda.synchronize()
    assert torch.equal(stack[5], alone)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("m,n0", [(3, 16), (2, 256), (1, 512), (2, 1024),
                                  (2, 4096)])
def test_tri_inv_kernel_matches_plain(cuda, dtype, m, n0):
    g = torch.Generator(device=cuda).manual_seed(1)
    Ls = (torch.randn((m, n0, n0), generator=g, device=cuda).tril()
          + n0 * torch.eye(n0, device=cuda)).to(dtype)
    got = tri_inv_block.tri_inv_blocks(Ls)
    want = tri_inv_block.tri_inv_blocks_plain(Ls)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = got.double() - want.double()
    assert err.abs().max().item() <= tol * want.abs().max().item()
    # the strictly lower part (~1/n0^2 against ~1/n0 on the diagonal)
    # against its own scale, so every level's product shows
    lower = torch.tril(want.double(), -1).abs().max().item()
    assert torch.tril(err, -1).abs().max().item() <= tol * lower


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_tri_inv_kernel_takes_an_unaligned_stack(cuda, dtype):
    """A contiguous stack whose storage offset breaks the 16-byte rows
    the levels copy is inverted as an aligned one, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(18)
    Ls = (torch.randn((2, 256, 256), generator=g, device=cuda).tril_()
          + 256 * torch.eye(256, device=cuda)).to(dtype)
    shifted = _offset_copy(Ls)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    got = tri_inv_block.tri_inv_blocks(shifted)
    want = tri_inv_block.tri_inv_blocks(Ls)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_trmm_kernel_takes_strided_batches(cuda):
    """The sweep passes Dt[:, i] and row slices of B: matrices with
    contiguous rows at a free batch stride."""
    g = torch.Generator(device=cuda).manual_seed(2)
    Dt = torch.randn((2, 4, 64, 64), generator=g, device=cuda)
    B = torch.randn((2, 256, 16), generator=g, device=cuda)
    got = trmm.trmm(Dt[:, 1], B[:, 64:128])
    want = trmm.trmm_plain(Dt[:, 1], B[:, 64:128])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("precision,bound", [("fp32", 1e-5),
                                             ("bf16_refine", 1e-5),
                                             ("fp64_refine", 1e-11)])
def test_solver_on_the_card(cuda, precision, bound):
    """The slice end to end at a small size, through both kernels; the
    bounds are tests/test_api_solver.py's for each preset."""
    from repro_torch import api
    n, k = 512, 16
    g = torch.Generator(device=cuda).manual_seed(3)
    L = torch.randn((n, n), generator=g, device=cuda,
                    dtype=torch.float64).tril() \
        + n * torch.eye(n, device=cuda, dtype=torch.float64)
    B = torch.randn((n, k), generator=g, device=cuda, dtype=torch.float64)
    inv0, mm0 = tri_inv_block.tri_inv_blocks.launches, trmm.trmm.launches
    solver = api.Solver.from_factor(L, api.make_trsm_mesh(1, 1), n0=64,
                                    precision=precision)
    X = solver.warmup(k).solve(B.to(solver.dtype))
    relres = (torch.linalg.norm(L @ X.double() - B)
              / torch.linalg.norm(B)).item()
    assert relres < bound, relres
    assert tri_inv_block.tri_inv_blocks.launches > inv0
    assert trmm.trmm.launches > mm0


def _system(g, device, m, n, k, dtype, ldtype=None):
    """tril(randn) / sqrt(n) with a diagonal in [1, 2): the
    off-diagonal part moves X as much as the diagonal does."""
    L = torch.randn((m, n, n), generator=g, device=device,
                    dtype=torch.float64).tril_() / n ** 0.5
    L.diagonal(dim1=-2, dim2=-1).copy_(
        1 + torch.rand((m, n), generator=g, device=device,
                       dtype=torch.float64))
    B = torch.randn((m, n, k), generator=g, device=device,
                    dtype=torch.float64)
    return L.to(ldtype or dtype), B.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,ldtype,dtype", [
    (1, 512, 16, torch.float32, torch.float32),
    (3, 200, 40, torch.float32, torch.float32),
    (4, 512, 5, torch.float32, torch.float32),
    (1, 1024, 16, torch.bfloat16, torch.float32),
    (1, 8192, 16, torch.bfloat16, torch.float32),
    (2, 256, 16, torch.float64, torch.float64),
    (3, 100, 7, torch.float64, torch.float64)])
def test_trsm_kernel_matches_plain(cuda, m, n, k, ldtype, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    L, B = _system(g, cuda, m, n, k, dtype, ldtype)
    launches = trsm_block.trsm_substitution.launches
    got = trsm_block.trsm_substitution(L, B)
    want = trsm_block.trsm_substitution_plain(L, B)
    torch.cuda.synchronize()
    assert trsm_block.trsm_substitution.launches == launches + 1
    assert got.dtype == dtype
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= tol * scale
    # the off-diagonal part is far above the tolerance
    diag_only = B.double() / L.double().diagonal(dim1=-2, dim2=-1)[..., None]
    assert (diag_only - want.double()).abs().max().item() > 100 * tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,emax", [(torch.float32, 110),
                                        (torch.float64, 1000)])
def test_trsm_kernel_quotients_are_correctly_rounded(cuda, dtype, emax):
    """A diagonal factor makes every dot exactly 0, so X must equal the
    IEEE quotient B / diag bit for bit, across the exponent range (the
    kernel forms quotients from a hoisted reciprocal, with the full
    division outside mid range)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    m, n, k = 8, 512, 16
    lim = 125 if dtype == torch.float32 else 1020

    def mantissa(shape):
        sign = torch.randint(0, 2, shape, generator=g, device=cuda) * 2 - 1
        return sign * (1 + torch.rand(shape, generator=g, device=cuda,
                                      dtype=torch.float64))

    e_d = torch.randint(-emax, emax + 1, (m, n), generator=g, device=cuda)
    u = torch.rand((m, n, k), generator=g, device=cuda, dtype=torch.float64)
    lo = (-lim - e_d).clamp(min=-emax)[..., None]
    hi = (lim - e_d).clamp(max=emax)[..., None]
    e_b = e_d[..., None] + (lo + u * (hi - lo)).floor().long()
    d = (mantissa((m, n)) * torch.pow(2.0, e_d.double())).to(dtype)
    B = (mantissa((m, n, k)) * torch.pow(2.0, e_b.double())).to(dtype)
    L = torch.diag_embed(d)
    got = trsm_block.trsm_substitution(L, B)
    want = B / d[..., None]
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_trsm_kernel_never_reads_the_upper_triangle(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    L, B = _system(g, cuda, 2, 300, 16, torch.float32)
    poisoned = L + torch.full_like(L, float("nan")).triu(1)
    got = trsm_block.trsm_substitution(poisoned, B)
    want = trsm_block.trsm_substitution(L, B)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_trsm_kernel_takes_quadrant_views(cuda):
    """The recursion hands the kernel quadrants of a resident factor:
    rows strided by the full order, a free batch stride."""
    g = torch.Generator(device=cuda).manual_seed(6)
    L, B = _system(g, cuda, 2, 256, 16, torch.float32)
    got = trsm_block.trsm_substitution(L[:, 128:, 128:], B[:, 128:])
    want = trsm_block.trsm_substitution_plain(L[:, 128:, 128:], B[:, 128:])
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("precision,bound", [("fp32", 1e-5),
                                             ("bf16_refine", 1e-5),
                                             ("fp64_refine", 1e-11)])
@pytest.mark.parametrize("n0", [None, 128])
def test_rec_solver_on_the_card(cuda, precision, bound, n0):
    """The recursive baseline served on the card: n / n0 base cases per
    pass, each one trsm_substitution launch."""
    from repro_torch import api
    n, k = 512, 16
    g = torch.Generator(device=cuda).manual_seed(7)
    L = torch.randn((n, n), generator=g, device=cuda,
                    dtype=torch.float64).tril() \
        + n * torch.eye(n, device=cuda, dtype=torch.float64)
    B = torch.randn((n, k), generator=g, device=cuda, dtype=torch.float64)
    solver = api.Solver.from_factor(L, api.make_trsm_mesh(1, 1),
                                    method="rec", n0=n0,
                                    precision=precision).warmup(k)
    Bp = solver.place_rhs(B)
    launches = trsm_block.trsm_substitution.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        X = solver.solve(Bp)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    relres = (torch.linalg.norm(L @ X.double() - B)
              / torch.linalg.norm(B)).item()
    assert relres < bound, relres
    passes = solver.policy.refine_steps + 1
    assert trsm_block.trsm_substitution.launches - launches \
        == (n // (n0 or n)) * passes


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["inv", "rec", "auto"])
def test_one_shot_trsm_on_the_card(cuda, method):
    from repro_torch import api
    n, k = 256, 16
    g = torch.Generator(device=cuda).manual_seed(8)
    L = torch.randn((n, n), generator=g, device=cuda).tril() \
        + n * torch.eye(n, device=cuda)
    B = torch.randn((n, k), generator=g, device=cuda)
    grid = api.make_trsm_mesh(1, 1)
    n0 = 64 if method == "inv" else None
    counts = (tri_inv_block.tri_inv_blocks.launches, trmm.trmm.launches,
              trsm_block.trsm_substitution.launches)
    X = api.trsm(L, B, grid, method=method, n0=n0, transpose=True)
    relres = (torch.linalg.norm(L.double().T @ X.double() - B.double())
              / torch.linalg.norm(B.double())).item()
    assert relres < 1e-5, relres
    after = (tri_inv_block.tri_inv_blocks.launches, trmm.trmm.launches,
             trsm_block.trsm_substitution.launches)
    # the resolved plan's kernels, and only those: B1 once and B2 per
    # sweep step for "inv", B3 per base case for "rec"
    resolved, r_n0 = api.resolve_plan(grid, n, k, method=method, n0=n0)
    want = (1, n // r_n0, 0) if resolved == "inv" else (0, 0, n // r_n0)
    assert tuple(a - b for a, b in zip(after, counts)) == want


@pytest.mark.gpu
@pytest.mark.parametrize("n0", [1, 2, 64])
def test_block_inv_kernel_launches_for_every_power_of_two(cuda, n0):
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(10)
    Ls = torch.randn((8, n0, n0), generator=g, device=cuda).tril() \
        + n0 * torch.eye(n0, device=cuda)
    launches = tri_inv_block.tri_inv_blocks.launches
    got = ops.block_inv_kernel(Ls)
    torch.cuda.synchronize()
    assert tri_inv_block.tri_inv_blocks.launches == launches + 1
    want = tri_inv_block.tri_inv_blocks_plain(Ls)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    # an order B1 cannot take goes in once, padded with an identity
    # tail to the next power of two
    from repro_torch.core import blocked
    L3 = torch.randn((8, 3, 3), generator=g, device=cuda).tril() \
        + 3 * torch.eye(3, device=cuda)
    got = ops.block_inv_kernel(L3)
    torch.cuda.synchronize()
    assert tri_inv_block.tri_inv_blocks.launches == launches + 2
    torch.testing.assert_close(got, blocked.tri_inv_doubling(L3),
                               rtol=1e-4, atol=1e-6)


def _masked_operands(g, device, b, n, k, bt, dtype, seed):
    """A dense tril(randn) stack, X, a seeded (n/bt, n/bt) block mask
    (diagonal kept, ~40% of the rest) and the stack with NaN in every
    left-out block and above the diagonal."""
    import numpy as np
    rng = np.random.default_rng(seed)
    m = n // bt
    bm = np.tril(rng.random((m, m)) < 0.4)
    np.fill_diagonal(bm, True)
    mask = torch.as_tensor(bm.astype(np.int32), device=device)
    L = torch.randn((b, n, n), generator=g, device=device).tril_().to(dtype)
    X = torch.randn((b, n, k), generator=g, device=device).to(dtype)
    elem = mask.bool().repeat_interleave(bt, 0).repeat_interleave(bt, 1)
    keep = elem & torch.ones_like(elem).tril()
    poisoned = torch.where(keep, L, torch.full_like(L, float("nan")))
    return L, X, mask, poisoned


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("b,n,k,bt", [
    (1, 2048, 16, 512),      # bt above the 256-deep k-step
    (2, 512, 16, 32),        # below it
    (3, 200, 5, 4),          # below the 8-row tile: per-element gate
    (1, 256, 40, 32),        # 64 x 64 tiles
    (1, 256, 40, 128),
    (8, 2048, 16, 512)])     # a structured capacity bank's stack
def test_trmm_masked_kernel_matches_plain(cuda, dtype, b, n, k, bt):
    g = torch.Generator(device=cuda).manual_seed(11)
    L, X, mask, poisoned = _masked_operands(g, cuda, b, n, k, bt, dtype,
                                            seed=n + bt)
    launches = (trmm.trmm.launches, trmm.trmm_masked.launches)
    got = trmm.trmm(L, X, block_mask=mask, bt=bt)
    want = trmm.trmm_masked_plain(L, X, mask, bt)
    torch.cuda.synchronize()
    assert (trmm.trmm.launches, trmm.trmm_masked.launches) \
        == (launches[0], launches[1] + 1)
    assert got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= tol * scale
    # the mask matters: the unmasked product is far from it
    full = trmm.trmm_plain(L, X).double()
    assert (full - want.double()).abs().max().item() > 10 * tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,bt", [(2048, 16, 512), (512, 16, 32),
                                    (200, 5, 4), (256, 40, 32)])
def test_trmm_masked_kernel_never_reads_skipped_blocks(cuda, n, k, bt):
    """NaN planted in every left-out block and above the diagonal does
    not reach C: the result is the clean operand's, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(12)
    L, X, mask, poisoned = _masked_operands(g, cuda, 2, n, k, bt,
                                            torch.float32, seed=bt)
    got = trmm.trmm_masked(poisoned, X, mask, bt)
    want = trmm.trmm_masked(L, X, mask, bt)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int32"):
        trmm.trmm_masked(L, X, mask.cpu(), bt)
    with pytest.raises(ValueError, match="divide"):
        trmm.trmm_masked(L, X, mask, 3 * bt)


def _mask(device, m, seed):
    """A seeded (m, m) int32 block mask: the diagonal and ~40% of the
    blocks below it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bm = np.tril(rng.random((m, m)) < 0.4)
    np.fill_diagonal(bm, True)
    return torch.as_tensor(bm.astype(np.int32), device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b,n,k,bt", [(1, 2048, 16, 512), (2, 512, 16, 32),
                                      (3, 200, 5, 4), (1, 256, 40, 32)])
def test_trmm_masked_kernel_all_lower_mask_is_b2(cuda, dtype, b, n, k, bt):
    """A mask that keeps every lower block walks B2's k-steps in B2's
    order: trmm.trmm's bits, on the 16-byte, element and gated paths."""
    g = torch.Generator(device=cuda).manual_seed(15)
    L = torch.randn((b, n, n), generator=g, device=cuda).to(dtype)
    X = torch.randn((b, n, k), generator=g, device=cuda).to(dtype)
    lower = torch.ones((n // bt, n // bt), dtype=torch.int32,
                       device=cuda).tril_()
    got = trmm.trmm_masked(L, X, lower, bt)
    want = trmm.trmm(L, X)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b,n,k,bt", [(4, 1024, 16, 128), (2, 200, 5, 4)])
def test_trmm_masked_kernel_two_launches_are_bit_equal(cuda, dtype, b, n, k,
                                                       bt):
    g = torch.Generator(device=cuda).manual_seed(16)
    L = torch.randn((b, n, n), generator=g, device=cuda).to(dtype)
    X = torch.randn((b, n, k), generator=g, device=cuda).to(dtype)
    mask = _mask(cuda, n // bt, seed=16)
    first, second = trmm.trmm_masked(L, X, mask, bt), \
        trmm.trmm_masked(L, X, mask, bt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("bt", [128, 32])
def test_trmm_masked_kernel_rows_do_not_depend_on_n(cuda, dtype, bt):
    """The leading r rows of a masked product are bit-equal to the
    product of the leading r x r triangle under the mask's leading
    block: a row's sums depend on its kept k-steps only."""
    g = torch.Generator(device=cuda).manual_seed(17)
    n, r = 1024, 512
    L = torch.randn((2, n, n), generator=g, device=cuda).to(dtype)
    X = torch.randn((2, n, 16), generator=g, device=cuda).to(dtype)
    mask = _mask(cuda, n // bt, seed=17)
    full = trmm.trmm_masked(L, X, mask, bt)
    part = trmm.trmm_masked(L[:, :r, :r].contiguous(),
                            X[:, :r].contiguous(),
                            mask[:r // bt, :r // bt].contiguous(), bt)
    torch.cuda.synchronize()
    assert torch.equal(full[:, :r], part)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_trmm_masked_kernel_batch_entry_does_not_depend_on_the_stack(
        cuda, dtype):
    """One batch entry launched alone is bit-equal to the same entry
    inside a stack of 16 under the same mask."""
    g = torch.Generator(device=cuda).manual_seed(19)
    L = torch.randn((16, 512, 512), generator=g, device=cuda).to(dtype)
    X = torch.randn((16, 512, 16), generator=g, device=cuda).to(dtype)
    mask = _mask(cuda, 8, seed=19)
    stack = trmm.trmm_masked(L, X, mask, 64)
    alone = trmm.trmm_masked(L[5], X[5], mask, 64)
    torch.cuda.synchronize()
    assert torch.equal(stack[5], alone)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_trmm_masked_kernel_takes_misaligned_views(cuda, dtype):
    """Dt[:, i] @ B[:, rows] under a mask, on storages offset by one
    element: the element-load path, held against the plain version and
    bit for bit against the 16-byte path on contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(20)
    Dt = _offset_copy(torch.randn((2, 2, 256, 256), generator=g,
                                  device=cuda).to(dtype))
    B = _offset_copy(torch.randn((2, 1024, 16), generator=g,
                                 device=cuda).to(dtype))
    L, X = Dt[:, 1], B[:, 256:512]
    assert L.data_ptr() % 16 and X.data_ptr() % 16
    mask = _mask(cuda, 4, seed=20)
    got = trmm.trmm_masked(L, X, mask, 64)
    want = trmm.trmm_masked_plain(L, X, mask, 64)
    aligned = trmm.trmm_masked(L.contiguous(), X.contiguous(), mask, 64)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= tol * scale
    assert torch.equal(got, aligned)


@pytest.mark.gpu
@pytest.mark.parametrize("method,precision,bound", [
    ("inv", "bf16_refine", 1e-5), ("inv", "fp64_refine", 1e-11),
    ("rec", "bf16_refine", 1e-5)])
@pytest.mark.parametrize("text", ["banded:64", "block-sparse"])
def test_structured_solver_on_the_card(cuda, method, precision, bound, text):
    """A structured solver on the card: relres against the masked
    operator, exact launch counts per solve (B2 per sweep step or B3 per
    base case in every pass, B4 once per refinement pass), no host sync
    in the steady state, and NaN in the dropped blocks changes no bit
    of X."""
    from repro_torch import api
    from repro_torch.core.structure import analyze, apply_block_mask
    n, k, n0 = 512, 16, 64
    g = torch.Generator(device=cuda).manual_seed(13)
    L = torch.randn((n, n), generator=g, device=cuda,
                    dtype=torch.float64).tril() \
        + n * torch.eye(n, device=cuda, dtype=torch.float64)
    B = torch.randn((n, k), generator=g, device=cuda, dtype=torch.float64)
    st = api.FactorStructure.parse(text, n=n)
    info = analyze(st, n, n0)
    assert not info.full
    Lm = apply_block_mask(L, st, n0)
    grid = api.make_trsm_mesh(1, 1)
    solver = api.Solver.from_factor(L, grid, method=method, n0=n0,
                                    structure=st,
                                    precision=precision).warmup(k)
    Bp = solver.place_rhs(B)
    counts = (trmm.trmm.launches, trmm.trmm_masked.launches,
              trsm_block.trsm_substitution.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        X = solver.solve(Bp)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    relres = (torch.linalg.norm(Lm @ X.double() - B)
              / torch.linalg.norm(B)).item()
    assert relres < bound, relres
    steps = solver.policy.refine_steps
    per_pass = n // n0
    want = (per_pass * (steps + 1), steps, 0) if method == "inv" \
        else (0, steps, per_pass * (steps + 1))
    after = (trmm.trmm.launches, trmm.trmm_masked.launches,
             trsm_block.trsm_substitution.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == want
    elem = torch.as_tensor(info.mask_array(), device=cuda) \
        .repeat_interleave(n0, 0).repeat_interleave(n0, 1)
    poisoned = torch.where(elem | torch.ones_like(elem).triu(1), L,
                           torch.full_like(L, float("nan")))
    Xp = api.Solver.from_factor(poisoned, grid, method=method, n0=n0,
                                structure=st,
                                precision=precision).solve(Bp)[0]
    assert torch.equal(Xp, X)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["inv", "rec"])
def test_full_mask_block_sparse_is_dense_on_the_card(cuda, method):
    import numpy as np
    from repro_torch import api
    n, k, n0 = 512, 16, 128
    g = torch.Generator(device=cuda).manual_seed(14)
    L = torch.randn((n, n), generator=g, device=cuda).tril() \
        + n * torch.eye(n, device=cuda)
    B = torch.randn((n, k), generator=g, device=cuda)
    m = n // n0
    full = api.FactorStructure.block_sparse(np.tril(np.ones((m, m), bool)))
    grid = api.make_trsm_mesh(1, 1)
    kw = dict(method=method, n0=n0, precision="bf16_refine")
    masked = trmm.trmm_masked.launches
    Xd = api.Solver.from_factor(L, grid, **kw).solve(B)
    Xf = api.Solver.from_factor(L, grid, structure=full, **kw).solve(B)
    torch.cuda.synchronize()
    assert torch.equal(Xd, Xf)
    assert trmm.trmm_masked.launches == masked


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,ldtype,dtype,strided", [
    (4, 200, 40, torch.float32, torch.float32, False),
    (5, 100, 7, torch.float64, torch.float64, False),
    (4, 512, 16, torch.bfloat16, torch.float32, False),
    (6, 256, 16, torch.float32, torch.float32, True),
    (3, 130, 21, torch.float32, torch.float32, True)])
def test_trsm_valid_kernel_matches_plain(cuda, m, n, k, ldtype, dtype,
                                         strided):
    """B6 against its plain version, ragged n and k and quadrant views of
    a larger stack among them: the valid systems within B3's tolerance,
    the invalid ones exact zeros; NaN planted in every invalid system's
    L (its diagonal zeroed) and B changes no bit; an all-ones mask is
    B3 bit for bit.  The gated launches are counted apart from B3's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    big = 2 * n if strided else n
    L, B = _system(g, cuda, m, big, k, dtype, ldtype)
    L, B = L[:, big - n:, big - n:], B[:, big - n:]
    v = torch.tensor([(z * 7 + 3) % 3 != 0 for z in range(m)],
                     dtype=torch.int32, device=cuda)
    live = v.bool()
    assert 0 < int(v.sum()) < m
    b3, b6 = (trsm_block.trsm_substitution.launches,
              trsm_block.trsm_substitution.valid_launches)
    got = trsm_block.trsm_substitution(L, B, valid=v)
    assert (trsm_block.trsm_substitution.launches,
            trsm_block.trsm_substitution.valid_launches) == (b3, b6 + 1)
    want = trsm_block.trsm_substitution_plain(L, B, valid=v)
    torch.cuda.synchronize()
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= tol * scale
    assert not got[~live].any()
    Lp = L.clone()
    Lp[~live] = float("nan")
    Lp.diagonal(dim1=-2, dim2=-1)[~live] = 0
    Bp = torch.where(live[:, None, None], B, torch.full_like(B, float("nan")))
    assert torch.equal(trsm_block.trsm_substitution(Lp, Bp, valid=v), got)
    assert torch.equal(
        trsm_block.trsm_substitution(L, B, valid=torch.ones_like(v)),
        trsm_block.trsm_substitution(L, B))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,ldtype,dtype,gated", [
    (1, 2048, 16, torch.bfloat16, torch.float32, False),
    (3, 200, 40, torch.float32, torch.float32, False),
    (4, 520, 16, torch.float32, torch.float32, True),
    (2, 256, 7, torch.float64, torch.float64, False)])
def test_trsm_kernel_two_launches_are_bit_equal(cuda, m, n, k, ldtype,
                                                dtype, gated):
    """The CTAs of a launch run in no fixed order and hand X on in
    sub-blocks as they come; every entry's dot is still one FMA chain in
    column order, so a second launch gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(19)
    L, B = _system(g, cuda, m, n, k, dtype, ldtype)
    v = torch.tensor([z % 2 == 0 for z in range(m)], dtype=torch.int32,
                     device=cuda) if gated else None
    first = trsm_block.trsm_substitution(L, B, valid=v)
    assert torch.equal(trsm_block.trsm_substitution(L, B, valid=v), first)


@pytest.mark.gpu
@pytest.mark.parametrize("n,big,ldtype", [(300, 1000, torch.float32),
                                          (4096, 8192, torch.bfloat16)])
def test_trsm_kernel_rows_do_not_depend_on_n(cuda, n, big, ldtype):
    """The leading n rows of a larger system are the order-n system's
    X bit for bit: a row's dot runs over the columns before it only."""
    g = torch.Generator(device=cuda).manual_seed(20)
    L, B = _system(g, cuda, 1, big, 16, torch.float32, ldtype)
    whole = trsm_block.trsm_substitution(L, B)
    lead = trsm_block.trsm_substitution(L[:, :n, :n].contiguous(),
                                        B[:, :n].contiguous())
    assert torch.equal(whole[:, :n], lead)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [16, 40])
@pytest.mark.parametrize("mask", ["all", "half", "alternate"])
def test_trsm_kernel_system_does_not_depend_on_the_stack(cuda, k, mask):
    """Each valid system of a stack of 16 (B6; the chains of all systems
    and, at k = 40, of three column tiles take their tickets interleaved)
    is the same system solved alone (B3) bit for bit, and with every
    system valid B6 is B3 on the stack."""
    g = torch.Generator(device=cuda).manual_seed(21)
    m, n = 16, 1000
    L, B = _system(g, cuda, m, n, k, torch.float32, torch.bfloat16)
    flags = {"all": [1] * m, "half": [1] * (m // 2) + [0] * (m // 2),
             "alternate": [1, 0] * (m // 2)}[mask]
    v = torch.tensor(flags, dtype=torch.int32, device=cuda)
    stack = trsm_block.trsm_substitution(L, B, valid=v)
    for z in range(m):
        if flags[z]:
            alone = trsm_block.trsm_substitution(L[z:z + 1], B[z:z + 1])
            assert torch.equal(stack[z:z + 1], alone), z
        else:
            assert not stack[z].any()
    if mask == "all":
        assert torch.equal(stack, trsm_block.trsm_substitution(L, B))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["inv", "rec"])
def test_capacity_churn_on_the_card(cuda, method):
    """A C = 4 capacity bank served through churn: warmed up empty (all
    zeros), half filled, then waves with a replace (a placed factor), an
    evict and a re-admit between them, all under sync-debug mode
    "error"; BUILD_COUNTS stay put, every live lane's relres is within
    1e-5 of its current factor, dead lanes are zero, and a "rec" bank's
    base cases run B6 only."""
    from repro_torch import api
    from repro_torch.core import session
    n, C, k = 512, 4, 16
    g = torch.Generator(device=cuda).manual_seed(12)

    def fresh():
        L = torch.randn((n, n), generator=g, device=cuda).tril_()
        L.diagonal().add_(n)
        return L

    spec = api.SolveSpec.auto(n, k, grid=api.make_trsm_mesh(1, 1),
                              method=method, n0=128,
                              precision="bf16_refine", bank_width=C)
    solver = api.Solver.from_spec(spec, capacity=C)
    X = solver.warmup(k).solve(torch.randn((C, n, k), generator=g,
                                           device=cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(X).all() and not X.any()
    factors = {}
    for _ in range(C // 2):
        L = fresh()
        factors[solver.admit_factor(L)] = L
    uspec = solver.bank.update_spec()
    builds = (session.BUILD_COUNTS[spec], session.BUILD_COUNTS[uspec])
    Lnew, Lre = fresh(), fresh()
    placed = solver.bank.place_factor(Lnew.cpu())
    Bs = [torch.randn((C, n, k), generator=g, device=cuda)
          for _ in range(3)]
    b3, b6 = (trsm_block.trsm_substitution.launches,
              trsm_block.trsm_substitution.valid_launches)
    outs = []

    def record(B):
        outs.append((solver.solve(B), B, dict(factors)))

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        record(Bs[0])
        solver.replace_factor(0, placed)
        factors[0] = Lnew
        record(Bs[1])
        solver.evict_factor(1)
        del factors[1]
        record(Bs[2])
        assert solver.admit_factor(Lre) == 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    factors[1] = Lre
    record(Bs[0])
    torch.cuda.synchronize()
    assert (session.BUILD_COUNTS[spec],
            session.BUILD_COUNTS[uspec]) == builds
    for X, B, live in outs:
        for s in range(C):
            if s in live:
                r = torch.linalg.norm(live[s].double() @ X[s].double()
                                      - B[s].double()) \
                    / torch.linalg.norm(B[s].double())
                assert r.item() <= 1e-5, (s, r.item())
            elif method == "rec" or s >= C // 2:
                # B6 gates an evicted lane off; an empty "inv" lane
                # sweeps its zero Dt
                assert not X[s].any(), s
    passes = solver.policy.refine_steps + 1
    if method == "rec":
        assert trsm_block.trsm_substitution.launches == b3
        assert trsm_block.trsm_substitution.valid_launches - b6 \
            == len(outs) * (n // 128) * passes
    else:
        assert trsm_block.trsm_substitution.valid_launches == b6


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["inv", "rec"])
def test_padded_admission_on_the_card(cuda, method):
    """pad_to=n admits an order-d factor as blockdiag(L, I): the tail
    solves to exact zeros, and the leading block equals an unpadded
    order-d bank's of the same width (4) bit for bit.  (Every width:
    test_padded_solve_is_bit_identical_at_every_width.)"""
    from repro_torch import api
    n, d, C, k = 1024, 512, 4, 16
    g = torch.Generator(device=cuda).manual_seed(13)
    T = torch.randn((d, d), generator=g, device=cuda).tril_()
    T.diagonal().add_(d)
    grid = api.make_trsm_mesh(1, 1)
    kw = dict(method=method, n0=256 if method == "inv" else None,
              precision="bf16_refine", capacity=C)
    big, small = api.FactorBank(grid, n, **kw), api.FactorBank(grid, d, **kw)
    assert big.admit(T, pad_to=n) == 0 and small.admit(T) == 0
    B = torch.randn((d, k), generator=g, device=cuda)
    Bb = torch.zeros((C, n, k), device=cuda)
    Bb[0, :d] = B
    Bs = torch.zeros((C, d, k), device=cuda)
    Bs[0] = B
    Xb = api.Solver.from_bank(big).solve(Bb)
    Xs = api.Solver.from_bank(small).solve(Bs)
    torch.cuda.synchronize()
    assert torch.equal(Xb[0, :d], Xs[0])
    assert not Xb[:, d:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("m,n0,mask", [(3, 16, (1, 0, 1)),
                                       (2, 256, (1, 0)),
                                       (4, 128, (0, 1, 1, 0)),
                                       (2, 1024, (1, 0)),
                                       (2, 4096, (0, 1))])
def test_tri_inv_valid_kernel_matches_plain(cuda, dtype, m, n0, mask):
    """B5 against its plain version: the valid blocks within B1's
    tolerance, the flagged ones exact zeros; NaN planted in every
    flagged block changes no bit; an all-ones mask is B1 bit for bit.
    The gated launches are counted apart from B1's."""
    g = torch.Generator(device=cuda).manual_seed(15)
    Ls = (torch.randn((m, n0, n0), generator=g, device=cuda).tril_()
          + n0 * torch.eye(n0, device=cuda)).to(dtype)
    v = torch.tensor(mask, dtype=torch.int32, device=cuda)
    live = v.bool()
    b1, b5 = (tri_inv_block.tri_inv_blocks.launches,
              tri_inv_block.tri_inv_blocks.valid_launches)
    got = tri_inv_block.tri_inv_blocks(Ls, valid=v)
    assert (tri_inv_block.tri_inv_blocks.launches,
            tri_inv_block.tri_inv_blocks.valid_launches) == (b1, b5 + 1)
    want = tri_inv_block.tri_inv_blocks_plain(Ls, valid=v)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= tol * scale
    low = torch.tril(want[live].double(), -1).abs().max().item()
    assert torch.tril((got[live] - want[live]).double(), -1).abs().max() \
        .item() <= tol * low
    assert not got[~live].any()
    Lp = Ls.clone()
    Lp[~live] = float("nan")
    assert torch.equal(tri_inv_block.tri_inv_blocks(Lp, valid=v), got)
    assert torch.equal(
        tri_inv_block.tri_inv_blocks(Ls, valid=torch.ones_like(v)),
        tri_inv_block.tri_inv_blocks(Ls))


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [0, 1])
def test_tri_inv_valid_block_is_b1_alone(cuda, valid):
    """A padded admission's contract at the kernel: B5 over (2, 4096,
    4096) with one block valid gives, in that block, the bits B1 gives
    on that block alone (a stack of one, so other tiles and pairings),
    and zeros in the other."""
    g = torch.Generator(device=cuda).manual_seed(17)
    n0 = 4096
    Ls = torch.randn((2, n0, n0), generator=g, device=cuda).tril_() \
        + n0 * torch.eye(n0, device=cuda)
    v = torch.zeros(2, dtype=torch.int32, device=cuda)
    v[valid] = 1
    got = tri_inv_block.tri_inv_blocks(Ls, valid=v)
    alone = tri_inv_block.tri_inv_blocks(Ls[valid:valid + 1])
    torch.cuda.synchronize()
    assert torch.equal(got[valid].view(torch.int32),
                       alone[0].view(torch.int32))
    assert not got[1 - valid].any()


@pytest.mark.gpu
@pytest.mark.parametrize("lower,transpose", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_padded_dt_is_b1_on_the_card(cuda, lower, transpose):
    """A padded admission runs phase 1 on B5 (one gated launch, no B1),
    and the slot's resident Dt equals B1 on the whole padded, reduced
    stack under torch.equal: the identity tail's blocks, never read,
    come out as the identity B1 inverts them to."""
    from repro_torch import api
    from repro_torch.core import inv_trsm
    n, d, n0 = 1024, 512, 256
    g = torch.Generator(device=cuda).manual_seed(16)
    T = torch.randn((d, d), generator=g, device=cuda).tril_()
    T.diagonal().add_(d)
    if not lower:
        T = T.T.contiguous()
    bank = api.FactorBank(api.make_trsm_mesh(1, 1), n, n0=n0,
                          precision="bf16_refine", lower=lower,
                          transpose=transpose, capacity=2)
    b1, b5 = (tri_inv_block.tri_inv_blocks.launches,
              tri_inv_block.tri_inv_blocks.valid_launches)
    slot = bank.admit(T, pad_to=n)
    assert (tri_inv_block.tri_inv_blocks.launches,
            tri_inv_block.tri_inv_blocks.valid_launches) == (b1, b5 + 1)
    L_lo, Dt = bank.stacks()[:2]
    want = inv_trsm.invert_diag_blocks(
        L_lo[slot:slot + 1], n0=n0, block_inv=tri_inv_block.tri_inv_blocks,
        accum_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(Dt[slot:slot + 1], want)


_PAD_CASES = [(1024, 512, "inv", 256, prec, lo, tr)
              for prec in ("fp32", "bf16_refine")
              for lo, tr in ((True, False), (True, True), (False, False),
                             (False, True))] \
    + [(1024, 512, "rec", None, prec, True, False)
       for prec in ("fp32", "bf16_refine")] \
    + [(8192, 4096, method, n0, prec, True, False)
       for method, n0 in (("inv", 4096), ("rec", None))
       for prec in ("fp32", "bf16_refine")] \
    + [(8192, 2048, "inv", 4096, prec, True, False)
       for prec in ("fp32", "bf16_refine")]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("n,d,method,n0,precision,lower,transpose",
                         _PAD_CASES)
def test_padded_solve_is_bit_identical_at_every_width(
        cuda, C, n, d, method, n0, precision, lower, transpose):
    """The padding contract (FactorBank.admit(pad_to=)) at every bank
    width: an order-d factor padded into an order-n capacity bank of
    width C solves its leading d x 16 block bit for bit as the same
    factor in an order-d bank of width C, at the same n0 ("rec": n0 =
    n; an order below n0 is one block of its own order), and its tail
    to exact zeros.  The widths and orders include the fleet's: buckets
    of 8 and 4, 12 after a migration, order 2048 padded into 8192 at
    n0 = 4096.  At width 1 the banks serve with fixed_order (the
    products on ops.gemm: cuBLAS sums a width-1 product by shape);
    wider banks keep cuBLAS."""
    from repro_torch import api
    k = 16
    g = torch.Generator(device=cuda).manual_seed(17)
    T = torch.randn((d, d), generator=g, device=cuda).tril_()
    T.diagonal().add_(d)
    if not lower:
        T = T.T.contiguous()
    b = torch.randn((d, k), generator=g, device=cuda)
    grid = api.make_trsm_mesh(1, 1)
    kw = dict(method=method, n0=n0, precision=precision, lower=lower,
              transpose=transpose, capacity=C)
    big = api.FactorBank(grid, n, **kw)
    small = api.FactorBank(grid, d, **dict(kw, n0=n0 and min(n0, d)))
    big.admit(T, pad_to=n)
    small.admit(T)
    Bb = torch.zeros((C, n, k), device=cuda)
    Bb[0, :d] = b
    Bs = torch.zeros((C, d, k), device=cuda)
    Bs[0] = b
    sb, ss = api.Solver.from_bank(big), api.Solver.from_bank(small)
    assert sb.spec_for(k).fixed_order == ss.spec_for(k).fixed_order \
        == (C == 1)
    launches = trmm.gemm.launches
    Xb, Xs = sb.solve(Bb)[0], ss.solve(Bs)[0]
    torch.cuda.synchronize()
    if C > 1 or precision == "bf16_refine":
        assert (trmm.gemm.launches > launches) == (C == 1)
    assert torch.equal(Xb[:d], Xs)
    assert not Xb[d:].any()
    op = T.T if transpose else T              # the operator solved
    r = torch.linalg.norm(op.double() @ Xs.double() - b.double()) \
        / torch.linalg.norm(b.double())
    assert r.item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("lower", [False, True])
def test_gemm_kernel_matches_plain_and_sums_in_one_order(cuda, dtype,
                                                         lower):
    """ops.gemm on a row-strided block column against its plain version
    within trmm's tolerance, and the rows it shares with a shorter (or,
    lower triangular, a smaller) operand bit for bit; and the whole
    order contract bit for bit (``trmm.gemm_order_checks``): two
    launches, rows shared with a shorter operand, a batch entry against
    its matrix alone, N = 8 against 16 and 16 against 48, K not a
    multiple of KC and K across several chunks against zero padding,
    an order-d operand padded with the identity into order n, ``lower``
    (NaN above the diagonal) against explicit zeros, a strided and a
    misaligned view against a contiguous copy."""
    g = torch.Generator(device=cuda).manual_seed(18)
    n, r, k = 512, 128, 16
    L = torch.randn((2, n, n), generator=g, device=cuda).to(dtype)
    A = L if lower else L[:, r:, :r]             # a strided view
    X = torch.randn((2, A.shape[-1], k), generator=g,
                    device=cuda).to(dtype)
    launches = trmm.gemm.launches
    got = trmm.gemm(A, X, lower=lower)
    assert trmm.gemm.launches == launches + 1
    want = trmm.gemm_plain(A, X, lower)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() \
        <= tol * scale
    if lower:
        part = trmm.gemm(L[:, :r, :r].contiguous(),
                         X[:, :r].contiguous(), lower=True)
    else:
        part = trmm.gemm(A[:, :r], X)
    assert torch.equal(got[:, :r], part)
    checks = trmm.gemm_order_checks(dtype, cuda, seed=int(lower))
    torch.cuda.synchronize()
    assert all(checks.values()), checks


# ------------------------- the async tier -------------------------

def _async_server(cuda, *, n=1024, M=2, k=16, capacity=None, **kw):
    """An AsyncSolveServer over M order-n factors on the card
    (bf16_refine, n0 = n / 2), warmed up; returns (server, Ls)."""
    from repro_torch import api
    g = torch.Generator(device=cuda).manual_seed(23)
    Ls = torch.randn((M, n, n), generator=g, device=cuda).tril_()
    Ls.diagonal(dim1=1, dim2=2).add_(n)
    bank = api.FactorBank(api.make_trsm_mesh(1, 1), n, n0=n // 2,
                          precision="bf16_refine", capacity=capacity)
    if capacity is None:
        bank.admit_stack(Ls)
    else:
        for L in Ls:
            bank.admit(L)
    solver = api.Solver.from_bank(bank)
    return api.AsyncSolveServer(solver, k, **kw).warmup(), Ls


def _relres(L, X, b) -> float:
    return (torch.linalg.norm(L.double() @ X.double() - b.double())
            / torch.linalg.norm(b.double())).item()


@pytest.mark.gpu
def test_async_steady_state_builds_nothing_and_never_syncs(cuda):
    """The reference's zero-retrace/zero-transfer steady state on the
    card: RHS already on the device, one priming wave, then submit and
    step() by hand at max_inflight = 2 under sync-debug mode "error"
    (a host sync raises) — the event wait in _finalize_one included —
    with no program built; every request within the bf16_refine bound
    (1e-5)."""
    from repro_torch.core import session
    srv, Ls = _async_server(cuda, max_inflight=2)
    g = torch.Generator(device=cuda).manual_seed(24)
    bs = [torch.randn((1024, 4), generator=g, device=cuda)
          for _ in range(16)]
    srv.submit(bs[0], factor=0)                  # priming wave
    while srv.pending() or srv._inflight:
        srv.step()
    spec = srv.solver.spec_for(srv.panel_k)
    builds = session.BUILD_COUNTS[spec]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        futs = [srv.submit(b, factor=i % 2) for i, b in enumerate(bs)]
        while srv.pending():
            srv.step()
        srv.flush()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert session.BUILD_COUNTS[spec] == builds == 1
    assert srv.stats()["waves"] == 1 + 2         # 4 + 4 requests a slot
    for i, (b, f) in enumerate(zip(bs, futs)):
        assert _relres(Ls[i % 2], f.result(timeout=0), b) <= 1e-5


@pytest.mark.gpu
def test_async_future_waits_for_its_event(cuda):
    """A dispatched wave's future is not done before the CUDA event
    recorded behind it has completed: with half a second of device
    time queued ahead of the wave, step() returns with the wave in
    flight, its event pending and its future open; flush() waits on
    the event, then resolves the future with a completion stamp after
    that wait."""
    srv, Ls = _async_server(cuda, n=256, M=1, max_inflight=2)
    b = torch.randn((256, 4), device=cuda)
    fut = srv.submit(b)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)             # ~0.5 s on the stream
    assert srv.step() == 1
    (pairs, done), = srv._inflight
    assert isinstance(done, torch.cuda.Event)
    assert not done.query() and not fut.done()
    srv.flush()
    assert done.query() and fut.done() and not srv._inflight
    assert fut.latency() > 0.1                   # it waited on the card
    assert _relres(Ls[0], fut.result(timeout=0), b) <= 1e-5


@pytest.mark.gpu
def test_async_producers_race_churn_on_the_card(cuda):
    """The reference's stress test on CUDA tensors: four producer
    threads submit device RHS against one real drain loop while a churn
    thread replaces and evicts/re-admits slots 2-3 of a capacity bank:
    every future completes (served or typed-stranded, never a hang),
    counts conserve, the wave program is never rebuilt, and every
    request to the steady slots 0-1 meets the bf16_refine bound."""
    import threading

    from repro_torch import api
    from repro_torch.core import session
    n, C = 512, 4
    srv, Ls = _async_server(cuda, n=n, M=C, capacity=C, queue_depth=16)
    bank = srv.solver.bank
    spec = srv.solver.spec_for(srv.panel_k)
    builds = session.BUILD_COUNTS[spec]
    N, per = 4, 25
    futures, shed = [], [0] * N
    flock = threading.Lock()
    barrier = threading.Barrier(N + 2)
    stop_churn = threading.Event()
    errors = []

    def producer(w):
        try:
            g = torch.Generator(device=cuda).manual_seed(100 + w)
            barrier.wait()
            for i in range(per):
                b = torch.randn((n, 1), generator=g, device=cuda)
                slot = (w + i) % 2           # churn owns slots 2/3
                try:
                    f = srv.submit(b, factor=slot, tenant=f"w{w}")
                except api.Overloaded:
                    shed[w] += 1
                    continue
                with flock:
                    futures.append((slot, b, f))
        except Exception as e:                # pragma: no cover
            errors.append(e)

    def churn():
        try:
            g = torch.Generator(device=cuda).manual_seed(999)
            barrier.wait()
            i = 0
            while not stop_churn.is_set():
                slot = 2 + i % 2
                L = torch.randn((n, n), generator=g, device=cuda).tril_()
                L.diagonal().add_(n)
                if i % 3:
                    bank.replace(slot, L)     # generation-preserving
                else:
                    bank.evict(slot)
                    bank.admit(L)             # turnover: strands queue
                i += 1
        except Exception as e:                # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(w,))
               for w in range(N)] + [threading.Thread(target=churn)]
    for t in threads:
        t.start()
    with srv:
        barrier.wait()
        for t in threads[:-1]:
            t.join(60)
        stop_churn.set()
        threads[-1].join(60)
        for slot in (2, 3):                   # the churned slots too
            if bank.is_live(slot):
                try:
                    futures.append((slot, None, srv.submit(
                        torch.zeros((n, 1), device=cuda), factor=slot)))
                except (ValueError, api.Overloaded):
                    pass
    assert not errors
    assert not any(t.is_alive() for t in threads)
    assert all(f.done() for _, _, f in futures)
    outcomes = [f.exception() for _, _, f in futures]
    assert all(e is None or isinstance(e, api.StrandedRequestError)
               for e in outcomes)
    st = srv.stats()
    assert st["served"] + st["stranded"] == len(futures)
    assert st["shed"] == sum(shed)
    assert session.BUILD_COUNTS[spec] == builds
    for slot, b, f in futures:
        if slot < 2:
            assert _relres(Ls[slot], f.result(timeout=0), b) <= 1e-5


# ---------------- the factor producers and K-FAC on the card ----------------

@pytest.mark.gpu
@pytest.mark.parametrize("s0", [None, 768])
def test_phase_a_pads_a_non_power_of_two_block_on_the_card(cuda, s0):
    """At n = 1536 phase A's blocks (1536, or two of 768) are not powers
    of two: B1 takes them with an identity tail (one launch at order 2048
    or two blocks of 1024), and the inverse is the plain doubling's,
    held as the inverse tests above hold B1 (1e-4 of its largest entry,
    and its strictly lower part 1e-4 of that part's)."""
    from repro_torch import api
    from repro_torch.core import blocked, tri_inv
    n = 1536
    g = torch.Generator(device=cuda).manual_seed(11)
    L = torch.randn((n, n), generator=g, device=cuda).tril_()
    L.diagonal().add_(n)
    launches = tri_inv_block.tri_inv_blocks.launches
    got = tri_inv.invert(L, api.make_trsm_mesh(1, 1), s0=s0)
    want = blocked.tri_inv_doubling(L)
    torch.cuda.synchronize()
    assert tri_inv_block.tri_inv_blocks.launches == launches + 1
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale
    lower = torch.tril(want, -1).abs().max()
    assert torch.tril(got - want, -1).abs().max() <= 1e-4 * lower
    assert not torch.triu(got, 1).any()


@pytest.mark.gpu
def test_cholesky_at_6144_on_the_card(cuda):
    """n = 6144 recurses at n0 = 768: the panel inversions (orders 3072,
    1536 and 768, 7 in all) go into B1 padded; ||L L^T - A|| / ||A|| in
    fp64 within 10x of torch.linalg.cholesky's on a damped Gram matrix."""
    from repro_torch import api
    from repro_torch.core import cholesky
    n = 6144
    g = torch.Generator(device=cuda).manual_seed(12)
    G = torch.randn((n, 2 * n), generator=g, device=cuda)
    A = G @ G.T / (2 * n)
    A.diagonal().add_(1e-2)
    del G
    launches = tri_inv_block.tri_inv_blocks.launches
    L = cholesky.cholesky(A, api.make_trsm_mesh(1, 1))
    torch.cuda.synchronize()
    assert tri_inv_block.tri_inv_blocks.launches == launches + 7
    A64 = A.double()

    def rel(F):
        F = F.double()
        return (torch.linalg.norm(F @ F.T - A64)
                / torch.linalg.norm(A64)).item()

    assert rel(L) <= 10 * rel(torch.linalg.cholesky(A))
    assert not torch.triu(L, 1).any()


@pytest.mark.gpu
def test_kfac_step_and_refresh_build_nothing_and_never_sync(cuda):
    """A K-FAC step and an in-place bank refresh, once warm, run under
    sync-debug mode "error" (no host sync: the step, the refresh
    decision and the grafting scale stay on the card) and build no
    program; each new damped factor L of M holds
    ||L L^T - (M + lam I)|| / ||M + lam I|| in fp64 within 10x of
    torch.linalg.cholesky's on the same matrix, and the refreshed banks
    serve those factors within the fp32 bound (1e-5,
    tests/test_api_solver.py)."""
    import importlib

    from repro_torch import api
    from repro_torch.core import session
    from repro_torch.optim.tree import tree_map
    kfac = importlib.import_module("repro_torch.optim.kfac_ca")
    grid = api.make_trsm_mesh(1, 1)
    g = torch.Generator(device=cuda).manual_seed(13)
    params = {"w": torch.randn((256, 128), generator=g, device=cuda),
              "stack": torch.randn((2, 256, 128), generator=g,
                                   device=cuda),
              "norm": torch.ones((256,), device=cuda)}
    opt = kfac.kfac_ca()
    state = opt.init(params)

    def grads():
        return tree_map(lambda p: torch.randn(p.shape, generator=g,
                                              device=cuda), params)

    for _ in range(2):
        params, state, _ = opt.update(grads(), state, params)
    banks, manifest = kfac.factor_banks_from_state(state, grid=grid)
    kfac.refresh_banks(banks, manifest, state)        # builds its updaters
    gr = grads()
    counts = dict(session.BUILD_COUNTS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, state, _ = opt.update(gr, state, params)
        kfac.refresh_banks(banks, manifest, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert dict(session.BUILD_COUNTS) == counts
    emas = {(n, s): M for n, s, M in kfac._iter_kron_factors(state)}
    for M in emas.values():
        d = M.shape[-1]
        tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
        Md = M + (1e-3 * (tr / d + 1e-12))[..., None, None] \
            * torch.eye(d, device=cuda)
        M64 = Md.double()
        res, res_lib = (
            torch.linalg.matrix_norm(F @ F.transpose(-2, -1) - M64)
            / torch.linalg.matrix_norm(M64)
            for F in (kfac._damped_chol(M, 1e-3).double(),
                      torch.linalg.cholesky(Md).double()))
        assert bool((res <= 10 * res_lib).all()), (d, res, res_lib)
    for d, bank in banks.items():
        B = torch.randn((bank.width, d, 16), generator=g, device=cuda)
        X = api.Solver.from_bank(bank).solve(B).double()
        for i, (name, side, unit) in enumerate(manifest[d]):
            M = emas[(name, side)]
            L = kfac._damped_chol(M if unit is None else M[unit],
                                  1e-3).double()
            relres = (torch.linalg.norm(L @ X[i] - B[i].double())
                      / torch.linalg.norm(B[i].double())).item()
            assert relres < 1e-5, (d, i, relres)


# ----------------------- distributed (p > 1) -----------------------
#
# 8 gloo ranks of a 2 x 2 x 2 grid share cuda:0 (each has its own CUDA
# context; gloo stages the collectives through the host), against the
# same ranks on the CPU, where every kernel is its plain version.

DIST_N, DIST_K = 512, 64


def _dist_solve(grid, method):
    """One rank's part: the one-shot solve at n = 512 ("inv" at n0 = 64,
    m = p, all-to-all phase 1; "rec" at its default n0), X on every rank,
    and the launches of B1, B2 and B3 it made; for "refine", the relres
    of a bf16_refine solve, that of a structured (banded:64) bf16_refine
    solve against the masked operator, and the B4 launches the
    structured solve made."""
    from repro_torch import api, core
    from repro_torch.core import selfcheck
    counters = (tri_inv_block.tri_inv_blocks, trmm.trmm,
                trsm_block.trsm_substitution)
    L = torch.as_tensor(selfcheck.random_tril(DIST_N, DIST_N))
    B = torch.as_tensor(selfcheck.rhs(5, DIST_N, DIST_K))
    if method == "refine":
        X = core.trsm(L.float(), B.float(), grid, n0=64,
                      precision="bf16_refine").cpu().double()
        relres = (torch.linalg.norm(L @ X - B) / torch.linalg.norm(B)).item()
        st = api.FactorStructure.banded(64)
        Lm = torch.as_tensor(selfcheck.masked(L.numpy(), st, 64))
        trmm.trmm_masked.launches = 0
        solver = api.Solver.from_factor(L.float(), grid, n0=64, structure=st,
                                        precision="bf16_refine")
        Xs = solver.solve(B.float()).cpu().double()
        rel_st = (torch.linalg.norm(Lm @ Xs - B)
                  / torch.linalg.norm(B)).item()
        return relres, rel_st, trmm.trmm_masked.launches
    for c in counters:
        c.launches = 0
    X = core.trsm(L, B, grid, method=method,
                  n0=64 if method == "inv" else None)
    return X.cpu().numpy(), [c.launches for c in counters]


@pytest.mark.gpu
@pytest.mark.parametrize("method,kernels", [("inv", (0, 1)), ("rec", (2,))])
def test_distributed_solve_on_the_card(cuda, method, kernels):
    """X on the card within 1e-10 (fp64, relative to max|X|) of the plain
    CPU run of the same ranks, on every rank; B1 and B2 ("inv") or B3
    ("rec") launched in every rank on the card and in none on the CPU."""
    import numpy as np
    from repro_torch.core import selfcheck
    on_card = selfcheck.spawn(2, 2, "cuda:0", _dist_solve, method)
    plain = selfcheck.spawn(2, 2, "cpu", _dist_solve, method)
    want = plain[0][0]
    for (X, launches), (_, cpu_launches) in zip(on_card, plain):
        assert np.abs(X - want).max() <= 1e-10 * np.abs(want).max()
        assert all(launches[i] > 0 for i in kernels), launches
        assert cpu_launches == [0, 0, 0]


@pytest.mark.gpu
def test_distributed_refinement_preset_raises(cuda):
    """A refinement preset on a p > 1 grid answers in every rank within
    its bound (the distributed residual), and so does a structured
    solve (once it raised, naming the next slice): relres against the
    masked operator within 1e-5, its residuals' local products on B4 in
    every rank."""
    from repro_torch.core import selfcheck
    for relres, rel_st, b4 in selfcheck.spawn(2, 2, "cuda:0", _dist_solve,
                                              "refine"):
        assert relres < 1e-5, relres
        assert rel_st < 1e-5, rel_st
        assert b4 > 0, b4


def _dist_structured(grid, method):
    """One rank's part: a structured (banded:64) fp64_refine solve at
    n = 512, n0 = 64 through ``Solver.from_factor``, X on every rank,
    and the launches of B4 (each residual's local product), B2 and B3
    it made."""
    from repro_torch import api
    from repro_torch.core import selfcheck
    counters = (trmm.trmm_masked, trmm.trmm, trsm_block.trsm_substitution)
    L = torch.as_tensor(selfcheck.random_tril(DIST_N, DIST_N))
    B = torch.as_tensor(selfcheck.rhs(6, DIST_N, DIST_K))
    for c in counters:
        c.launches = 0
    solver = api.Solver.from_factor(L, grid, method=method, n0=64,
                                    structure=api.FactorStructure.banded(64),
                                    precision="fp64_refine")
    X = solver.solve(B)
    return X.cpu().numpy(), [c.launches for c in counters]


@pytest.mark.gpu
@pytest.mark.parametrize("method,kernels", [("inv", (0, 1)), ("rec", (0, 2))])
def test_distributed_structured_solve_on_the_card(cuda, method, kernels):
    """A structured solve at p > 1 on the card (8 gloo ranks on cuda:0):
    X within 1e-10 (fp64_refine, relative to max|X|) of the same ranks'
    plain CPU run, on every rank; B4 (the residual) and B2 ("inv") or B3
    ("rec") launched in every rank on the card and in none on the
    CPU."""
    import numpy as np
    from repro_torch.core import selfcheck
    on_card = selfcheck.spawn(2, 2, "cuda:0", _dist_structured, method)
    plain = selfcheck.spawn(2, 2, "cpu", _dist_structured, method)
    want = plain[0][0]
    for (X, launches), (_, cpu_launches) in zip(on_card, plain):
        assert np.abs(X - want).max() <= 1e-10 * np.abs(want).max()
        assert all(launches[i] > 0 for i in kernels), launches
        assert cpu_launches == [0, 0, 0]


def _dist_factor(grid):
    """One rank's part: ``cholesky`` and ``lu`` of order 512 in fp64,
    the whole factors on every rank, and the B1 launches they made."""
    from repro_torch.core import cholesky, lu, selfcheck
    tri_inv_block.tri_inv_blocks.launches = 0
    A = torch.as_tensor(selfcheck.spd(7, DIST_N))
    L = cholesky.cholesky(A, grid)
    Lu, U = lu.lu(torch.as_tensor(selfcheck.lu_input(8, DIST_N)), grid)
    return ([F.cpu().numpy() for F in (L, Lu, U)],
            tri_inv_block.tri_inv_blocks.launches)


@pytest.mark.gpu
def test_distributed_factorizations_on_the_card(cuda):
    """Multi-rank Cholesky and LU on the card (8 gloo ranks on cuda:0):
    L, and L and U, within 1e-10 (relative to their largest entry) of
    the same ranks' plain CPU run, on every rank; B1 launched in every
    rank's panel inversions on the card and in none on the CPU."""
    import numpy as np
    from repro_torch.core import selfcheck
    on_card = selfcheck.spawn(2, 2, "cuda:0", _dist_factor)
    plain = selfcheck.spawn(2, 2, "cpu", _dist_factor)
    wants = plain[0][0]
    for (got, launches), (_, cpu_launches) in zip(on_card, plain):
        for F, W in zip(got, wants):
            assert np.abs(F - W).max() <= 1e-10 * np.abs(W).max()
        assert launches > 0 and cpu_launches == 0


def _dist_bank(grid):
    """One rank's part of the bank case: a capacity bank's lifecycle
    ("inv" bf16_refine with a padded admission, "rec" fp32 with dead
    lanes) and the padded identity (``selfcheck.check_capacity`` and
    ``check_padded``), with the gated launches (B5, B6) they made."""
    from repro_torch.core import selfcheck
    counters = (tri_inv_block.tri_inv_blocks, trsm_block.trsm_substitution)
    for c in counters:
        c.valid_launches = 0
    out = [selfcheck.check_capacity(grid, case) for case in
           ((2, 2, "inv", "bf16_refine"), (2, 2, "rec", "fp32"))]
    out.append(selfcheck.check_padded(grid, (2, 2, 128, 64, 16)))
    return ([(r["ok"], r["line"], r["out"]) for r in out],
            [c.valid_launches for c in counters])


@pytest.mark.gpu
def test_distributed_bank_on_the_card(cuda):
    """A p > 1 capacity bank on the card (8 gloo ranks on cuda:0): every
    lifecycle and padded-identity check passes in every rank, the last
    wave's X within 2e-5 of the same ranks' plain CPU run, B5 (padded
    phase 1) and B6 (rec's dead lanes) launched in every rank on the
    card and in none on the CPU."""
    import numpy as np
    from repro_torch.core import selfcheck
    on_card = selfcheck.spawn(2, 2, "cuda:0", _dist_bank)
    plain = selfcheck.spawn(2, 2, "cpu", _dist_bank)
    for (rows, launches), (cpu_rows, cpu_launches) in zip(on_card, plain):
        for (ok, line, X), (_, _, want) in zip(rows, cpu_rows):
            assert ok, line
            if X is not None:
                assert np.abs(X - want).max() <= 2e-5 * np.abs(want).max()
        assert all(v > 0 for v in launches), launches
        assert cpu_launches == [0, 0]


@pytest.mark.gpu
def test_distributed_selfcheck_runs_on_the_card(cuda):
    """``python -m repro_torch.core.selfcheck`` with no ``--device`` puts
    every rank on cuda:0 and passes every check on every grid: the
    kernels take the layouts the distributed bodies hand them (rec's
    base case on the 1 x 1 x 8 grid gathers pieces one column wide)."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.core.selfcheck"],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    failed = [line for line in proc.stdout.splitlines() if "FAIL" in line]
    assert proc.returncode == 0 and "selfcheck: 0 failures" in proc.stdout, \
        "\n".join(failed) + f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}"


@pytest.mark.gpu
def test_lm_decode_matches_forward_at_full_width(cuda):
    """qwen3-1.7b's full widths (d_model 2048, 16 heads over 8 KV heads,
    head_dim 128, d_ff 6144, vocab 151936) at 2 layers, bf16: 12 tokens
    decoded one by one through the cache, the last position's logits
    against ``lm.forward`` on the same tokens within 2e-2 of the largest
    logit (bf16), and the argmax the same at every sequence."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"), n_layers=2)
    params = lm.init(cfg, 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=g, device=cuda)
    full, _ = lm.forward(params, cfg, tokens, last_only=True)
    cache = lm.init_cache(cfg, 2, 12, device=cuda)
    for t in range(12):
        last, cache = lm.decode_step(params, cfg, tokens[:, t:t + 1], cache)
    got, want = last[:, 0].float(), full[:, 0].float()
    scale = want[:, :cfg.vocab].abs().max()
    assert ((got - want).abs()[:, :cfg.vocab] <= 2e-2 * scale).all()
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.gpu
def test_lm_kfac_train_step_launches_tri_inv_blocks(cuda):
    """One ``kfac_ca`` step of the qwen3 smoke model through
    ``make_train_step`` on the card (fp32, TF32 off) launches B1, and
    each parameter's move is within 1e-3 of its largest entry of the
    same step's on the CPU, which launches nothing (a preconditioned
    update's tolerance, tests/test_torch_optim.py: damped factors of
    condition ~1e4 through 14 Denman-Beavers iterations)."""
    _kfac_step_on_the_card_and_the_cpu("qwen3-1.7b", cuda)


@pytest.mark.gpu
def test_recurrent_kfac_train_step_launches_tri_inv_blocks(cuda):
    """As the qwen3 one, on recurrentgemma-2b's smoke model (RG-LRU
    blocks and a local-attention block, their stacked weights
    preconditioned together)."""
    _kfac_step_on_the_card_and_the_cpu("recurrentgemma-2b", cuda)


def _kfac_step_on_the_card_and_the_cpu(arch, cuda):
    from repro_torch import configs, optim
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.optim.tree import leaves_with_path, tree_map
    from repro_torch.train import train_step
    cfg = configs.get_smoke(arch)
    batch = synthetic.host_batch(cfg, 16, 4, step=0)
    params = lm.init(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        opt = optim.get("kfac_ca", lr=1e-2)
        p = tree_map(lambda t: t.to(dev), params)
        step = train_step.make_train_step(cfg, opt, dtype=torch.float32)
        before = tri_inv_block.tri_inv_blocks.launches
        p2, s2, m = step(p, opt.init(p), batch)
        torch.cuda.synchronize()
        out[str(dev)] = (p2, m, tri_inv_block.tri_inv_blocks.launches
                         - before)
    (pc, mc, nc), (pg, mg, ng) = out["cpu"], out[str(cuda)]
    assert nc == 0 and ng > 0
    assert abs(mg["loss"].item() - mc["loss"].item()) <= 1e-4 * abs(
        mc["loss"].item())
    for (path, a), (_, b), (_, p0) in zip(leaves_with_path(pg),
                                          leaves_with_path(pc),
                                          leaves_with_path(params)):
        got, want = a.cpu() - p0, b - p0
        slack = 2 * torch.finfo(torch.float32).eps * p0.abs().max()
        assert (got - want).abs().max() <= 1e-3 * want.abs().max() + slack, \
            path


@pytest.mark.gpu
def test_moe_grouped_forward_matches_the_cpu(cuda, monkeypatch):
    """grok-1's smoke MoE block with ``MOE_GROUP`` patched to 16: 64
    tokens routed in 4 groups, each with its own capacity at the
    default 1.25 (an expert overflows and drops tokens), fp32, TF32
    off: every group's experts the CPU's exactly (the stable sort
    orders ties alike on both devices), y and aux within 1e-5 of their
    largest entries."""
    from repro_torch import configs
    from repro_torch.core import precision
    from repro_torch.models import layers
    precision.pin_matmul_numerics()
    cfg = configs.get_smoke("grok-1-314b")
    g = torch.Generator().manual_seed(3)
    p = layers.init_moe(g, cfg)
    x = torch.randn((2, 32, cfg.d_model), generator=g)
    monkeypatch.setattr(layers, "MOE_GROUP", 16)
    top_k, picked = layers._top_k, {}

    def record(dev):
        def fn(gates, k):
            vals, idx = top_k(gates, k)
            picked.setdefault(dev, []).append(idx.cpu())
            return vals, idx
        return fn

    out = {}
    for dev in ("cpu", cuda):
        monkeypatch.setattr(layers, "_top_k", record(str(dev)))
        y, aux = layers.moe_apply({k: v.to(dev) for k, v in p.items()},
                                  x.to(dev), cfg)
        out[str(dev)] = (y.cpu(), aux.cpu())
    (yc, ac), (yg, ag) = out["cpu"], out[str(cuda)]
    assert len(picked["cpu"]) == 4
    for a, b in zip(picked["cpu"], picked[str(cuda)]):
        assert torch.equal(a, b)
    cap = int(cfg.moe_capacity * cfg.topk * 16 / cfg.n_experts)
    assert max(torch.bincount(e.flatten()).max().item()
               for e in picked["cpu"]) > cap
    assert (yg - yc).abs().max() <= 1e-5 * yc.abs().max()
    assert abs(ag.item() - ac.item()) <= 1e-5 * abs(ac.item())


def _mesh_kfac(device):
    """One fp32 kfac_ca ``jit_train_step`` of the qwen3 smoke model in
    this rank of a (2, 1) ("data", "model") mesh (a microbatch a data
    rank), and the same step run by this rank alone: (B1 launches in the
    sharded step, the worst leaf's error over its largest entry, the
    two losses)."""
    from repro_torch import configs, optim
    from repro_torch.core import precision
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models import sharding as sr
    from repro_torch.optim.tree import leaves
    from repro_torch.train import train_step
    precision.pin_matmul_numerics()
    cfg = configs.get_smoke("qwen3-1.7b")
    mesh = make_debug_mesh(2, 1)
    params = lm.init(cfg, 0, device=device)
    opt = optim.get("kfac_ca", lr=1e-2)
    state = opt.init(params)
    batch = synthetic.host_batch(cfg, 16, 4, step=0)
    kw = dict(microbatches=2, dtype=torch.float32)
    step = train_step.jit_train_step(cfg, mesh, opt, params, state, batch,
                                     **kw)
    ps, os_, bs = train_step.shardings_for(cfg, mesh, params, state, batch)
    before = tri_inv_block.tri_inv_blocks.launches
    p, _, m = step(sr.shard(params, ps), sr.shard(state, os_),
                   sr.shard(batch, bs))
    torch.cuda.synchronize()
    launches = tri_inv_block.tri_inv_blocks.launches - before
    got = sr.gather(p, ps)
    want, _, m1 = train_step.make_train_step(cfg, opt, **kw)(params, state,
                                                            batch)
    err = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(leaves(got), leaves(want)))
    return launches, err, m["loss"].item(), m1["loss"].item()


@pytest.mark.gpu
def test_sharded_kfac_train_step_on_two_ranks(cuda):
    """A kfac_ca ``jit_train_step`` on two gloo ranks sharing the card
    (the smoke qwen3-1.7b, fp32, TF32 off, its parameters and adam
    moments stored in halves over "data"): B1 launched in both ranks,
    and the updated parameters and the loss within 1e-5 of one rank's
    step (every rank computes the same K-FAC update on the gathered
    gradients)."""
    from repro_torch.core import world
    for launches, err, loss, one in world.spawn_ranks(2, "cuda:0",
                                                      _mesh_kfac):
        assert launches > 0
        assert err <= 1e-5
        assert abs(loss - one) <= 1e-5 * abs(one)
