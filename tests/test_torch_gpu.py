"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked ``gpu``: each test builds the kernels with nvcc and runs them on
the card, so it skips where there is none.  Imports no JAX, so it runs
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: trmm 2e-5 (fp32, fp64) and 2e-2 (bf16) relative, with an
absolute term scaled by sqrt(n) for the reordered sums; the inverse
1e-4 (fp32, fp64) and 2e-2 (bf16) of its largest entry, and its
strictly lower part the same share of that part's largest entry; the
substitution 1e-4 (fp32) and 1e-10 (fp64) of max|X|: its dots are
sequential FMA chains, the plain version's cuBLAS sums in another
order, and the recurrence carries each difference into later rows.
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
@pytest.mark.parametrize("b,n,k", [(1, 256, 16), (2, 200, 7), (1, 96, 40)])
def test_trmm_kernel_matches_plain(cuda, dtype, b, n, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    L = torch.randn((b, n, n), generator=g, device=cuda).to(dtype)
    X = torch.randn((b, n, k), generator=g, device=cuda).to(dtype)
    got = trmm.trmm(L, X)
    want = trmm.trmm_plain(L, X)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.double(), want.double(), rtol=tol,
                               atol=tol * n ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("m,n0", [(3, 16), (2, 256), (1, 512)])
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
    with pytest.raises(ValueError, match="power-of-two"):
        ops.block_inv_kernel(torch.ones((2, 3, 3), device=cuda))
