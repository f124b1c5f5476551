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
    (1, 256, 40, 128)])
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
    order-d bank's of the same width (4) bit for bit.  (At width 1 the
    cuBLAS GEMMs of the two orders differ in the last bits: ROADMAP C.)"""
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
