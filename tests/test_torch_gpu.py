"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked ``gpu``: each test builds the kernels with nvcc and runs them on
the card, so it skips where there is none.  Imports no JAX, so it runs
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: trmm 2e-5 (fp32, fp64) and 2e-2 (bf16) relative, with an
absolute term scaled by sqrt(n) for the reordered sums; the inverse
1e-4 (fp32, fp64) and 2e-2 (bf16) of its largest entry, and its
strictly lower part the same share of that part's largest entry.
"""

import pytest
import torch

from repro_torch.kernels import tri_inv_block, trmm


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
