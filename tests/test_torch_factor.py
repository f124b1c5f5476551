"""The factor producers of the port (``core.tri_inv``, ``core.cholesky``,
``core.lu``) against the JAX package's, on the CPU.

The same numpy inputs, made from fixed seeds, go through ``repro`` on
its 1 x 1 x 1 mesh and through ``repro_torch`` on the CPU grid, where
the port's kernel hook runs the plain B1.  Tolerances: inverses 1e-4 of
their scale and their strictly lower part 1e-4 of its own
(``torch_parity``, as tests/test_torch_core.py holds inverses);
factors 2e-5 (tests/test_kernels.py's fp32 tolerance, as the port's
other parity tests hold them); every served column within the
reference's residual bound (1e-4, tests/test_factor_bank.py).  The fp64
checks hold the port alone to the reference's selfcheck bounds
(``repro.core.selfcheck``: 1e-9 for the inverse, 1e-8 for the
factorizations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bank as jbank
from repro.core import blocked as jblocked
from repro.core import cholesky as jcholesky
from repro.core import grid as jgrid
from repro.core import lu as jlu
from repro.core import tri_inv as jtri_inv
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.core import blocked, cholesky, lu, tri_inv
from torch_parity import assert_close, assert_inverse_close

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = jgrid.make_trsm_mesh(1, 1)
TOL = 2e-5
INV_TOL = 1e-4
RELRES = 1e-4


def _tril(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
            ).astype(dtype)


def _spd(n, seed, dtype=np.float32):
    """G G^T / 2n + 1e-2 I with G (n, 2n): a damped Gram matrix."""
    G = np.random.default_rng(seed).standard_normal((n, 2 * n))
    return (G @ G.T / (2 * n) + 1e-2 * np.eye(n)).astype(dtype)


def _dominant(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype)


# ------------------------------ tri_inv ------------------------------

@pytest.mark.parametrize("n,s0", [(16, None), (16, 8), (64, None), (64, 8),
                                  (96, None), (96, 12)])
def test_invert_matches_reference(n, s0):
    """s0 = None takes one block of order n (B1 once at p = 1); s0 = 8
    runs phase B's doubling levels; at n = 96 the blocks (96 and 12) are
    not powers of two and go into B1 with an identity tail."""
    L = _tril(n, seed=n)
    got = tri_inv.invert(L, CPU, s0=s0)
    want = np.asarray(jtri_inv.invert(L, JGRID, s0=s0))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert_inverse_close(got, want, INV_TOL)
    assert not torch.triu(got, 1).any()


def test_invert_rejects_blocks_the_doubling_cannot_pair():
    """n / s0 = 12 blocks cannot be paired level by level: the
    reference's shapes fail an assertion, the port raises."""
    L = _tril(96, seed=1)
    with pytest.raises(AssertionError):
        jtri_inv.invert(L, JGRID, s0=8)
    with pytest.raises(ValueError, match="power-of-two number of blocks"):
        tri_inv.invert(L, CPU, s0=8)


@pytest.mark.parametrize("n,p1,p2", [(64, 1, 1), (96, 1, 1), (64, 2, 1),
                                     (96, 2, 2), (48, 1, 4)])
def test_pick_s0_and_phase_a_mode_match_reference(n, p1, p2):
    """The base block size and phase A's routing, pure functions of the
    shapes, agree with the reference's for every grid."""
    s0 = tri_inv.pick_s0(n, p1, p2)
    assert s0 == jtri_inv.pick_s0(n, p1, p2)
    p = p1 * p1 * p2
    assert tri_inv.phase_a_mode(n, s0, p) == jtri_inv.phase_a_mode(n, s0, p)


def test_invert_blocks_pads_to_the_next_power_of_two(monkeypatch):
    """A stack of order-12 blocks reaches B1's wrapper as order-16
    blocks with an identity tail (the kernel hook pads, so B1 only ever
    sees powers of two); the leading blocks equal the plain doubling's
    inverses."""
    from repro_torch.kernels import ops
    Ls = torch.as_tensor(np.stack([_tril(12, seed=s) for s in range(3)])
                         ).reshape(3, 1, 12, 12)
    seen = []
    b1 = ops.tri_inv_blocks

    def spy(blocks, valid=None):
        seen.append(tuple(blocks.shape))
        return b1(blocks, valid)

    monkeypatch.setattr(ops, "tri_inv_blocks", spy)
    got = tri_inv.invert_blocks(Ls)
    assert seen == [(3, 16, 16)] and got.shape == Ls.shape
    assert_inverse_close(got, blocked.tri_inv_batched(Ls), INV_TOL)


@pytest.mark.parametrize("n,n0,s0", [(64, 16, None), (64, 32, 8)])
def test_block_diag_inv_matches_reference(n, n0, s0):
    """Only the n/n0 diagonal blocks are inverted; the panels between
    them are untouched."""
    L = _tril(n, seed=7)
    got = tri_inv.block_diag_inv_shard(torch.as_tensor(L), n=n, n0=n0,
                                       p1=1, p2=1, s0=s0)
    want = np.asarray(jax.jit(jblocked.block_diag_invert, static_argnums=1)(
        jnp.asarray(L), n0))
    assert_inverse_close(got, want, INV_TOL)


@pytest.mark.parametrize("n,s0", [(16, None), (64, None), (64, 8)])
def test_invert_fp64_within_selfcheck_bound(n, s0):
    L = _tril(n, seed=n, dtype=np.float64)
    Li = tri_inv.invert(L, CPU, s0=s0).numpy()
    assert np.abs(Li @ L - np.eye(n)).max() < 1e-9
    assert not np.triu(Li, 1).any()


def test_p_greater_than_one_is_roadmap_a12():
    plan = api.plan_grid(2, 1)
    # the inversion, the factorizations and the transpose run at p > 1
    # (tests/test_torch_distributed.py), on a grid with a mesh, never on
    # a plan-only one
    with pytest.raises(ValueError, match="plan-only"):
        tri_inv.tri_inv_fn(plan, 64)
    with pytest.raises(ValueError, match="plan-only"):
        cholesky.cholesky_fn(plan, 64)
    with pytest.raises(ValueError, match="plan-only"):
        lu.lu_fn(plan, 64)
    with pytest.raises(ValueError, match="plan-only"):
        cholesky.transpose_fn(plan, 64, 64)


# ------------------------------ cholesky ------------------------------

@pytest.mark.parametrize("n", [32, 64, 96])
def test_cholesky_matches_reference(n):
    """The default n0 (n/8) recurses three levels; at n = 96 the panel
    inversions are of orders 48, 24 and 12."""
    A = _spd(n, seed=n)
    want = np.asarray(jcholesky.cholesky(A, JGRID))
    got = cholesky.cholesky(A, CPU)
    assert_close(got, want, TOL)
    assert not torch.triu(got, 1).any()
    cyc = cholesky.cholesky_cyclic(A, CPU)
    assert_close(cyc, np.asarray(jcholesky.cholesky_cyclic(A, JGRID)), TOL)
    assert torch.equal(cyc, got)            # cyclic = natural at p = 1


def test_cholesky_n0_rule_matches_reference():
    for n, n0 in ((8192, None), (6144, None), (96, None), (96, 3), (64, 64)):
        fn = cholesky.cholesky_fn(CPU, n, n0)
        want = n0 or max(1, n // 8)
        while n % want:
            want *= 2
        assert fn.keywords["n0"] == min(want, n), (n, n0)


def test_cholesky_of_an_indefinite_matrix_is_nan():
    """``jnp.linalg.cholesky`` gives NaN; the port keeps that, with no
    host sync (``cholesky_ex``)."""
    A = -np.eye(16, dtype=np.float32)
    assert np.isnan(np.asarray(jcholesky.cholesky(A, JGRID))).any()
    assert torch.isnan(cholesky.cholesky(A, CPU)).any()


def test_chol_blocked_local_matches_reference_over_a_stack():
    """The K-FAC factorization: a (2, 32, 32) stack in one call against
    the reference vmapped over it."""
    A = np.stack([_spd(32, seed=s) for s in (1, 2)])
    want = np.asarray(jax.jit(jax.vmap(lambda a: jcholesky.chol_blocked_local(
        a, 8)))(jnp.asarray(A)))
    got = cholesky.chol_blocked_local(torch.as_tensor(A), 8)
    assert_close(got, want, TOL)


@pytest.mark.parametrize("mr,nc", [(16, 32), (8, 8)])
def test_transpose_fn_matches_reference(mr, nc):
    A = np.random.default_rng(mr).standard_normal((mr, nc)).astype(
        np.float32)
    want = np.asarray(jcholesky.transpose_fn(JGRID, mr, nc)(jnp.asarray(A)))
    got = cholesky.transpose_fn(CPU, mr, nc)(torch.as_tensor(A))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.is_contiguous()


@pytest.mark.parametrize("n,n0", [(32, 8), (64, 16)])
def test_cholesky_fp64_within_selfcheck_bound(n, n0):
    M = np.random.default_rng(n).standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    L = cholesky.cholesky(A, CPU, n0).numpy()
    assert np.abs(L @ L.T - A).max() < 1e-8
    assert not np.triu(L, 1).any()


# -------------------------------- lu --------------------------------

@pytest.mark.parametrize("n", [32, 64, 96])
def test_lu_matches_reference(n):
    A = _dominant(n, seed=n)
    jL, jU = (np.asarray(x) for x in jlu.lu(A, JGRID))
    L, U = lu.lu(A, CPU)
    assert_close(L, jL, TOL)
    assert_close(U, jU, TOL)
    assert not torch.triu(L, 1).any() and not torch.tril(U, -1).any()
    assert torch.equal(torch.diagonal(L), torch.ones(n))
    Lc, Uc = lu.lu_cyclic(A, CPU)
    jLc, jUc = (np.asarray(x) for x in jlu.lu_cyclic(A, JGRID))
    assert_close(Lc, jLc, TOL)
    assert_close(Uc, jUc, TOL)


@pytest.mark.parametrize("n,n0", [(32, 8), (64, 16)])
def test_lu_fp64_within_selfcheck_bound(n, n0):
    A = _dominant(n, seed=n, dtype=np.float64)
    L, U = (x.numpy() for x in lu.lu(A, CPU, n0))
    assert np.abs(L @ U - A).max() < 1e-8
    assert np.allclose(np.triu(L, 1), 0) and np.allclose(np.tril(U, -1), 0)
    assert np.allclose(np.diag(L), 1)


# ------------------- the producer -> bank -> solve loop -------------------

def test_producers_feed_admit_cyclic_and_serve():
    """tests/test_factor_bank.py's cyclic-ingestion loop on both sides:
    a Cholesky factor and an LU factor go into one bank as the producers
    emit them, and the served solves invert them."""
    n = 64
    Ls = [_tril(n, seed=s) for s in (0, 1)]
    A1 = (Ls[0].astype(np.float64) @ Ls[0].T).astype(np.float32)
    A2 = (Ls[1] + n * np.eye(n)).astype(np.float32)
    B = np.random.default_rng(2).standard_normal((2, n, 8)).astype(
        np.float32)

    jb = jbank.FactorBank(JGRID, n, dtype=np.float32,
                          block_inv=jops.block_inv_kernel)
    jb.admit_cyclic(jcholesky.cholesky_cyclic(A1, JGRID))
    jb.admit_cyclic(jlu.lu_cyclic(A2, JGRID)[0])
    want = np.asarray(japi.Solver.from_bank(jb).solve(jnp.asarray(B)))

    bank = api.FactorBank(CPU, n, dtype=torch.float32)
    assert bank.admit_cyclic(cholesky.cholesky_cyclic(A1, CPU)) == 0
    assert bank.admit_cyclic(lu.lu_cyclic(A2, CPU)[0]) == 1
    X = api.Solver.from_bank(bank).solve(torch.as_tensor(B))
    assert_close(X, want, TOL)
    factors = (cholesky.cholesky(A1, CPU), lu.lu(A2, CPU)[0])
    for L, x, b in zip(factors, X.double().numpy(), B):
        L = L.double().numpy()
        assert np.linalg.norm(L @ x - b) / np.linalg.norm(b) < RELRES
