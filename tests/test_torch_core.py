"""The port's core modules against the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages;
tolerances are the reference's own (fp32 2e-5, bf16 2e-2, the inverse
1e-4), relative and with an absolute term scaled to the values
compared (``torch_parity``; an inverse's strictly lower part also
against its own largest entry).  The grid gathers and the host-side
arithmetic (tuning, layout indices) must agree exactly.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro.core import grid as jgrid
from repro.core import precision as jprecision
from repro.core import refine as jrefine
from repro.core import tuning as jtuning
from repro.kernels import ops as jops
from repro_torch.core import blocked, errors, grid, inv_trsm, precision
from repro_torch.core import refine, session, tuning
from repro_torch.kernels import ops
from torch_parity import assert_close, assert_inverse_close

CPU = grid.make_trsm_mesh(1, 1, device="cpu")


def _tril(rng, n, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    return (np.tril(rng.standard_normal(shape))
            + n * np.broadcast_to(np.eye(n), shape)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------- grid -------------------------------

@pytest.mark.parametrize("n,p", [(12, 1), (12, 2), (16, 4), (9, 3)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_cyclic_row_index_matches_reference(n, p, inverse, reverse):
    np.testing.assert_array_equal(
        grid.cyclic_row_index(n, p, inverse=inverse, reverse=reverse),
        jgrid.cyclic_row_index(n, p, inverse=inverse, reverse=reverse))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_device_gathers_match_reference(p, reverse):
    rng = np.random.default_rng(p)
    a = rng.standard_normal((3, 8, 5)).astype(np.float32)
    for inverse in (False, True):
        want = jgrid.cyclic_rows_device(jnp.asarray(a), p, inverse=inverse,
                                        reverse=reverse)
        got = grid.cyclic_rows_device(_t(a), p, inverse=inverse,
                                      reverse=reverse)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    A = rng.standard_normal((2, 8, 8)).astype(np.float32)
    for transpose in (False, True):
        kw = dict(reverse_rows=reverse, reverse_cols=reverse,
                  transpose=transpose)
        want = jgrid.cyclic_matrix_device(jnp.asarray(A), p, p, **kw)
        got = grid.cyclic_matrix_device(_t(A), p, p, **kw)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_identity_gather_is_free_and_indices_are_cached():
    a = torch.ones(6, 2)
    assert grid.cyclic_rows_device(a, 1) is a
    i1 = grid._gather_index(6, 1, False, True, torch.device("cpu"))
    i2 = grid._gather_index(6, 1, False, True, torch.device("cpu"))
    assert i1 is i2


def test_grid_scope_and_divisibility():
    assert (CPU.p1, CPU.p2, CPU.p, CPU.device.type) == (1, 1, 1, "cpu")
    # p > 1 runs one rank per process: outside a process group of that
    # size the grid refuses, saying so (tests/test_torch_distributed.py)
    with pytest.raises(RuntimeError, match="init_process_group"):
        grid.make_trsm_mesh(2, 1, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError, match="tile"):
        grid.check_divisibility(10, 4, 4, CPU)
    grid.check_divisibility(16, 3, 4, CPU)


# ----------------------------- precision -----------------------------

def test_presets_match_reference_roles():
    for name, ref in jprecision.PRESETS.items():
        pol = precision.PRESETS[name]
        assert [precision.dtype_name(d) for d in (
            pol.storage, pol.compute, pol.accumulate, pol.residual)] == \
            [ref.storage, ref.compute, ref.accumulate, ref.residual]
        assert pol.refine_steps == ref.refine_steps
        assert precision.dtype_name(pol.io_dtype) == ref.io_dtype.name


def test_policy_resolution_and_hashing():
    p = precision.resolve("bf16_refine")
    assert precision.resolve(p) is p
    assert precision.resolve(None, np.float32) == precision.PRESETS["fp32"]
    assert hash(precision.resolve(None, torch.float32)) == \
        hash(precision.PRESETS["fp32"])
    legacy = precision.resolve(None, np.float64)
    assert legacy.storage == legacy.residual == torch.float64
    with pytest.raises(ValueError, match="unknown precision preset"):
        precision.resolve("fp8_dream")
    with pytest.raises(ValueError, match="precision= or dtype="):
        precision.resolve(None, None)
    with pytest.raises(ValueError, match="refine_steps"):
        precision.PrecisionPolicy(name="bad", storage="float32",
                                  compute="float32", accumulate="float32",
                                  residual="float32", refine_steps=-1)


# ------------------------------ blocked ------------------------------

@pytest.mark.parametrize("n", [1, 12, 16])
def test_tri_inv_doubling_matches_reference(n):
    L = _tril(np.random.default_rng(n), n)
    want = np.asarray(jax.jit(jblocked.tri_inv_doubling)(jnp.asarray(L)))
    got = blocked.tri_inv_doubling(_t(L))
    assert_inverse_close(got, want, 1e-4)


def test_block_diag_invert_and_batched_match_reference():
    rng = np.random.default_rng(3)
    L = _tril(rng, 32)
    assert_inverse_close(
        blocked.block_diag_invert(_t(L), 8),
        jax.jit(jblocked.block_diag_invert, static_argnums=1)(
            jnp.asarray(L), 8), 1e-4)
    Ls = _tril(rng, 8, batch=5)
    assert_inverse_close(
        blocked.tri_inv_batched(_t(Ls)),
        jax.jit(jblocked.tri_inv_batched)(jnp.asarray(Ls)), 1e-4)


@pytest.mark.parametrize("n0", [4, 8, 32])
def test_it_inv_trsm_local_matches_reference(n0):
    rng = np.random.default_rng(n0)
    L = _tril(rng, 32)
    B = rng.standard_normal((32, 5)).astype(np.float32)
    want = np.asarray(jblocked.it_inv_trsm_local(
        jnp.asarray(L), jnp.asarray(B), n0, block_inv=jops.block_inv_kernel))
    got = blocked.it_inv_trsm_local(_t(L), _t(B), n0,
                                    block_inv=ops.block_inv_kernel)
    assert_close(got, want, 2e-5)


@pytest.mark.parametrize("which", ["lower", "upper", "lower_t", "spd"])
def test_reduction_identities_match_reference(which):
    rng = np.random.default_rng(11)
    L = _tril(rng, 16)
    B = rng.standard_normal((16, 3)).astype(np.float32)
    A = L.T.copy() if which == "upper" else L
    jfn = getattr(jblocked, f"solve_{which}" if which != "spd"
                  else "spd_solve")
    fn = getattr(blocked, f"solve_{which}" if which != "spd"
                 else "spd_solve")
    want = np.asarray(jax.jit(lambda a, b: jfn(
        a, b, jblocked.it_inv_trsm_local, n0=4))(jnp.asarray(A),
                                                 jnp.asarray(B)))
    got = fn(_t(A), _t(B), blocked.it_inv_trsm_local, n0=4)
    assert_close(got, want, 2e-5)


# ------------------------------ inv_trsm ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase1_and_sweep_match_local_schedule(dtype):
    """The bank path's phase 1 (upcast to fp32 for bf16) + sweep equal
    the reference's local It-Inv schedule on the same input."""
    rng = np.random.default_rng(5)
    n, n0 = 64, 16
    L = _tril(rng, n, batch=2)
    B = rng.standard_normal((2, n, 4)).astype(np.float32)
    Lt = _t(L).to(dtype)
    Dt = inv_trsm.invert_diag_blocks(Lt, n0=n0, block_inv=ops.block_inv_kernel,
                                     accum_dtype=torch.float32)
    assert Dt.shape == (2,) + inv_trsm.dt_shape(n, n0) and Dt.dtype == dtype
    X = inv_trsm.sweep(Lt, Dt, _t(B).to(dtype), n0=n0,
                       accum_dtype=torch.float32)
    Lr = jnp.asarray(Lt.float().numpy(), jnp.float32)
    want = np.stack([np.asarray(jblocked.it_inv_trsm_local(
        Lr[i], jnp.asarray(B[i]), n0, block_inv=jops.block_inv_kernel))
        for i in range(2)])
    assert_close(X, want, 2e-2 if dtype == torch.bfloat16 else 2e-5)
    assert inv_trsm.pick_phase1_mode(n, n0, CPU) == "alltoall"


# ------------------------------- refine -------------------------------

@pytest.mark.parametrize("lower,transpose", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_apply_cyclic_operator_matches_reference(lower, transpose):
    rng = np.random.default_rng(4)
    n, k = 16, 5
    L = np.tril(rng.standard_normal((n, n))) + np.eye(n)
    A = (L if lower else L.T).astype(np.float32)
    X = rng.standard_normal((n, k)).astype(np.float32)
    rev = lower == transpose
    kw = dict(reverse_rows=rev, reverse_cols=rev, transpose=transpose)
    want = jrefine.apply_cyclic_operator(
        jgrid.cyclic_matrix_device(jnp.asarray(A), 1, 1, **kw),
        jnp.asarray(X), p1=1, p2=1, reverse=rev)
    got = refine.apply_cyclic_operator(
        grid.cyclic_matrix_device(_t(A), 1, 1, **kw), _t(X), p1=1, p2=1,
        reverse=rev)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    op = A.T if transpose else A
    np.testing.assert_allclose(got.numpy(), op @ X, rtol=1e-4, atol=1e-4)


def test_refined_solve_matches_reference():
    """Same base solve (a bf16 substitution), same policy: the two
    refinement loops agree, and refinement recovers fp32 accuracy."""
    rng = np.random.default_rng(8)
    n, k = 32, 4
    L = _tril(rng, n)
    B = rng.standard_normal((n, k)).astype(np.float32)
    pol, jpol = precision.PRESETS["bf16_refine"], \
        jprecision.PRESETS["bf16_refine"]

    def jbase(Lc, b):
        x = jax.scipy.linalg.solve_triangular(
            Lc.astype(jnp.float32), b.astype(jnp.float32), lower=True)
        return x.astype(jnp.bfloat16)

    def base(Lc, b):
        x = torch.linalg.solve_triangular(Lc.float(), b.float(), upper=False)
        return x.to(torch.bfloat16)

    want = np.asarray(jrefine.refined_solve(
        jbase, jnp.asarray(L, jnp.bfloat16), jnp.asarray(L), jnp.asarray(B),
        policy=jpol, p1=1, p2=1, reverse=False))
    got = refine.refined_solve(base, _t(L).to(torch.bfloat16), _t(L), _t(B),
                               policy=pol, p1=1, p2=1, reverse=False)
    assert got.dtype == torch.float32
    assert_close(got, want, 2e-5)
    relres = np.linalg.norm(L.astype(np.float64) @ got.double().numpy() - B) \
        / np.linalg.norm(B)
    assert relres < 1e-5, relres


# ------------------------------- tuning -------------------------------

@pytest.mark.parametrize("n", [1, 6, 64, 96, 8192])
def test_tuning_matches_reference(n):
    assert tuning._pow2_divisors(n) == jtuning._pow2_divisors(n)
    assert tuning._feasible_n0(n, 1, 1) == jtuning._feasible_n0(n, 1, 1)
    jgrid11 = jgrid.make_trsm_mesh(1, 1)
    assert tuning.serving_n0(n, CPU) == jtuning.serving_n0(n, jgrid11)
    if n == 8192:
        assert tuning.serving_n0(n, CPU) == 4096


# --------------------------- errors and cache ---------------------------

def test_error_hierarchy():
    assert issubclass(errors.Overloaded, errors.ServingError)
    assert issubclass(errors.Overloaded, RuntimeError)
    assert issubclass(errors.DeadlineUnmeetable, errors.Overloaded)
    assert issubclass(errors.StrandedRequestError, errors.ServingError)
    assert issubclass(errors.StrandedRequestError, ValueError)


def _spec(n0):
    from repro_torch.core.solver import SolveSpec
    return SolveSpec(n=32, k=4, grid=CPU, policy=precision.PRESETS["fp32"],
                     n0=n0, bank_width=1)


def test_cache_lru_stats_and_key_type():
    cache = session.CompiledSolverCache(maxsize=2)
    for n0 in (4, 8, 16):
        cache.get(_spec(n0), lambda: object())
    cache.get(_spec(16), lambda: object())
    assert cache.stats() == dict(size=2, hits=1, misses=3, evictions=1,
                                 hit_rate=0.25)
    assert _spec(8) in cache and _spec(4) not in cache
    with pytest.raises(TypeError, match="SolveSpec"):
        cache.get(("n", 32), lambda: None)


def test_cache_builds_are_single_flight():
    cache = session.CompiledSolverCache()
    gate, builds, out = threading.Event(), [], []

    def build():
        builds.append(1)
        gate.wait(5)
        return "program"

    threads = [threading.Thread(target=lambda: out.append(
        cache.get(_spec(8), build))) for _ in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert out == ["program"] * 8 and len(builds) == 1
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 7
