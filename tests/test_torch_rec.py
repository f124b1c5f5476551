"""The recursive baseline, kernel B3 and the one-shot ``trsm`` of the
port against the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages.
The JAX substitution kernel runs in interpret mode, as its own tests
run it.  Tolerances (``torch_parity``, relative with an absolute term
scaled to max|X|; X is about B / n for these factors): fp32 and the
refined presets 2e-5 (the two recurrences sum their dots in different
orders), bf16 2e-2 (tests/test_kernels.py), the inverse 1e-4.
fp64_refine is held against scipy in float64 at the reference's 1e-11
residual bound (tests/test_api_solver.py), so no test flips
jax_enable_x64.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from repro import api as japi
from repro import core as jcore
from repro.core import blocked as jblocked
from repro.core import mm3d as jmm3d
from repro.core import rec_trsm as jrec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.trsm_block import trsm_substitution as jtrsm_substitution
from repro_torch import api
from repro_torch.core import blocked, mm3d, rec_trsm, session
from repro_torch.kernels import ops, ref, tri_inv_block, trmm, trsm_block
from torch_parity import assert_close, assert_inverse_close

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = japi.make_trsm_mesh(1, 1)
TOL = {"fp32": 2e-5, "bf16": 2e-2, "bf16_refine": 2e-5}


def _tril(rng, n, batch=None, lower=True):
    shape = (n, n) if batch is None else (batch, n, n)
    L = np.tril(rng.standard_normal(shape)) \
        + n * np.broadcast_to(np.eye(n), shape)
    return (L if lower else np.swapaxes(L, -1, -2)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ------------------------------ kernel B3 ------------------------------

@pytest.mark.parametrize("m,n0,k,bn", [(1, 32, 64, 64), (4, 16, 32, 32),
                                       (2, 64, 128, 64), (1, 128, 128, 128)])
def test_trsm_substitution_matches_reference_kernel(m, n0, k, bn):
    """The shapes of tests/test_kernels.py, against the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(n0 * k)
    Ls = _tril(rng, n0, batch=m)
    Bs = rng.standard_normal((m, n0, k)).astype(np.float32)
    want = jtrsm_substitution(jnp.asarray(Ls), jnp.asarray(Bs), bn=bn,
                              interpret=True)
    got = ops.trsm_substitution(_t(Ls), _t(Bs))
    assert got.dtype == torch.float32 and got.shape == (m, n0, k)
    assert_close(got, want, 2e-5)


def test_trsm_substitution_unbatched_and_accum_dtype():
    """tests/test_kernels.py's unbatched case and the accum-dtype case
    of tests/test_precision.py."""
    rng = np.random.default_rng(3)
    L, B = _tril(rng, 32), rng.standard_normal((32, 32)).astype(np.float32)
    want = jtrsm_substitution(jnp.asarray(L), jnp.asarray(B), bn=32,
                              interpret=True)
    assert_close(ops.trsm_substitution(_t(L), _t(B)), want, 2e-5)
    rng = np.random.default_rng(6)
    L, B = _tril(rng, 32), rng.standard_normal((32, 32)).astype(np.float32)
    want = jops.trsm_substitution(jnp.asarray(L), jnp.asarray(B),
                                  accum_dtype=jnp.float32)
    got = ops.trsm_substitution(_t(L), _t(B), accum_dtype=torch.float32)
    assert_close(got, want, 2e-5)


def test_trsm_substitution_widens_a_bf16_factor():
    """The rec base case hands the kernel a bf16 factor and an fp32 RHS;
    the reference casts the factor to fp32 first: the same values."""
    rng = np.random.default_rng(8)
    L = _t(_tril(rng, 48)).to(torch.bfloat16)
    B = rng.standard_normal((48, 5)).astype(np.float32)
    want = jtrsm_substitution(jnp.asarray(L.float().numpy()),
                              jnp.asarray(B), bn=5, interpret=True)
    got = ops.trsm_substitution(L, _t(B), accum_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert_close(got, want, 2e-5)


def test_trsm_substitution_never_reads_the_upper_triangle():
    rng = np.random.default_rng(9)
    L = _tril(rng, 40, batch=2)
    B = rng.standard_normal((2, 40, 3)).astype(np.float32)
    poisoned = L + np.triu(np.full_like(L, np.nan), 1)
    got = ops.trsm_substitution(_t(poisoned), _t(B))
    assert torch.isfinite(got).all()
    assert_close(got, ops.trsm_substitution(_t(L), _t(B)), 0.0)


def test_trsm_substitution_scope_and_no_fallback():
    L = torch.eye(8)
    # the gated variant (B6) is ported: on the CPU it is the plain
    # version, one flag per system
    X = ops.trsm_substitution(L, torch.ones(8, 2), valid=torch.ones(1))
    assert torch.equal(X, torch.ones(8, 2))
    with pytest.raises(ValueError, match="one flag per system"):
        ops.trsm_substitution(L, torch.ones(8, 2), valid=torch.ones(2))
    # neither CPU nor CUDA: the wrapper raises, it does not run the
    # plain version, gated or not
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.trsm_substitution(L.to("meta"), torch.ones(8, 2,
                                                       device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.trsm_substitution(L.to("meta"), torch.ones(8, 2, device="meta"),
                              valid=torch.ones(1, device="meta"))
    with pytest.raises(TypeError):
        trsm_block._check(L.to("meta", torch.float64),
                          torch.ones(8, 2, device="meta"), torch.float32)


# ------------------------------- oracles -------------------------------

def test_ref_oracles_match_reference():
    rng = np.random.default_rng(11)
    Ls = _tril(rng, 16, batch=3)
    X = rng.standard_normal((16, 5)).astype(np.float32)
    assert_close(ref.trmm_ref(_t(Ls[0]), _t(X)),
                 jref.trmm_ref(jnp.asarray(Ls[0]), jnp.asarray(X)), 2e-5)
    assert_inverse_close(ref.tri_inv_blocks_ref(_t(Ls)),
                         jref.tri_inv_blocks_ref(jnp.asarray(Ls)), 1e-4)
    assert_close(ref.trsm_ref(_t(Ls[1]), _t(X)),
                 jref.trsm_ref(jnp.asarray(Ls[1]), jnp.asarray(X)), 2e-5)


# --------------------------- blocked and mm3d ---------------------------

@pytest.mark.parametrize("n0", [64, 16, 8])
def test_rec_trsm_local_matches_reference(n0):
    rng = np.random.default_rng(n0)
    L, B = _tril(rng, 64), rng.standard_normal((64, 6)).astype(np.float32)
    want = jblocked.rec_trsm_local(jnp.asarray(L), jnp.asarray(B), n0)
    assert_close(blocked.rec_trsm_local(_t(L), _t(B), n0), want, 2e-5)


def test_forward_substitution_matches_reference():
    rng = np.random.default_rng(12)
    L, B = _tril(rng, 24), rng.standard_normal((24, 4)).astype(np.float32)
    want = jblocked.forward_substitution(jnp.asarray(L), jnp.asarray(B))
    assert_close(blocked.forward_substitution(_t(L), _t(B)), want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm3d_shard_at_p1_matches_reference(dtype):
    rng = np.random.default_rng(13)
    a = rng.standard_normal((12, 8)).astype(np.float32)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    want = jmm3d.mm3d_shard(jnp.asarray(a, dtype), jnp.asarray(x, dtype),
                            m=12, n=8, k=5, p1=1, p2=1,
                            accum_dtype=jnp.float32)
    got = mm3d.mm3d_shard(_t(a).to(getattr(torch, dtype)),
                          _t(x).to(getattr(torch, dtype)), m=12, n=8, k=5,
                          p1=1, p2=1, accum_dtype=torch.float32)
    assert str(got.dtype) == f"torch.{dtype}"
    assert_close(got, np.asarray(want, np.float32),
                 2e-2 if dtype == "bfloat16" else 2e-5)
    # at p > 1 the operands are one rank's pieces: whole matrices are not
    with pytest.raises(ValueError, match="pieces"):
        mm3d.mm3d_shard(_t(a), _t(x), m=12, n=8, k=5, p1=2, p2=1)


# ----------------------------- rec_trsm -----------------------------

@pytest.mark.parametrize("n0", [None, 16, 8])
def test_rec_solve_matches_reference(n0):
    """rec_trsm.solve at n0 = n (the p = 1 default), 16 and 8."""
    n = 64
    rng = np.random.default_rng(14)
    L, B = _tril(rng, n), rng.standard_normal((n, 8)).astype(np.float32)
    want = jrec.solve(jnp.asarray(L), jnp.asarray(B), JGRID, n0=n0)
    got = rec_trsm.solve(_t(L), _t(B), CPU, n0=n0)
    assert_close(got, want, 2e-5)


def test_rec_default_n0_matches_reference():
    for n, k, p1, p2 in ((64, 8, 1, 1), (8192, 16, 1, 1), (4096, 64, 2, 1),
                         (1024, 512, 2, 4), (96, 4, 1, 2)):
        assert rec_trsm.default_n0(n, k, p1, p2) \
            == jrec.default_n0(n, k, p1, p2)


def test_rec_base_cases_run_in_sequence_over_a_factor_stack(monkeypatch):
    """n / n0 base cases, each one batched call over the factor axis."""
    calls = []
    real = ops.trsm_substitution

    def spy(L, B, **kw):
        calls.append(tuple(L.shape))
        return real(L, B, **kw)

    rng = np.random.default_rng(15)
    Ls, Bs = _tril(rng, 32, batch=3), rng.standard_normal((3, 32, 4))
    prog = rec_trsm.rec_trsm_sharded(CPU, 32, 4, 8)
    monkeypatch.setattr(ops, "trsm_substitution", spy)
    X = prog(_t(Ls), _t(Bs.astype(np.float32)))
    assert calls == [(3, 8, 8)] * 4
    for i in range(3):
        np.testing.assert_allclose(Ls[i] @ X[i].numpy(), Bs[i], atol=1e-4)


# --------------------------- the slice end to end ---------------------------

@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16_refine"])
@pytest.mark.parametrize("lower,transpose", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_rec_slice_matches_reference(precision, lower, transpose):
    """Solver.from_factor(method="rec") + solve in both packages, every
    (lower, transpose) variant, at the default n0 (= n at p = 1) and at
    n0 = 16."""
    n, k = 64, 8
    rng = np.random.default_rng(16)
    L = _tril(rng, n, lower=lower)
    B = rng.standard_normal((n, k)).astype(np.float32)
    for n0 in (None, 16):
        kw = dict(method="rec", n0=n0, lower=lower, transpose=transpose,
                  precision=precision)
        jsolver = japi.Solver.from_factor(L, JGRID, **kw)
        solver = api.Solver.from_factor(L, CPU, **kw)
        assert solver.n0 == jsolver.n0 == n0
        assert solver.spec_for(k).n0 == jsolver.spec_for(k).n0 == (n0 or n)
        want = _np(jsolver.solve(B, donate=False))
        got = solver.warmup(k).solve(B)
        assert got.shape == (n, k)
        assert_close(got, want, TOL[precision])


@pytest.mark.parametrize("lower,transpose", [(True, False), (False, True)])
def test_rec_fp64_refine_against_scipy(lower, transpose):
    n, k = 64, 4
    rng = np.random.default_rng(17)
    L = _tril(rng, n, lower=lower).astype(np.float64)
    B = rng.standard_normal((n, k))
    solver = api.Solver.from_factor(L, CPU, method="rec", n0=16,
                                    lower=lower, transpose=transpose,
                                    precision="fp64_refine")
    X = solver.solve(B)
    assert X.dtype == torch.float64
    want = scipy.linalg.solve_triangular(L, B, lower=lower,
                                         trans=1 if transpose else 0)
    A = L.T if transpose else L
    relres = np.linalg.norm(A @ X.numpy() - B) / np.linalg.norm(B)
    assert relres < 1e-11, relres
    np.testing.assert_allclose(X.numpy(), want, rtol=1e-9, atol=1e-12)


def test_rec_bank_and_server_match_reference():
    """A width-3 rec bank (resident (L_lo, L_hi), no Dt) and the
    continuous-batching server over a rec solver."""
    n, M = 32, 3
    rng = np.random.default_rng(18)
    Ls = _tril(rng, n, batch=M)
    Bs = rng.standard_normal((M, n, 4)).astype(np.float32)
    solver = api.Solver.from_factors(Ls, CPU, method="rec", n0=8,
                                     precision="bf16_refine")
    assert len(solver.bank.stacks()) == 2          # (L_lo, L_hi)
    X = solver.solve(Bs)
    for i in range(M):
        want = japi.Solver.from_factor(Ls[i], JGRID, method="rec", n0=8,
                                       precision="bf16_refine").solve(
                                           Bs[i], donate=False)
        assert_close(X[i], _np(want), TOL["bf16_refine"])
    reqs = [rng.standard_normal((n, w)).astype(np.float32)
            for w in (3, 5, 1, 8)]
    jserver = japi.SolveServer(japi.Solver.from_factor(
        Ls[0], JGRID, method="rec", precision="fp32"), 8).warmup()
    server = api.SolveServer(api.Solver.from_factor(
        Ls[0], CPU, method="rec", precision="fp32"), 8).warmup()
    for b in reqs:
        jserver.submit(b)
        server.submit(b)
    for got, want in zip(server.drain()[0], jserver.drain()[0]):
        assert_close(got, _np(want), TOL["fp32"])


def test_rec_steady_state_builds_one_program_per_width():
    n = 32
    rng = np.random.default_rng(19)
    solver = api.Solver.from_factor(_tril(rng, n), CPU, method="rec",
                                    precision="bf16_refine")
    spec = solver.spec_for(4)
    assert spec.method == "rec" and spec.n0 == n
    solver.warmup(4)
    builds = session.BUILD_COUNTS[spec]
    for _ in range(3):
        solver.solve(rng.standard_normal((n, 4)).astype(np.float32))
    assert session.BUILD_COUNTS[spec] == builds == 1


# ------------------------------- one-shot -------------------------------

@pytest.mark.parametrize("method", ["inv", "rec"])
@pytest.mark.parametrize("precision", [None, "bf16_refine"])
def test_one_shot_trsm_matches_reference(method, precision):
    n, k = 64, 8
    rng = np.random.default_rng(20)
    L, B = _tril(rng, n), rng.standard_normal((n, k)).astype(np.float32)
    for kw in (dict(n0=16), dict(n0=None, lower=False, transpose=True)):
        want = jcore.trsm(jnp.asarray(L), jnp.asarray(B), JGRID,
                          method=method, precision=precision, **kw)
        got = api.trsm(_t(L), _t(B), CPU, method=method,
                       precision=precision, **kw)
        assert got.shape == (n, k)
        assert_close(got, _np(want), 2e-5)


def test_one_shot_programs_are_unbanked_and_cached():
    n, k = 32, 4
    rng = np.random.default_rng(21)
    L, B = _t(_tril(rng, n)), _t(rng.standard_normal((n, k)))
    B = B.float()
    for method in ("inv", "rec"):
        api.trsm(L, B, CPU, method=method, n0=8)
        method_, n0 = api.resolve_plan(CPU, n, k, method=method, n0=8)
        spec = api.SolveSpec(n=n, k=k, grid=CPU,
                             policy=api.PRESETS["fp32"], method=method_,
                             n0=n0)
        assert spec.bank_width is None
        builds = session.BUILD_COUNTS[spec]
        api.trsm(L, B, CPU, method=method, n0=8)
        assert session.BUILD_COUNTS[spec] == builds == 1
    X = api.trsm(L, B, CPU, method="auto")
    np.testing.assert_allclose(L.numpy() @ X.numpy(), B.numpy(), atol=1e-4)


def test_launch_counters_stay_zero_on_the_cpu_for_rec():
    n = 32
    rng = np.random.default_rng(22)
    counts = (trsm_block.trsm_substitution.launches, trmm.trmm.launches,
              tri_inv_block.tri_inv_blocks.launches)
    L = _tril(rng, n)
    api.Solver.from_factor(L, CPU, method="rec").solve(
        rng.standard_normal((n, 2)).astype(np.float32))
    api.trsm(_t(L), _t(rng.standard_normal((n, 2)).astype(np.float32)), CPU,
             method="inv", n0=8)
    assert (trsm_block.trsm_substitution.launches, trmm.trmm.launches,
            tri_inv_block.tri_inv_blocks.launches) == counts


def test_serve_cli_rec_and_auto_on_the_cpu(capsys):
    from repro_torch.launch import serve
    for method in ("rec", "auto"):
        serve.main(["--workload", "trsm", "--n", "64", "--requests", "4",
                    "--method", method, "--precision", "bf16_refine",
                    "--device", "cpu"])
        out = capsys.readouterr().out
        assert "served 4 solve requests" in out
    # "auto" serves what the H100 model resolves for a resident factor
    method, n0 = api.resolve_plan(api.plan_grid(1, 1), 64, 16,
                                  method="auto", hoisted=True)
    assert f"n0={n0} method={method}" in out


def test_rec_and_planner_import_neither_jax_nor_repro():
    code = (
        "import sys, torch\n"
        "from repro_torch import api\n"
        "from repro_torch.core import tuning\n"
        "g = api.make_trsm_mesh(1, 1, device='cpu')\n"
        "n = 32\n"
        "L = torch.randn(n, n).tril() + n * torch.eye(n)\n"
        "B = torch.randn(n, 2)\n"
        "api.Solver.from_factor(L, g, method='rec').solve(B)\n"
        "api.Solver.from_factor(L, g, method='auto').solve(B)\n"
        "api.trsm(L, B, g, method='auto')\n"
        "api.SolveSpec.auto(8192, 16, p=64)\n"
        "tuning.tuning_table(4096, 16, 8)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": "src"},
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr

