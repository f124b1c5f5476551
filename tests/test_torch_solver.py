"""The slice end to end: ``repro_torch.api`` against ``repro.api``.

The same numpy factor and right-hand sides go through both front
doors on the CPU.  The JAX side passes ``block_inv=ops.block_inv_kernel``
(the Pallas doubling kernel in interpret mode): its default
``block_inv=None`` path fails on jax 0.9 (shard_map cannot infer the
phase-1 output's replication, ROADMAP C).  Tolerances: fp32 and the
refined presets 2e-5, bf16 2e-2 (tests/test_kernels.py), each relative
and with an absolute term scaled to max|X| (``torch_parity``): X is
about B / n for these factors.  The bf16 cases hold the sweep itself;
refinement repairs a faulty sweep to near fp32 accuracy.  fp64_refine
is held against scipy in float64 at the reference's 1e-11 residual
bound (tests/test_api_solver.py), so no test flips jax_enable_x64.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.linalg
import torch

from repro import api as japi
from repro.kernels import ops as jops
from repro_torch import api, convert
from repro_torch.core import session
from repro_torch.kernels import tri_inv_block, trmm
from torch_parity import assert_close

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = japi.make_trsm_mesh(1, 1)
TOL = {"fp32": 2e-5, "bf16": 2e-2, "bf16_refine": 2e-5}


def _factor(n, seed=0, lower=True):
    rng = np.random.default_rng(seed)
    L = (np.tril(rng.standard_normal((n, n))) + n * np.eye(n))
    return (L if lower else L.T).astype(np.float32), rng


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16_refine"])
@pytest.mark.parametrize("lower,transpose", [(True, False), (False, False),
                                             (True, True), (False, True)])
@pytest.mark.parametrize("n0", [16, None])
def test_slice_matches_reference(precision, lower, transpose, n0):
    """Solver.from_factor + solve, both packages; every (lower,
    transpose) variant, with n0 given and left to the serving default
    (n/2)."""
    n, k = 64, 8
    L, rng = _factor(n, seed=3, lower=lower)
    B = rng.standard_normal((n, k)).astype(np.float32)
    kw = dict(method="inv", n0=n0, lower=lower, transpose=transpose,
              precision=precision)
    jsolver = japi.Solver.from_factor(L, JGRID,
                                      block_inv=jops.block_inv_kernel, **kw)
    solver = api.Solver.from_factor(L, CPU, **kw)
    assert solver.n0 == jsolver.n0 == (n0 or n // 2)
    assert str(solver.dtype).removeprefix("torch.") == jsolver.dtype.name
    want = _np(jsolver.solve(B, donate=False))
    got = solver.warmup(k).solve(B)
    assert got.shape == (n, k)
    assert_close(got, want, TOL[precision])


def test_server_drain_matches_reference():
    n, pk = 64, 8
    L, rng = _factor(n, seed=5)
    reqs = [rng.standard_normal((n, w)).astype(np.float32)
            for w in (3, 5, 8, 1, 2)]
    jserver = japi.SolveServer(japi.Solver.from_factor(
        L, JGRID, n0=16, precision="fp32",
        block_inv=jops.block_inv_kernel), pk).warmup()
    server = api.SolveServer(api.Solver.from_factor(
        L, CPU, n0=16, precision="fp32"), pk).warmup()
    for r in reqs:
        jserver.submit(r)
        server.submit(r)
    want, got = jserver.drain()[0], server.drain()[0]
    assert server.panels_solved == jserver.panels_solved == 3
    assert [x.shape[1] for x in got] == [3, 5, 8, 1, 2]
    for g, w in zip(got, want):
        assert_close(g, _np(w), 2e-5)


def test_fp64_refine_matches_scipy():
    n, k = 64, 4
    L, rng = _factor(n, seed=9)
    L = L.astype(np.float64)
    B = rng.standard_normal((n, k))
    solver = api.Solver.from_factor(L, CPU, n0=16, precision="fp64_refine")
    X = solver.solve(B)
    assert X.dtype == torch.float64
    want = scipy.linalg.solve_triangular(L, B, lower=True)
    relres = np.linalg.norm(L @ X.numpy() - B) / np.linalg.norm(B)
    assert relres < 1e-11, relres
    np.testing.assert_allclose(X.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("precision", ["fp32", "bf16_refine"])
def test_sweep_on_the_reference_banks_own_dt(precision):
    """The port's bank built from the JAX bank's resident stacks (its Dt
    included) solves like the JAX solver."""
    n, k = 64, 8
    L, rng = _factor(n, seed=2)
    B = rng.standard_normal((n, k)).astype(np.float32)
    jsolver = japi.Solver.from_factor(L, JGRID, n0=16, precision=precision,
                                      block_inv=jops.block_inv_kernel)
    arrays = [np.asarray(a) for a in jsolver.bank.stacks()]
    bank = convert.bank_from_reference(
        arrays, dict(n=n, n0=16, precision=precision), "cpu")
    assert bank.stacks()[1].dtype == bank.policy.storage
    got = api.Solver.from_bank(bank).solve(B)
    want = _np(jsolver.solve(B, donate=False))
    assert_close(got, want, 2e-5)
    with pytest.raises(ValueError, match="roles"):
        convert.bank_from_reference(arrays[:1], dict(n=n, n0=16,
                                                     precision=precision),
                                    "cpu")


def test_steady_state_builds_nothing():
    n, k = 64, 8
    L, rng = _factor(n, seed=4)
    cache = api.CompiledSolverCache()
    solver = api.Solver.from_factor(L, CPU, n0=16, precision="bf16_refine",
                                    cache=cache).warmup(k)
    spec = solver.spec_for(k)
    Bp = solver.place_rhs(rng.standard_normal((n, k)))
    assert Bp.shape == (1, n, k) and Bp.dtype == torch.float32
    hits, builds = cache.stats()["hits"], session.BUILD_COUNTS[spec]
    X = solver.solve(Bp, donate=True)
    assert X.shape == (1, n, k)
    assert session.BUILD_COUNTS[spec] == builds
    assert cache.stats()["hits"] == hits + 1
    assert cache.stats()["misses"] == 1 and len(cache) == 1
    relres = np.linalg.norm(L.astype(np.float64) @ X[0].double().numpy()
                            - Bp[0].double().numpy()) \
        / np.linalg.norm(Bp[0].double().numpy())
    assert relres < 1e-5, relres


def test_width_m_solver_and_spec_front_door():
    n, k, M = 32, 4, 3
    rng = np.random.default_rng(6)
    Ls = np.stack([_factor(n, seed=s)[0] for s in range(M)])
    Bs = rng.standard_normal((M, n, k)).astype(np.float32)
    X = api.Solver.from_factors(Ls, CPU, n0=8, precision="fp32").solve(Bs)
    for i in range(M):
        np.testing.assert_allclose(Ls[i] @ X[i].numpy(), Bs[i], atol=1e-4)
    spec = api.SolveSpec(n=n, k=None, grid=CPU,
                         policy=api.PRESETS["fp32"], n0=8, overlap="off")
    assert spec.overlap is None and not spec.is_concrete
    server = api.SolveServer.from_spec(spec, Ls[0], panel_k=4)
    server.submit(Bs[0, :, 0])
    (x,) = server.drain()[0]
    np.testing.assert_allclose(Ls[0] @ x.numpy(), Bs[0, :, :1], atol=1e-4)


def test_scope_of_the_slice_is_explicit():
    L, _ = _factor(16)
    # capacity banks are ported (tests/test_torch_bank.py)
    assert api.FactorBank(CPU, 16, capacity=4).width == 4
    # "rec" banks are ported; "auto" depends on k, so a bank takes only
    # "inv" or "rec", as in the reference
    assert api.FactorBank(CPU, 16, method="rec").n0 is None
    with pytest.raises(ValueError, match="auto"):
        api.FactorBank(CPU, 16, method="auto")
    # an append-only bank has no slot lifecycle and no padding, as in
    # the reference; an empty one has no slot to replace
    bank = api.FactorBank(CPU, 16, n0=4)
    for call, match in ((lambda: bank.replace(0, L), "out of range"),
                        (lambda: bank.evict(0), "capacity-allocated"),
                        (lambda: bank.admit(L, pad_to=16),
                         "capacity-allocated")):
        with pytest.raises(ValueError, match=match):
            call()
    assert bank.admit_cyclic(L) == 0
    # p > 1 needs a process group of that size (one rank per process)
    with pytest.raises(RuntimeError, match="init_process_group"):
        api.make_trsm_mesh(1, 2, device="cpu")


def test_launch_counters_stay_zero_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions, never a
    launch."""
    n = 32
    L, rng = _factor(n, seed=7)
    counts = (trmm.trmm.launches, tri_inv_block.tri_inv_blocks.launches)
    api.Solver.from_factor(L, CPU, n0=8).solve(
        rng.standard_normal((n, 2)).astype(np.float32))
    assert (trmm.trmm.launches,
            tri_inv_block.tri_inv_blocks.launches) == counts


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--workload", "trsm", "--n", "64", "--requests", "6",
                "--precision", "bf16_refine", "--device", "cpu",
                "--cache-stats"])
    out = capsys.readouterr().out
    assert "served 6 solve requests" in out and "hit_rate" in out
    with pytest.raises(SystemExit):          # not ported yet (A15)
        serve.main(["--workload", "lm", "--device", "cpu"])


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, numpy as np\n"
        "from repro_torch import api\n"
        "n = 32\n"
        "L = np.tril(np.random.default_rng(0).standard_normal((n, n)))"
        " + n * np.eye(n)\n"
        "s = api.Solver.from_factor(L.astype(np.float32),"
        " api.make_trsm_mesh(1, 1, device='cpu'), precision='bf16_refine')\n"
        "s.solve(np.ones((n, 2), np.float32))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": "src"},
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
