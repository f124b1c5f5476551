"""The port's distributed algorithms (``repro_torch.core`` at p > 1) held
against the reference's on the CPU.

The reference runs in one subprocess with 8 forced host devices (this
process keeps one, as ``tests/test_core_distributed.py`` does); the port
runs one subprocess per grid, (2, 2), (2, 1), (1, 2) and (1, 8), of gloo
ranks (``python -m repro_torch.core.selfcheck --grid P1,P2 --out DIR``),
all on the same seeded inputs: the selfchecks' cases
(``repro_torch.core.selfcheck.CASES``).

* fp64 results within 1e-10 of the reference's (``assert_close``; an
  inverse with ``assert_inverse_close``);
* the port's recorded cost traces (S, W, F and ``by_op``) equal the
  reference's ``comm.traced_cost`` exactly for every mm3d, tri_inv,
  It-Inv and rec case at p > 1: It-Inv's as phase 1
  (``it_inv_phase1_sharded``, with ``block_inv`` the Pallas kernel
  hook) plus the unrolled sweep (``it_inv_sweep_sharded(unroll=True)``)
  in the reference, the one-shot program in the port;
* the port's own checks pass on every grid and rank: the pipelined
  programs give the sequential ones' bits (``overlap``), phase 1's
  transposed faces are lower triangular (``face``), the tuple-axis
  collectives keep the reference's rank order (``order``), what the
  next slice brings raises (``deferred``), and every rank records the
  same cost trace.

The subprocesses share one deadline (``DEADLINE_S`` from the fixture's
start), each gets what is left of it as its timeout, and the port's
process groups have a collective timeout well below it
(``selfcheck.TIMEOUT_S``), so a rank that waits on a collective that
never comes fails its tests.  A grid that fails shows each rank's log
(``--out``'s ``ranks_<p1>_<p2>/rank<r>.log``) in its message.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.core import selfcheck
from torch_parity import assert_close, assert_inverse_close

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRIDS = [(2, 2), (2, 1), (1, 2), (1, 8)]
DEADLINE_S = 420
COMPARED = ("mm3d", "tri_inv", "doubling", "it_inv_trsm", "rec_trsm", "trsm")
COSTED = ("mm3d", "tri_inv", "doubling", "it_inv_trsm", "rec_trsm")
PORT_ONLY = ("order", "overlap", "face", "deferred", "padded", "bank_bits")
# the front door: Solver and FactorBank at p > 1 against the reference's
# Solver and FactorBank; the banked programs' costs against the
# reference's traced vmapped sweep and recursion
FRONT = ("session", "session_refine", "bank", "cyclic", "capacity")
FRONT_COSTED = ("session", "session_refine", "bank")

# The reference side: each compared case's output and traced cost.
REFERENCE = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro import core
from repro.core import comm, grid as gridlib, inv_trsm, mm3d, rec_trsm, tri_inv
from repro.kernels import ops
from repro.core.bank import FactorBank
from repro_torch.core.selfcheck import (BANK_K, BANK_M, BANK_N, BANK_N0,
                                        CASES, VARIANTS, _bank_inputs,
                                        capacity_script, random_tril, rhs)

out_dir = sys.argv[1]
f64 = jnp.float64


def sds(*shape):
    return jax.ShapeDtypeStruct(shape, f64)


def cost_of(*traces):
    by_op = {}
    for t in traces:
        for op, d in t.by_op().items():
            acc = by_op.setdefault(op, dict(count=0.0, s=0.0, w=0.0, f=0.0))
            for key in acc:
                acc[key] += d[key]
    return dict(s=sum(t.s for t in traces), w=sum(t.w for t in traces),
                f=sum(t.f for t in traces), by_op=by_op)


def save(name, i, out, cost=None):
    np.savez(os.path.join(out_dir, f"{name}_{i}.npz"),
             out=np.asarray(out, np.float64), cost=json.dumps(cost))


for i, (p1, p2, m, n, k) in enumerate(CASES["mm3d"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    rng = np.random.default_rng(m * n)
    L, X = rng.standard_normal((m, n)), rng.standard_normal((n, k))
    save("mm3d", i, mm3d.matmul(L, X, grid), cost_of(comm.traced_cost(
        mm3d.mm3d_fn(grid, m, n, k), sds(m, n), sds(n, k))))

for i, (p1, p2, n, s0, mode) in enumerate(CASES["tri_inv"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    L = random_tril(n, n)
    save("tri_inv", i, tri_inv.invert(L, grid, s0=s0, mode=mode),
         cost_of(comm.traced_cost(tri_inv.tri_inv_fn(grid, n, s0, mode=mode),
                                  sds(n, n))))


def it_inv(name, i, p1, p2, n, k, n0, mode, B):
    grid = gridlib.make_trsm_mesh(p1, p2)
    L = random_tril(n, n)
    X = inv_trsm.solve(jnp.asarray(L), jnp.asarray(B), grid, n0, mode=mode)
    mode = mode or inv_trsm.pick_phase1_mode(n, n0, grid)
    ph1 = comm.traced_cost(inv_trsm.it_inv_phase1_sharded(
        grid, n, n0, block_inv=ops.block_inv_kernel, mode=mode), sds(n, n))
    sw = comm.traced_cost(inv_trsm.it_inv_sweep_sharded(
        grid, n, k, n0, unroll=True), sds(n, n), sds(n // n0, n0, n0),
        sds(n, k))
    save(name, i, X, cost_of(ph1, sw))


for i, (p1, p2, n, k, n0, mode) in enumerate(CASES["it_inv_trsm"]):
    it_inv("it_inv_trsm", i, p1, p2, n, k, n0, mode, rhs(k, n, k))
for i, (p1, p2, n, k, n0) in enumerate(CASES["doubling"]):
    it_inv("doubling", i, p1, p2, n, k, n0, "doubling", rhs(2, n, k))

for i, (p1, p2, n, k, n0) in enumerate(CASES["rec_trsm"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    L, B = random_tril(n, n), rhs(1, n, k)
    save("rec_trsm", i, rec_trsm.solve(L, B, grid, n0),
         cost_of(comm.traced_cost(rec_trsm.rec_trsm_sharded(grid, n, k, n0),
                                  sds(n, n), sds(n, k))))

# the front door at p > 1: "inv" banks through the Pallas hook (the
# reference's default phase 1 fails on jax 0.9); costs of the vmapped
# (banked) programs, one factor's per example
HOOK = dict(block_inv=ops.block_inv_kernel)


def banked_cost(grid, method, M, n, k, n0):
    if method == "inv":
        return cost_of(comm.traced_cost(jax.vmap(inv_trsm.it_inv_sweep_sharded(
            grid, n, k, n0, unroll=True)), sds(M, n, n),
            sds(M, n // n0, n0, n0), sds(M, n, k)))
    return cost_of(comm.traced_cost(jax.vmap(rec_trsm.rec_trsm_sharded(
        grid, n, k, n0)), sds(M, n, n), sds(M, n, k)))


def hook(method):
    return HOOK if method == "inv" else {}


for i, (p1, p2, n, k, n0, method) in enumerate(CASES["session"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    L, B = random_tril(n, n), rhs(n * k + 5, n, k)
    outs = []
    for lower, transpose in VARIANTS:
        A = L if lower else L.T
        solver = core.Solver.from_factor(A, grid, method=method, n0=n0,
                                         lower=lower, transpose=transpose,
                                         **hook(method))
        outs.append(np.asarray(solver.solve(B, donate=False)))
    save("session", i, np.stack(outs), banked_cost(grid, method, 1, n, k, n0))

for i, (p1, p2, method) in enumerate(CASES["session_refine"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    n, k, n0 = 64, 16, 16
    L = random_tril(5, n, np.float32)
    B = rhs(6, n, k).astype(np.float32)
    solver = core.Solver.from_factor(L, grid, method=method, n0=n0,
                                     precision="bf16_refine", **hook(method))
    save("session_refine", i, np.asarray(solver.solve(B, donate=False)),
         banked_cost(grid, method, 1, n, k, n0))

M, N, K, N0 = BANK_M, BANK_N, BANK_K, BANK_N0
for i, (p1, p2, method, map_mode, precision) in enumerate(CASES["bank"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    Ls, B = _bank_inputs(precision)
    bank = FactorBank(grid, N, method=method, n0=N0,
                      dtype=None if precision else np.float64,
                      precision=precision, map_mode=map_mode, **hook(method))
    bank.admit_stack(Ls[:2])
    bank.admit(Ls[2])
    X = core.Solver.from_bank(bank).solve(B, donate=False)
    save("bank", i, X, banked_cost(grid, method, M, N, K, N0))

for i, (p1, p2) in enumerate(CASES["cyclic"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    L, B = random_tril(20, N), rhs(21, N, K)
    bank = FactorBank(grid, N, n0=N0, dtype=np.float64, **HOOK)
    bank.admit_cyclic(gridlib.to_cyclic_matrix(L, p1, p1 * p2))
    save("cyclic", i, np.asarray(core.Solver.from_bank(bank).solve(
        B[None], donate=False))[0])


def solve_bank(bank, B):
    return np.asarray(core.Solver.from_bank(bank).solve(B, donate=False),
                      np.float64)


for i, (p1, p2, method, precision) in enumerate(CASES["capacity"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    bank = FactorBank(grid, N, method=method, n0=N0,
                      dtype=None if precision else np.float64,
                      precision=precision, capacity=4, **hook(method))
    waves = capacity_script(bank, N, N // 2, 30,
                            np.float32 if precision else np.float64,
                            solve_bank)
    save("capacity", i, waves[-1][1])

for i, (p1, p2, n, k, n0, method) in enumerate(CASES["trsm"]):
    grid = gridlib.make_trsm_mesh(p1, p2)
    L, B = random_tril(n, n), rhs(n * k + 3, n, k)
    outs = []
    for lower, transpose in VARIANTS:
        A = L if lower else L.T
        outs.append(np.asarray(core.trsm(A, B, grid, method=method, n0=n0,
                                         lower=lower, transpose=transpose)))
    save("trsm", i, np.stack(outs))
print("reference done")
'''


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _start(args, log, **env):
    """A subprocess writing its output to the file ``log``, in a session
    of its own, so that a timeout kills it and every rank it spawned."""
    with open(log, "w") as f:
        return subprocess.Popen(args, stdout=f, stderr=subprocess.STDOUT,
                                env=_env(**env), start_new_session=True)


def _finish(proc, log, timeout) -> tuple:
    """(exit code, output) of ``proc``; the exit code is None when its
    session was killed at ``timeout``."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        return None, f"{log.read_text()}\nkilled at the deadline"
    return proc.returncode, log.read_text()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (in the background) and the port's four grids
    in turn, all within ``DEADLINE_S``; returns (reference dir, (its
    exit code, its output)) and {grid: (port dir, (exit code,
    output))}."""
    deadline = time.monotonic() + DEADLINE_S

    def left():
        return max(deadline - time.monotonic(), 1.0)

    ref_dir = tmp_path_factory.mktemp("reference")
    ref = _start([sys.executable, "-c", REFERENCE, str(ref_dir)],
                 ref_dir / "log.txt",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu")
    try:
        port = {}
        for p1, p2 in GRIDS:
            out = tmp_path_factory.mktemp(f"port_{p1}_{p2}")
            port[(p1, p2)] = (out, _finish(_start(
                [sys.executable, "-m", "repro_torch.core.selfcheck",
                 "--device", "cpu", "--grid", f"{p1},{p2}", "--out",
                 str(out)], out / "log.txt"), out / "log.txt", left()))
        ref_run = _finish(ref, ref_dir / "log.txt", left())
    finally:
        if ref.poll() is None:
            os.killpg(ref.pid, signal.SIGKILL)
            ref.wait()
    return (ref_dir, ref_run), port


def _grid_log(out_dir, run) -> str:
    """The selfcheck's exit code and output and each rank's log, for a
    failure's message."""
    text = f"exit {run[0]}\n{run[1][-4000:]}"
    for log in sorted(out_dir.glob("ranks_*/rank*.log")):
        text += f"\n--- {log.name}\n{log.read_text()[-2000:]}"
    return text


def _cases(names):
    return [pytest.param(name, i, id=f"{name}-{i}")
            for name in names for i, case in enumerate(selfcheck.CASES[name])
            if case[0] * case[0] * case[1] > 1]


def _port(runs, name, i):
    grid = tuple(selfcheck.CASES[name][i][:2])
    out_dir, run = runs[1][grid]
    path = out_dir / f"{name}_{i}.npz"
    assert path.exists(), f"no port result for {name} {i}:\n" \
                          f"{_grid_log(out_dir, run)}"
    return np.load(path)


def _reference(runs, name, i):
    ref_dir, (rc, log) = runs[0]
    path = ref_dir / f"{name}_{i}.npz"
    assert path.exists(), f"no reference result for {name} {i} (exit " \
                          f"{rc}):\n{log[-4000:]}"
    return np.load(path)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[0]}x{g[1]}")
def test_port_selfcheck_passes_on_every_rank(runs, grid):
    """Every check of the grid passes on every rank, and every rank
    records the same cost trace."""
    out_dir, run = runs[1][grid]
    assert run[0] == 0 and "selfcheck: 0 failures" in run[1], \
        _grid_log(out_dir, run)


def test_reference_side_ran(runs):
    _, (rc, log) = runs[0]
    assert rc == 0 and "reference done" in log, log[-4000:]


@pytest.mark.parametrize("name,i", _cases(COMPARED))
def test_matches_reference(runs, name, i):
    got = _port(runs, name, i)["out"]
    want = _reference(runs, name, i)["out"]
    assert got.shape == want.shape
    if name == "tri_inv":
        assert_inverse_close(got, want, 1e-10)
    else:
        for g, w in zip(got.reshape((-1,) + want.shape[-2:]),
                        want.reshape((-1,) + want.shape[-2:])):
            assert_close(g, w, 1e-10)


@pytest.mark.parametrize("name,i", _cases(COSTED))
def test_cost_trace_matches_reference(runs, name, i):
    """S, W, F and the per-op counts and sums, exactly."""
    got = json.loads(str(_port(runs, name, i)["cost"]))
    want = json.loads(str(_reference(runs, name, i)["cost"]))
    assert (got["s"], got["w"], got["f"]) == (want["s"], want["w"],
                                              want["f"])
    assert got["by_op"] == want["by_op"]


@pytest.mark.parametrize("name,i", _cases(PORT_ONLY))
def test_port_check(runs, name, i):
    """``overlap``: the same bits as the sequential program; ``face``: the
    faces are lower triangular on every rank; ``order``: x-major rank
    order of the tuple-axis collectives; ``deferred``: structures,
    fleets, the serving tiers and multi-rank cholesky and lu raise,
    naming the next slice; ``padded``: a padded slot's leading block is
    the unpadded bank's, bit for bit, lower, upper and transposed;
    ``bank_bits``: a bank's "scan" gives "vmap"'s bits, overlap on gives
    off's."""
    assert bool(_port(runs, name, i)["ok"])


def _front_case(name, i) -> tuple:
    """(method, precision) of a front-door case."""
    case = selfcheck.CASES[name][i]
    if name == "session":
        return case[-1], None
    if name == "session_refine":
        return case[2], "bf16_refine"
    if name == "cyclic":
        return "inv", None
    return case[2], case[-1]                       # bank, capacity


def _front_tol(name, i) -> float:
    """fp32 and bf16_refine 2e-5 (``torch_parity``); fp64 "rec" 1e-10;
    fp64 "inv" 2e-5: the reference's banked "inv" inverts through the
    Pallas hook, which is fp32-grade in fp64 (the port's fp64 banks are
    held to 1e-10 of its own one-shot solve by the selfcheck)."""
    method, precision = _front_case(name, i)
    return 1e-10 if method == "rec" and precision is None else 2e-5


@pytest.mark.parametrize("name,i", _cases(FRONT))
def test_front_door_matches_reference(runs, name, i):
    """``Solver.from_factor`` in four variants, every preset's refined
    session, append-only banks in "vmap" and "scan", ``admit_cyclic``
    and a capacity bank's lifecycle (compared on its live slots: the
    reference's "rec" capacity bank solves dead lanes to NaN), each
    against the reference's run of the same inputs."""
    port = _port(runs, name, i)
    got, want = port["out"], _reference(runs, name, i)["out"]
    assert got.shape == want.shape
    if name == "capacity":
        live = list(json.loads(str(port["live"])))
        got, want = got[live], want[live]
    tol = _front_tol(name, i)
    for g, w in zip(got.reshape((-1,) + want.shape[-2:]),
                    want.reshape((-1,) + want.shape[-2:])):
        assert_close(g, w, tol)


@pytest.mark.parametrize("name,i", _cases(FRONT_COSTED))
def test_banked_cost_trace_matches_reference(runs, name, i):
    """A banked solve's trace outside its residual equals the
    reference's ``traced_cost`` of the vmapped sweep (unrolled) or
    recursion, exactly, once per pass of the preset (1 + its refine
    steps); the residual's mm3d is the port's own part, held to
    ``mm_cost`` by the selfcheck."""
    from repro_torch.core import precision as preclib
    got = json.loads(str(_port(runs, name, i)["cost"]))
    want = json.loads(str(_reference(runs, name, i)["cost"]))
    precision = _front_case(name, i)[1] if name == "bank" else None
    passes = 1 + (preclib.resolve(precision).refine_steps
                  if precision else 0)
    assert (got["s"], got["w"], got["f"]) == (passes * want["s"],
                                              passes * want["w"],
                                              passes * want["f"])
    assert got["by_op"] == {op: {key: passes * v for key, v in d.items()}
                            for op, d in want["by_op"].items()}


@pytest.mark.parametrize("p_row,p_col", [(2, 4), (3, 2), (1, 8), (4, 1)])
def test_cyclic_matrix_helpers_match_reference(p_row, p_col):
    """``to_cyclic_matrix`` / ``from_cyclic_matrix`` permute as the
    reference's do, and undo each other, on numpy and torch."""
    import torch
    from repro.core import grid as jgrid
    from repro_torch.core import grid
    A = np.random.default_rng(p_row * 10 + p_col).standard_normal((12, 8))
    C = grid.to_cyclic_matrix(A, p_row, p_col)
    assert np.array_equal(C, jgrid.to_cyclic_matrix(A, p_row, p_col))
    assert np.array_equal(grid.from_cyclic_matrix(C, p_row, p_col), A)
    T = torch.as_tensor(A)
    assert torch.equal(grid.from_cyclic_matrix(
        grid.to_cyclic_matrix(T, p_row, p_col), p_row, p_col), T)
