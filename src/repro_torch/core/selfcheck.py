"""Multi-rank self-checks of the distributed algorithms (the counterpart
of ``repro.core.selfcheck``), with the reference's cases and bounds.

    PYTHONPATH=src python -m repro_torch.core.selfcheck [name]
        [--device cuda|cpu] [--grid P1,P2] [--out DIR]

One set of ranks is spawned per grid, not per case: p processes on
gloo, every rank on ``--device`` (by default ``cuda``, which puts every
rank on cuda:0, where gloo stages the collectives through the host;
``cpu`` runs the kernels' plain versions).  They meet through a file in
a new temporary directory, so no TCP port is taken.  The 1 x 1 x 1
cases run in this process.  ``--grid`` keeps one grid's cases;
``--out`` writes each case's natural-layout result, whether it passed
and its recorded cost trace (rank 0's, as JSON) to
``DIR/<name>_<case>.npz``, and each rank's standard output and error
to ``DIR/ranks_<p1>_<p2>/rank<r>.log``.  Exits non-zero on any
failure, a rank's included.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

# a collective that waits longer than this fails its rank
TIMEOUT_S = 120


def random_tril(seed: int, n: int, dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n)))
    return (L + n * np.eye(n)).astype(dtype)


def rhs(seed: int, n: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, k))


# The reference selfcheck's cases (each leads with its grid (p1, p2)),
# then this package's: ``trsm`` (the one-shot core.trsm in its four
# operator variants), ``overlap`` (the pipelined programs against the
# sequential ones, bit for bit), ``face`` (phase 1's transposed faces
# are lower triangular in every mode) and ``deferred`` (what the next
# slice brings raises NotImplementedError, never a wrong answer).
CASES = {
    "order": [(2, 2)],
    "mm3d": [(2, 2, 16, 16, 8), (2, 1, 8, 8, 4), (1, 2, 8, 8, 8),
             (1, 8, 16, 16, 16), (2, 2, 32, 16, 8), (1, 1, 8, 8, 4),
             (2, 2, 16, 16, 64)],
    "tri_inv": [(2, 2, 64, None, None), (2, 2, 64, 8, "alltoall"),
                (2, 2, 32, 8, "allgather"), (1, 2, 32, None, None),
                (2, 1, 32, None, None), (1, 8, 64, None, None),
                (1, 1, 16, None, None)],
    "doubling": [(2, 2, 64, 16, 32), (2, 2, 64, 16, 16), (1, 8, 64, 8, 32)],
    "it_inv_trsm": [(2, 2, 32, 8, 4, None), (2, 2, 32, 8, 8, None),
                    (2, 2, 64, 16, 8, "alltoall"),
                    (2, 2, 64, 16, 8, "allgather"), (2, 1, 32, 6, 8, None),
                    (1, 2, 32, 8, 16, None), (1, 8, 64, 8, 8, None),
                    (2, 2, 64, 64, 16, None), (1, 1, 16, 4, 4, None)],
    "rec_trsm": [(2, 2, 64, 16, 16), (2, 2, 64, 16, None), (2, 1, 32, 8, 8),
                 (1, 2, 32, 4, None), (1, 8, 64, 16, None),
                 (1, 1, 16, 4, 4), (2, 2, 32, 32, 8)],
    "trsm": [(2, 2, 64, 16, 16, "inv"), (2, 1, 32, 8, 8, "inv"),
             (1, 2, 32, 8, 16, "rec"), (2, 2, 64, 16, 16, "rec"),
             (2, 2, 64, 16, None, "auto")],
    "overlap": [(2, 2, "inv", 64, 8, 16), (2, 1, "inv", 64, 8, 16),
                (1, 2, "inv", 64, 8, 16), (2, 2, "inv", 64, 8, 32),
                (2, 2, "rec", 64, 8, 16), (1, 8, "rec", 64, 8, None)],
    "face": [(2, 2, 64, 8, "alltoall"), (2, 2, 64, 16, "doubling"),
             (2, 2, 64, 16, "allgather"), (2, 1, 32, 8, "doubling"),
             (1, 2, 32, 8, "allgather")],
    "deferred": [(2, 1, 32, 8, 8)],
    # the front door at p > 1: the reference's check_session (n, k, n0,
    # method) and its refined sessions, check_bank (method, map_mode,
    # precision) and its cyclic ingestion, then this package's capacity
    # bank lifecycle, the padded identity and the bank's bit contracts
    "session": [(2, 2, 64, 16, 16, "inv"), (2, 1, 32, 8, 8, "inv"),
                (1, 2, 32, 8, 16, "rec"), (2, 2, 64, 16, 16, "rec"),
                (1, 8, 64, 8, 8, "inv"), (1, 8, 64, 16, 16, "rec")],
    "session_refine": [(2, 2, "inv"), (2, 2, "rec"), (2, 1, "inv"),
                       (1, 2, "rec"), (1, 8, "inv")],
    "bank": [(2, 2, "inv", "vmap", None), (2, 2, "inv", "scan", None),
             (2, 1, "rec", "vmap", None),
             (2, 2, "inv", "vmap", "bf16_refine"),
             (1, 2, "rec", "scan", None), (1, 8, "inv", "vmap", None),
             (2, 2, "rec", "vmap", "bf16_refine")],
    "cyclic": [(2, 2), (1, 2), (2, 1)],
    "capacity": [(2, 2, "inv", "bf16_refine"), (2, 2, "rec", "fp32"),
                 (2, 1, "inv", None), (1, 2, "rec", None),
                 (1, 8, "inv", None), (1, 8, "rec", "bf16_refine")],
    "padded": [(2, 2, 128, 64, 16), (2, 1, 64, 32, 16),
               (1, 2, 64, 32, 16), (1, 8, 128, 64, 16)],
    "bank_bits": [(2, 2, "inv"), (2, 2, "rec"), (2, 1, "inv"),
                  (1, 8, "rec")],
}
# the banks' shapes (the reference's check_bank's) and their block size
BANK_M, BANK_N, BANK_K, BANK_N0 = 3, 64, 16, 16
VARIANTS = ((True, False), (False, False), (True, True), (False, True))


def _traced(fn):
    """(fn's result as float64 numpy, its recorded cost trace)."""
    from repro_torch.core import comm
    with comm.trace() as t:
        out = fn()
    cost = dict(t.summary(), by_op=t.by_op())
    return np.asarray(out.detach().cpu().double()), cost


def _result(line, ok, out=None, cost=None):
    return dict(line=line, ok=bool(ok), out=out, cost=cost, live=None)


def check_order(grid, case):
    """The tuple-axis collectives' order: x-major, row-major ranks."""
    from repro_torch.core import comm
    p = grid.p
    with comm.on_mesh(grid.mesh):
        me = torch.tensor([grid.mesh.rank], dtype=torch.float64,
                          device=grid.device)
        g = comm.all_gather(me, comm.MESH_AXES, axis=0, tiled=True)
        items = me * p + torch.arange(p, dtype=torch.float64,
                                      device=grid.device)
        r = comm.all_to_all(items, comm.MESH_AXES, split_axis=0,
                            concat_axis=0, tiled=True)
    ok_g = np.array_equal(g.cpu().numpy(), np.arange(p))
    ok_a = np.array_equal(r.cpu().numpy(),
                          np.arange(p) * p + grid.mesh.rank)
    return _result(f"order all_gather {'OK' if ok_g else 'MISMATCH'}, "
                   f"all_to_all {'OK' if ok_a else 'MISMATCH'}",
                   ok_g and ok_a)


def check_mm3d(grid, case):
    from repro_torch.core import mm3d
    p1, p2, m, n, k = case
    rng = np.random.default_rng(m * n)
    L = rng.standard_normal((m, n))
    X = rng.standard_normal((n, k))
    B, cost = _traced(lambda: mm3d.matmul(torch.as_tensor(L),
                                          torch.as_tensor(X), grid))
    err = np.abs(B - L @ X).max()
    ok = err < 1e-10
    return _result(f"mm3d p1={p1} p2={p2} m={m} n={n} k={k}: err={err:.2e} "
                   f"{'OK' if ok else 'FAIL'}", ok, B, cost)


def check_tri_inv(grid, case):
    from repro_torch.core import tri_inv
    p1, p2, n, s0, mode = case
    L = random_tril(n, n)
    Li, cost = _traced(lambda: tri_inv.invert(torch.as_tensor(L), grid,
                                              s0=s0, mode=mode))
    err = np.abs(Li @ L - np.eye(n)).max()
    ok = err < 1e-9 and np.allclose(np.triu(Li, 1), 0)
    return _result(f"tri_inv p1={p1} p2={p2} n={n} s0={s0} mode={mode}: "
                   f"err={err:.2e} {'OK' if ok else 'FAIL'}", ok, Li, cost)


def _solve_case(grid, what, L, B, solve, bound):
    X, cost = _traced(solve)
    err = np.abs(X - np.linalg.solve(L, B)).max()
    ok = err < bound
    return _result(f"{what}: err={err:.2e} {'OK' if ok else 'FAIL'}", ok, X,
                   cost)


def check_it_inv_trsm(grid, case):
    from repro_torch.core import inv_trsm
    p1, p2, n, k, n0, mode = case
    L, B = random_tril(n, n), rhs(k, n, k)
    return _solve_case(
        grid, f"it_inv_trsm p1={p1} p2={p2} n={n} k={k} n0={n0} mode={mode}",
        L, B, lambda: inv_trsm.solve(torch.as_tensor(L), torch.as_tensor(B),
                                     grid, n0, mode=mode), 1e-8)


def check_doubling(grid, case):
    from repro_torch.core import inv_trsm
    p1, p2, n, k, n0 = case
    L, B = random_tril(n, n), rhs(2, n, k)
    return _solve_case(
        grid, f"doubling p1={p1} p2={p2} n={n} n0={n0}", L, B,
        lambda: inv_trsm.solve(torch.as_tensor(L), torch.as_tensor(B), grid,
                               n0, mode="doubling"), 1e-9)


def check_rec_trsm(grid, case):
    from repro_torch.core import rec_trsm
    p1, p2, n, k, n0 = case
    L, B = random_tril(n, n), rhs(1, n, k)
    return _solve_case(
        grid, f"rec_trsm p1={p1} p2={p2} n={n} k={k} n0={n0}", L, B,
        lambda: rec_trsm.solve(torch.as_tensor(L), torch.as_tensor(B), grid,
                               n0), 1e-9)


def check_trsm(grid, case):
    """The one-shot ``core.trsm`` in its four operator variants; ``out``
    stacks the four X."""
    from repro_torch import core
    p1, p2, n, k, n0, method = case
    L, B = random_tril(n, n), rhs(n * k + 3, n, k)
    outs, lines, ok = [], [], True
    for lower, transpose in VARIANTS:
        A = L if lower else L.T
        op = A.T if transpose else A
        X = core.trsm(torch.as_tensor(A), torch.as_tensor(B), grid,
                      method=method, n0=n0, lower=lower,
                      transpose=transpose)
        X = X.cpu().double().numpy()
        err = np.abs(op @ X - B).max()
        ok = ok and err < 1e-8
        outs.append(X)
        lines.append(f"lower={lower} T={transpose} err={err:.2e}")
    return _result(f"trsm {method} p1={p1} p2={p2} n={n}: "
                   f"{'; '.join(lines)} {'OK' if ok else 'FAIL'}", ok,
                   np.stack(outs))


def check_overlap(grid, case):
    """The pipelined one-shot program against the sequential one: the
    same collectives on the same operands, so the same bits."""
    from repro_torch.core import precision as preclib
    from repro_torch.core.solver import SolveSpec, solver_for
    p1, p2, method, n, k, n0 = case
    L, B = random_tril(n, n), rhs(k, n, k)
    outs = {}
    for ov in ("on", "off"):
        spec = SolveSpec(n=n, k=k, grid=grid, policy=preclib.resolve(
            None, torch.float64), method=method,
            n0=n0 or _rec_n0(n, k, grid), overlap=ov)
        prog = solver_for(spec)
        outs[ov] = prog.solve(prog.prep(torch.as_tensor(L)),
                              torch.as_tensor(B)).cpu().numpy()
    bit = outs["on"].tobytes() == outs["off"].tobytes()
    err = np.abs(L @ outs["on"] - B).max()
    ok = bit and err < 1e-7
    return _result(f"overlap {method} p1={p1} p2={p2} n0={n0}: "
                   f"bit-identical={bit} err={err:.2e} "
                   f"{'OK' if ok else 'FAIL'}", ok, outs["on"])


def _rec_n0(n, k, grid):
    from repro_torch.core import rec_trsm
    return rec_trsm.default_n0(n, k, grid.p1, grid.p2)


def check_face(grid, case):
    """Phase 1's transposed faces binv[y::p1, x::p1] are lower triangular
    (strictly where y < x), so the solve step's B2 reads all of them."""
    from repro_torch.core import comm, grid as gridlib, inv_trsm
    from repro_torch.kernels import ops
    p1, p2, n, n0, mode = case
    Lloc = gridlib.local_piece(torch.as_tensor(random_tril(n, n)), grid, "L")
    with comm.on_mesh(grid.mesh):
        Dt = inv_trsm.invert_diag_blocks_shard(
            Lloc, n=n, n0=n0, p1=p1, p2=p2, block_inv=ops.block_inv_kernel,
            mode=mode)
    x, y, _ = grid.coords
    tri = bool(torch.equal(torch.tril(Dt), Dt))
    strict = y >= x or bool(torch.equal(torch.tril(Dt, -1), Dt))
    ok = tri and strict and bool(torch.count_nonzero(Dt) > 0)
    return _result(f"face {mode} p1={p1} p2={p2} n0={n0}: lower={tri} "
                   f"strict-where-y<x={strict} {'OK' if ok else 'FAIL'}", ok)


def check_deferred(grid, case):
    """What the next slice brings raises NotImplementedError naming it
    on a p > 1 grid: a structure (one-shot or banked), a fleet, a
    SolveServer and an AsyncSolveServer, multi-rank cholesky and lu."""
    from repro_torch import api
    from repro_torch.core import cholesky, lu
    from repro_torch.core import precision as preclib
    from repro_torch.core.solver import SolveSpec, solver_for
    p1, p2, n, k, n0 = case
    L, B = random_tril(n, n), rhs(7, n, k)
    banded = api.FactorStructure.banded(n0)
    attempts = {
        "structured solve": lambda: solver_for(SolveSpec(
            n=n, k=k, grid=grid, policy=preclib.resolve(None, torch.float64),
            n0=n0, structure=banded)),
        "structured bank": lambda: api.FactorBank(grid, n, n0=n0,
                                                  structure=banded),
        "fleet": lambda: api.SolverFleet(grid, api.plan_fleet({n: 1}, grid,
                                                              k=k)),
        "SolveServer": lambda: api.SolveServer(api.Solver.from_factor(
            torch.as_tensor(L), grid, n0=n0), panel_k=k),
        "AsyncSolveServer": lambda: api.AsyncSolveServer(
            api.Solver.from_factor(torch.as_tensor(L), grid, n0=n0),
            panel_k=k),
        "cholesky": lambda: cholesky.cholesky(torch.as_tensor(L @ L.T),
                                              grid),
        "lu": lambda: lu.lu(torch.as_tensor(L @ L.T), grid),
    }
    raised = {}
    for what, fn in attempts.items():
        try:
            fn()
            raised[what] = False
        except NotImplementedError as e:
            raised[what] = "next slice" in str(e)
    ok = all(raised.values())
    return _result(f"deferred p1={p1} p2={p2}: {raised} "
                   f"{'OK' if ok else 'FAIL'}", ok)


def _traced_parts(fn):
    """(fn's result as float64 numpy, the cost trace of its solve part
    (the records outside every label), its ``"residual"`` part's S, W
    and F)."""
    from repro_torch.core import comm
    with comm.trace() as t:
        out = fn()
    solve = t.part("")
    cost = dict(solve.summary(), by_op=solve.by_op())
    return (np.asarray(out.detach().cpu().double()), cost,
            t.part("residual").summary())


def _relres(A, X, B) -> float:
    return float(np.linalg.norm(A @ X - B) / np.linalg.norm(B))


def _one_shot(grid, L, B, method, n0, lower=True, transpose=False):
    """The one-shot ``core.trsm`` of the same inputs (fp64), the bound
    a banked fp64 solve is held to at 1e-10."""
    from repro_torch import core
    return core.trsm(torch.as_tensor(L), torch.as_tensor(B), grid,
                     method=method, n0=n0, lower=lower,
                     transpose=transpose).cpu().double().numpy()


def _rel_gap(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _steady(solver, Bs) -> tuple:
    """(X of each RHS, whether solving them built no program): the
    solve program's BUILD_COUNTS entry, read after warmup, unchanged."""
    from repro_torch.core import session
    k = Bs[0].shape[-1]
    solver.warmup(k)
    key = solver.program_for(k).key
    before = session.BUILD_COUNTS[key]
    outs = [solver.solve(solver.place_rhs(b)).reshape(b.shape).cpu()
            .double().numpy() for b in Bs]
    return outs, session.BUILD_COUNTS[key] == before


def check_session(grid, case):
    """The reference's check_session at p > 1: ``Solver.from_factor``
    (fp64) in the four operator variants, each within 1e-8 in residual
    and 1e-10 of the one-shot ``core.trsm``, and the steady state (no
    program built over 3 more solves).  ``out`` stacks the four X;
    ``cost`` is the lower solve's trace (the banked program's)."""
    from repro_torch import api
    p1, p2, n, k, n0, method = case
    L, B = random_tril(n, n), rhs(n * k + 5, n, k)
    outs, lines, ok, cost = [], [], True, None
    for lower, transpose in VARIANTS:
        A = L if lower else L.T
        op = A.T if transpose else A
        solver = api.Solver.from_factor(torch.as_tensor(A), grid,
                                        method=method, n0=n0, lower=lower,
                                        transpose=transpose)
        X, c, _ = _traced_parts(lambda: solver.solve(torch.as_tensor(B)))
        cost = cost or c
        gap = _rel_gap(X, _one_shot(grid, A, B, method, n0, lower,
                                    transpose))
        err = np.abs(op @ X - B).max()
        ok = ok and err < 1e-8 and gap <= 1e-10
        outs.append(X)
        lines.append(f"lower={lower} T={transpose} err={err:.2e} "
                     f"vs-one-shot={gap:.1e}")
    solver = api.Solver.from_factor(torch.as_tensor(L), grid, method=method,
                                    n0=n0)
    Bs = [rhs(100 + i, n, k) for i in range(3)]
    xs, steady = _steady(solver, Bs)
    err = max(np.abs(L @ x - b).max() for x, b in zip(xs, Bs))
    ok = ok and steady and err < 1e-8
    return _result(f"session {method} p1={p1} p2={p2} n={n}: "
                   f"{'; '.join(lines)}; steady err={err:.2e} "
                   f"builds={'0' if steady else 'NONZERO'} "
                   f"{'OK' if ok else 'FAIL'}", ok, np.stack(outs), cost)


PRESET_BOUND = {"bf16_refine": 1e-5, "fp32": 1e-5, "fp64_refine": 1e-11}


def check_session_refine(grid, case):
    """Every precision preset through ``Solver.from_factor`` at p > 1
    (n = 64, n0 = 16, k = 16): relres within the preset's bound
    (``tests/test_api_solver.py``), the steady state, X at the io
    dtype; a refined program's residual part of the cost trace is
    ``refine_steps`` mm3d products (``cost_model.mm_cost``'s S and W)
    and its solve part ``1 + refine_steps`` times the unrefined
    program's.  ``out`` is the bf16_refine X, ``cost`` the fp32 solve's
    trace."""
    from repro_torch import api
    from repro_torch.core import cost_model
    from repro_torch.core import precision as preclib
    p1, p2, method = case
    n, k, n0 = 64, 16, 16
    L = random_tril(5, n, np.float32)
    L64 = L.astype(np.float64)
    B = rhs(6, n, k).astype(np.float32)
    runs, lines, ok = {}, [], True
    for preset in ("fp32", "bf16_refine", "fp64_refine"):
        pol = preclib.resolve(preset)
        Lp = L64 if preset == "fp64_refine" else L
        solver = api.Solver.from_factor(torch.as_tensor(Lp), grid,
                                        method=method, n0=n0,
                                        precision=preset)
        Bp = torch.as_tensor(B, dtype=pol.io_dtype)
        X, cost, res = _traced_parts(lambda: solver.solve(Bp))
        (x2,), steady = _steady(solver, [Bp])
        rel = _relres(Lp.astype(np.float64), X, B.astype(np.float64))
        good = (rel < PRESET_BOUND[preset] and steady
                and solver.dtype == pol.io_dtype and np.array_equal(X, x2))
        if pol.refines:
            mm = cost_model.mm_cost(n, -(-k // grid.p) * grid.p, grid.p,
                                    p1, p2)
            steps = pol.refine_steps
            good = good and (res["s"], res["w"]) == (steps * mm.s,
                                                     steps * mm.w)
            base = runs["fp32"][1]
            good = good and all(cost[key] == (1 + steps) * base[key]
                                for key in ("s", "w", "f"))
        runs[preset] = (X, cost)
        ok = ok and good
        lines.append(f"{preset} relres={rel:.2e}"
                     f"{'' if good else ' FAIL'}")
    return _result(f"session_refine {method} p1={p1} p2={p2}: "
                   f"{'; '.join(lines)} {'OK' if ok else 'FAIL'}", ok,
                   runs["bf16_refine"][0], runs["fp32"][1])


def _bank_inputs(precision):
    dt = np.float32 if precision else np.float64
    Ls = np.stack([random_tril(10 + i, BANK_N, dt) for i in range(BANK_M)])
    B = rhs(11, BANK_M * BANK_N, BANK_K).reshape(
        BANK_M, BANK_N, BANK_K).astype(dt)
    return Ls, B


def check_bank(grid, case):
    """The reference's check_bank at p > 1: an append-only bank of 3
    factors (``admit_stack`` of 2, then ``admit``) served through
    ``Solver.from_bank`` in its map mode and preset, each slot within
    the bound in relres, an fp64 slot within 1e-10 of the one-shot
    solve, the steady state; ``Solver.from_factors`` and
    ``Solver.from_spec`` on the same stack give the same X.  ``out`` is
    the (M, n, k) X, ``cost`` its trace's solve part."""
    from repro_torch import api
    from repro_torch.core.solver import SolveSpec
    p1, p2, method, map_mode, precision = case
    Ls, B = _bank_inputs(precision)
    bank = api.FactorBank(grid, BANK_N, method=method, n0=BANK_N0,
                          dtype=None if precision else torch.float64,
                          precision=precision, map_mode=map_mode)
    bank.admit_stack(torch.as_tensor(Ls[:2]))
    bank.admit(torch.as_tensor(Ls[2]))
    solver = api.Solver.from_bank(bank)
    X, cost, _ = _traced_parts(lambda: solver.solve(torch.as_tensor(B)))
    rel = max(_relres(Ls[i].astype(np.float64), X[i], B[i])
              for i in range(BANK_M))
    ok = rel < (1e-5 if precision else 1e-10)
    gap = 0.0
    if not precision:
        gap = max(_rel_gap(X[i], _one_shot(grid, Ls[i], B[i], method,
                                           BANK_N0))
                  for i in range(BANK_M))
        ok = ok and gap <= 1e-10
    xs, steady = _steady(solver, [torch.as_tensor(B)] * 2)
    kw = dict(method=method, n0=BANK_N0, map_mode=map_mode,
              precision=precision,
              dtype=None if precision else torch.float64)
    Xf = api.Solver.from_factors(torch.as_tensor(Ls), grid, **kw).solve(
        torch.as_tensor(B)).cpu().double().numpy()
    spec = SolveSpec(n=BANK_N, k=BANK_K, grid=grid, policy=bank.policy,
                     method=method, n0=BANK_N0, bank_width=BANK_M,
                     map_mode=map_mode)
    Xs = api.Solver.from_spec(spec, torch.as_tensor(Ls)).solve(
        torch.as_tensor(B)).cpu().double().numpy()
    spread = max(_rel_gap(Y, X) for Y in [Xf, Xs] + xs)
    same = spread <= 1e-12
    ok = ok and steady and same
    return _result(f"bank {method} p1={p1} p2={p2} {map_mode} "
                   f"{precision or 'uniform'}: relres={rel:.2e} "
                   f"vs-one-shot={gap:.1e} builds="
                   f"{'0' if steady else 'NONZERO'} "
                   f"from_factors/from_spec/steady within {spread:.1e} "
                   f"{'OK' if ok else 'FAIL'}", ok, X, cost)


def check_cyclic(grid, case):
    """``admit_cyclic`` at p > 1: every rank passes the whole
    cyclic-layout factor and keeps its piece; the solve within 1e-10 in
    relres and equal to the natural admission's X."""
    from repro_torch import api
    from repro_torch.core import grid as gridlib
    p1, p2 = case
    n, k = BANK_N, BANK_K
    L, B = random_tril(20, n), rhs(21, n, k)
    Lc = gridlib.to_cyclic_matrix(L, p1, p1 * p2)
    bank = api.FactorBank(grid, n, n0=BANK_N0, dtype=torch.float64)
    bank.admit_cyclic(torch.as_tensor(Lc))
    cap = api.FactorBank(grid, n, n0=BANK_N0, dtype=torch.float64,
                         capacity=2)
    cap.admit(torch.as_tensor(L))
    cap.replace_cyclic(0, torch.as_tensor(Lc))
    X = api.Solver.from_bank(bank).solve(torch.as_tensor(B)[None])[0]
    X = X.cpu().numpy()
    Xn = api.Solver.from_factor(torch.as_tensor(L), grid, n0=BANK_N0
                                ).solve(torch.as_tensor(B)).cpu().numpy()
    Bc = np.zeros((2, n, k))
    Bc[0] = B
    Xc = api.Solver.from_bank(cap).solve(torch.as_tensor(Bc))[0]
    Xc = Xc.cpu().numpy()
    rel = _relres(L, X, B)
    ok = (rel < 1e-10 and np.array_equal(X, Xn)
          and _rel_gap(Xc, Xn) <= 1e-12)
    return _result(f"cyclic p1={p1} p2={p2}: relres={rel:.2e} "
                   f"same-as-natural={np.array_equal(X, Xn)} "
                   f"{'OK' if ok else 'FAIL'}", ok, X)


def capacity_script(bank, n, d, seed0, dt, solve):
    """The capacity lifecycle every rank runs on a C = 4 bank: two
    admits, a padded admission of an order-d factor, a solve; replace,
    a replace_run of 2, evict, a solve; re-admit, a solve; factors
    and right-hand sides are numpy arrays and ``solve(bank, B)`` gives
    X as one (the reference's banks run the same script).  Returns
    every wave's (B, X, the slots live at it, the (factor, padded) each
    slot held at it)."""
    held = [None] * bank.capacity
    waves = []
    seeds = iter(range(seed0, seed0 + 100))

    def factor(order):
        return random_tril(next(seeds), order, dt)

    def padded(Ld):
        full = np.eye(n, dtype=Ld.dtype)
        full[:d, :d] = Ld
        return full

    def wave():
        B = np.zeros((bank.capacity, n, BANK_K), dt)
        for s in bank.live_slots():
            B[s] = rhs(next(seeds), n, BANK_K)
            if held[s][1]:                     # padded: a zero tail
                B[s, d:] = 0
        waves.append((B, solve(bank, B), tuple(bank.live_slots()),
                      list(held)))

    for _ in range(2):
        L = factor(n)
        held[bank.admit(L)] = (L, False)
    Ld = factor(d)
    held[bank.admit(Ld, pad_to=n)] = (padded(Ld), True)
    wave()
    L = factor(n)
    held[bank.replace(1, L)] = (L, False)
    run = np.stack([factor(n), factor(n)])
    for j, s in enumerate(bank.replace_run(0, run)):
        held[s] = (run[j], False)
    bank.evict(1)
    wave()
    L = factor(n)
    held[bank.admit(L)] = (L, False)
    wave()
    return waves


def check_capacity(grid, case):
    """A capacity bank's lifecycle at p > 1 (``capacity_script``): every
    live slot's relres within the bound against the factor it held,
    dead lanes and padded tails exactly zero, the solve program built
    once over the whole turnover and each updater once per UpdateSpec.
    ``out`` is the last wave's X, dead lanes included (``live`` flags
    the slots the reference is compared on)."""
    from repro_torch import api
    from repro_torch.core import session
    p1, p2, method, precision = case
    n, d = BANK_N, BANK_N // 2
    dt = np.float32 if precision else np.float64
    bank = api.FactorBank(grid, n, method=method, n0=BANK_N0,
                          dtype=None if precision else torch.float64,
                          precision=precision, capacity=4)
    builds0 = sum(session.BUILD_COUNTS.values())
    waves = capacity_script(
        bank, n, d, 30, dt, lambda bank, B: api.Solver.from_bank(bank).solve(
            torch.as_tensor(B)).cpu().double().numpy())
    key = api.Solver.from_bank(bank).spec_for(BANK_K)
    bound = 1e-5 if precision else 1e-10
    worst, zeros, ok = 0.0, True, True
    for B, X, live, held in waves:
        for s in range(bank.capacity):
            if s not in live:
                zeros = zeros and not np.any(X[s])
                continue
            L, pad = held[s]
            worst = max(worst, _relres(L.astype(np.float64), X[s], B[s]))
            if pad:
                zeros = zeros and not np.any(X[s, d:])
    # one solve program; updaters: natural, padded, a run of 2
    builds = sum(session.BUILD_COUNTS.values()) - builds0
    ok = worst < bound and zeros and session.BUILD_COUNTS[key] == 1 \
        and builds == 4
    res = _result(f"capacity {method} p1={p1} p2={p2} "
                  f"{precision or 'uniform'}: relres={worst:.2e} "
                  f"dead-and-tails-zero={zeros} builds={builds} "
                  f"{'OK' if ok else 'FAIL'}", ok, waves[-1][1])
    res["live"] = list(waves[-1][2])
    return res


def check_padded(grid, case):
    """The padded identity at p > 1: a capacity bank's padded slot
    (blockdiag(L, I), phase 1 on B5 with the flags routed to the
    inverting ranks) solves its leading d rows bit for bit as an
    unpadded order-d bank at the same n0 (its phase 1 on the
    all-gather, B1 on the same blocks), for lower, upper and transposed
    factors, in fp64 and bf16_refine; the tail is exactly zero."""
    from repro_torch import api
    p1, p2, n, d, n0 = case
    lines, ok = [], True
    for precision in (None, "bf16_refine"):
        dt = np.float32 if precision else np.float64
        kw = dict(n0=n0, precision=precision, capacity=2,
                  dtype=None if precision else torch.float64)
        for lower, transpose in ((True, False), (False, False),
                                 (True, True)):
            L = random_tril(d + 3, d, dt)
            A = L if lower else L.T
            big = api.FactorBank(grid, n, lower=lower, transpose=transpose,
                                 **kw)
            small = api.FactorBank(grid, d, lower=lower,
                                   transpose=transpose, mode="allgather",
                                   **kw)
            big.admit(torch.as_tensor(A), pad_to=n)
            small.admit(torch.as_tensor(A))
            b = rhs(d + 4, d, BANK_K).astype(dt)
            Bb = np.zeros((2, n, BANK_K), dt)
            Bb[0, :d] = b
            Bs = np.zeros((2, d, BANK_K), dt)
            Bs[0] = b
            Xb = api.Solver.from_bank(big).solve(torch.as_tensor(Bb))[0]
            Xs = api.Solver.from_bank(small).solve(torch.as_tensor(Bs))[0]
            bit = torch.equal(Xb[:d], Xs)
            tail = not torch.any(Xb[d:])
            ok = ok and bit and tail
            lines.append(f"{precision or 'fp64'} lower={lower} "
                         f"T={transpose}: bit-equal={bit} tail-zero={tail}")
    return _result(f"padded p1={p1} p2={p2} n={n} d={d}: "
                   f"{'; '.join(lines)} {'OK' if ok else 'FAIL'}", ok)


def check_bank_bits(grid, case):
    """A bank's program gives the same bits in map mode "scan" as in
    "vmap", and with overlap on as with it off (fp64, append-only)."""
    from repro_torch import api
    p1, p2, method = case
    Ls, B = _bank_inputs(None)
    outs = {}
    for map_mode, overlap in (("vmap", "on"), ("scan", "on"),
                              ("vmap", "off")):
        solver = api.Solver.from_factors(
            torch.as_tensor(Ls), grid, method=method, n0=BANK_N0,
            map_mode=map_mode, overlap=overlap)
        outs[(map_mode, overlap)] = solver.solve(torch.as_tensor(B))
    ref = outs[("vmap", "on")]
    scan = torch.equal(outs[("scan", "on")], ref)
    off = torch.equal(outs[("vmap", "off")], ref)
    ok = scan and off
    return _result(f"bank_bits {method} p1={p1} p2={p2}: scan==vmap={scan} "
                   f"overlap-off==on={off} {'OK' if ok else 'FAIL'}", ok)


RUN = {"order": check_order, "mm3d": check_mm3d, "tri_inv": check_tri_inv,
       "doubling": check_doubling, "it_inv_trsm": check_it_inv_trsm,
       "rec_trsm": check_rec_trsm, "trsm": check_trsm,
       "overlap": check_overlap, "face": check_face,
       "deferred": check_deferred, "session": check_session,
       "session_refine": check_session_refine, "bank": check_bank,
       "cyclic": check_cyclic, "capacity": check_capacity,
       "padded": check_padded, "bank_bits": check_bank_bits}


def _run_items(grid, items):
    return [(name, i, RUN[name](grid, CASES[name][i])) for name, i in items]


def _rank_main(rank, p1, p2, device, tmp, target, args, log_dir):
    def note(stage):
        if log_dir is not None:
            print(f"rank {rank} pid {os.getpid()}: {stage} at "
                  f"{time.time():.3f}", flush=True)

    if log_dir is not None:
        # this rank's output, gloo's and the traceback of a failure included
        log = os.open(os.path.join(log_dir, f"rank{rank}.log"),
                      os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(log, 1)
        os.dup2(log, 2)
        os.close(log)
    import torch.distributed as dist
    from repro_torch.core import grid as gridlib
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    note("started")
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
            world_size=p1 * p1 * p2, timeout=timeout)
        note("joined the world")
        try:
            grid = gridlib.make_trsm_mesh(p1, p2, device=device,
                                          timeout=timeout)
            note("built the mesh")
            result = target(grid, *args)
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
            note("ran the target")
            dist.barrier()
        finally:
            dist.destroy_process_group()
        note("left the world")
    except BaseException:
        traceback.print_exc()
        raise
    # the result is written and the world is gone: exit at once.  In the
    # interpreter's teardown gloo's threads have aborted a rank whose
    # every collective had finished ("terminate called without an
    # active exception", SIGABRT), failing a run that had passed
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(p1: int, p2: int, device, target, *args, log_dir=None) -> list:
    """Run ``target(grid, *args)`` in each rank of a p1 x p1 x p2 grid:
    p processes started by the spawn method (a parent holding a CUDA
    context cannot fork), a gloo world that meets through a file in a
    new temporary directory, every rank on ``device``, every collective
    bounded by :data:`TIMEOUT_S`.  ``target`` must be importable by
    name.  Returns the ranks' results (picklable), in rank order; a rank
    that raises makes this raise.  With ``log_dir``, rank r writes its
    standard output and error to ``log_dir/rank<r>.log``."""
    import torch.multiprocessing as mp
    from repro_torch.core.selfcheck import _rank_main
    p = p1 * p1 * p2
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(p1, p2, device, tmp, target, args,
                                 log_dir),
                           nprocs=p, join=True, start_method="spawn")
        out = []
        for r in range(p):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def run_grid(p1, p2, items, device, log_dir=None) -> list:
    """Run ``items`` ((check, case index) pairs) on a p1 x p1 x p2 grid;
    returns, per item, (check, index, rank 0's result, every rank's
    result).  ``log_dir`` as for :func:`spawn`."""
    from repro_torch.core import grid as gridlib
    if p1 * p1 * p2 == 1:
        grid = gridlib.make_trsm_mesh(1, 1, device=device)
        return [(n, i, r, [r]) for n, i, r in _run_items(grid, items)]
    from repro_torch.core.selfcheck import _run_items as run_items
    per_rank = spawn(p1, p2, device, run_items, items, log_dir=log_dir)
    return [(name, i, per_rank[0][j][2], [pr[j][2] for pr in per_rank])
            for j, (name, i) in enumerate(items)]


def _combine(res, ranks) -> tuple:
    """(ok, line): every rank's check passed and, where a cost trace was
    recorded, every rank recorded the same one."""
    ok = all(r["ok"] for r in ranks)
    line = res["line"]
    if not ok and res["ok"]:
        bad = [k for k, r in enumerate(ranks) if not r["ok"]]
        line += f" (FAIL on ranks {bad}: {ranks[bad[0]]['line']})"
    if res["cost"] is not None and any(r["cost"] != res["cost"]
                                       for r in ranks):
        ok = False
        line += " (cost traces differ across ranks: FAIL)"
    return ok, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", nargs="?", choices=sorted(CASES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--grid", help="P1,P2: run only this grid's cases")
    ap.add_argument("--out", help="write each case's result and cost here")
    args = ap.parse_args(argv)
    device = "cuda:0" if args.device == "cuda" else "cpu"
    names = [args.name] if args.name else list(CASES)
    by_grid: dict = {}
    for name in names:
        for i, case in enumerate(CASES[name]):
            by_grid.setdefault(tuple(case[:2]), []).append((name, i))
    if args.grid:
        want = tuple(int(v) for v in args.grid.split(","))
        by_grid = {g: v for g, v in by_grid.items() if g == want}
    fails = 0
    for (p1, p2), items in by_grid.items():
        log_dir = (os.path.join(args.out, f"ranks_{p1}_{p2}") if args.out
                   else None)
        try:
            rows = run_grid(p1, p2, items, device, log_dir)
        except Exception as e:                   # a rank failed or hung
            print(f"grid p1={p1} p2={p2}: FAIL ({type(e).__name__}: {e})")
            fails += len(items)
            continue
        for name, i, res, ranks in rows:
            ok, line = _combine(res, ranks)
            print(line, flush=True)
            fails += 0 if ok else 1
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                np.savez(os.path.join(args.out, f"{name}_{i}.npz"),
                         out=np.asarray(res["out"], np.float64), ok=ok,
                         cost=json.dumps(res["cost"]),
                         live=json.dumps(res["live"]))
    print(f"selfcheck: {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
