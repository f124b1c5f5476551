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
import json
import os
import sys

import numpy as np
import torch

from repro_torch.core.world import TIMEOUT_S, spawn  # noqa: F401


def random_tril(seed: int, n: int, dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n)))
    return (L + n * np.eye(n)).astype(dtype)


def rhs(seed: int, n: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, k))


def spd(seed: int, n: int) -> np.ndarray:
    """M M^T + n I for a seeded randn M: the reference's check_cholesky
    input."""
    M = np.random.default_rng(seed).standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


def lu_input(seed: int, n: int) -> np.ndarray:
    """randn + n I: the reference's check_lu input."""
    return np.random.default_rng(seed).standard_normal((n, n)) + n * np.eye(n)


def factor_seed(case) -> int:
    """The seed of a producer case's matrix, from its (p1, p2, n, n0)."""
    p1, p2, n, n0 = case
    return 1000 + 100 * p1 + 10 * p2 + n + n0


def structure_of(kind: str, n: int = 64):
    """The structured cases' structures at n0 = 16: "banded" a band of
    16 (at n0 = 16 the diagonal and the first subdiagonal blocks),
    "block_sparse" a 4 x 4 mask (n = 64) whose second column has no
    block below the diagonal (its update and both of its collectives
    are skipped), "full" every lower block (the dense program)."""
    from repro_torch.core.structure import FactorStructure
    if kind == "banded":
        return FactorStructure.banded(16)
    if kind == "full":
        return FactorStructure.block_sparse(np.tril(np.ones((4, 4), bool)))
    return FactorStructure.block_sparse(
        [[1, 0, 0, 0], [0, 1, 0, 0], [1, 0, 1, 0], [0, 0, 1, 1]])


def masked(L: np.ndarray, structure, n0: int) -> np.ndarray:
    """L with every element outside the structure's block mask zeroed:
    the operator a structured solve is held to."""
    bm = structure.block_mask(L.shape[-1], n0)
    return np.where(np.kron(bm, np.ones((n0, n0), bool)), L, 0.0)


# The reference selfcheck's cases (each leads with its grid (p1, p2)),
# then this package's: ``trsm`` (the one-shot core.trsm in its four
# operator variants), ``overlap`` (the pipelined programs against the
# sequential ones, bit for bit), ``face`` (phase 1's transposed faces
# are lower triangular in every mode) and ``serving`` (the fleet, both
# servers and the control plane over p > 1 ranks as at p = 1).
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
                (2, 2, "rec", 64, 8, 16), (1, 8, "rec", 64, 8, None),
                (2, 2, "inv", 64, 8, 16, "banded")],
    "face": [(2, 2, 64, 8, "alltoall"), (2, 2, 64, 16, "doubling"),
             (2, 2, 64, 16, "allgather"), (2, 1, 32, 8, "doubling"),
             (1, 2, 32, 8, "allgather")],
    "serving": [(2, 1, 32), (1, 2, 32)],
    # the reference's check_cholesky (its transpose cases, then
    # (p1, p2, n, n0)), check_lu, and check_bank's cyclic ingestion of
    # a distributed Cholesky piece
    "transpose": [(2, 2, 16, 32), (2, 1, 16, 8), (1, 2, 8, 16)],
    "cholesky": [(2, 2, 32, 8), (2, 1, 32, 16), (1, 2, 16, 8),
                 (2, 2, 64, 16)],
    "lu": [(2, 2, 32, 8), (2, 1, 32, 16), (1, 2, 16, 8), (2, 2, 64, 16)],
    "cyclic_ingest": [(2, 2)],
    # structured solves at p > 1 (n = 64, k = 16, n0 = 16): (structure,
    # method, precision); a structured capacity bank's lifecycle; a
    # structure that leaves out nothing builds the dense program; a
    # structured bank's bit contracts
    "structured": [(2, 2, "banded", "inv", None),
                   (2, 2, "banded", "inv", "bf16_refine"),
                   (2, 2, "banded", "rec", None),
                   (2, 2, "banded", "rec", "bf16_refine"),
                   (2, 2, "block_sparse", "inv", None),
                   (2, 2, "block_sparse", "inv", "bf16_refine"),
                   (2, 2, "block_sparse", "rec", None),
                   (2, 2, "block_sparse", "rec", "bf16_refine"),
                   (2, 1, "banded", "inv", None),
                   (2, 1, "block_sparse", "rec", "bf16_refine"),
                   (1, 2, "block_sparse", "inv", "bf16_refine"),
                   (1, 2, "banded", "rec", None)],
    "struct_capacity": [(2, 2, "inv", "bf16_refine"), (2, 2, "rec", None)],
    "struct_dense": [(2, 2)],
    "struct_bits": [(2, 2, "inv"), (2, 2, "rec"), (1, 2, "inv")],
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
    from repro_torch import api
    from repro_torch.core import precision as preclib
    from repro_torch.core.solver import SolveSpec, solver_for
    p1, p2, method, n, k, n0, *kind = case
    L, B = random_tril(n, n), rhs(k, n, k)
    st = None
    if kind:
        # the reference's banded case: L banded as its structure says,
        # one-shot and through Solver.from_factor (as the reference)
        st = structure_of(kind[0], n)
        ii = np.arange(n)
        L = L * (np.abs(ii[:, None] - ii[None, :]) < st.bandwidth)
    outs, banked = {}, {}
    for ov in ("on", "off"):
        spec = SolveSpec(n=n, k=k, grid=grid, policy=preclib.resolve(
            None, torch.float64), method=method,
            n0=n0 or _rec_n0(n, k, grid), overlap=ov, structure=st)
        prog = solver_for(spec)
        outs[ov] = prog.solve(prog.prep(torch.as_tensor(L)),
                              torch.as_tensor(B)).cpu().numpy()
        if st is not None:
            banked[ov] = api.Solver.from_factor(
                torch.as_tensor(L), grid, method=method, n0=n0,
                structure=st, overlap=ov).solve(
                    torch.as_tensor(B)).cpu().numpy()
    bit = outs["on"].tobytes() == outs["off"].tobytes()
    if banked:
        bit = bit and banked["on"].tobytes() == banked["off"].tobytes()
    err = np.abs(L @ outs["on"] - B).max()
    ok = bit and err < 1e-7
    return _result(f"overlap {method} p1={p1} p2={p2} n0={n0}"
                   f"{' ' + kind[0] if kind else ''}: "
                   f"bit-identical={bit} err={err:.2e} "
                   f"{'OK' if ok else 'FAIL'}", ok,
                   banked["on"] if banked else outs["on"])


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


def check_serving(grid, case):
    """The serving tier over p > 1 ranks against the same calls at
    p = 1 in this rank: the synchronous fleet and ``SolveServer``
    (SPMD; fp64 X within 1e-10), and ``AsyncSolveServer`` led by rank 0
    and followed by the others under one fake clock, in plain mode (a
    capacity bank: depth and deadline sheds, a streamed replace, evict
    and re-admit, stranded requests) and fleet mode (the Autoscaler's
    split and merge, streamed): every future's outcome, X within 1e-10
    (fp64), the stats and the replans the p = 1 run's, every rank's
    fleet state equal at stop, a follower's submit refused."""
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import cost_model, errors
    p1, p2, n = case
    one = api.make_trsm_mesh(1, 1, device=grid.device)
    machine = cost_model.tpu_v5e()
    lines, ok = [], True
    got = serving_sync(api, grid, machine, "dense", np.float64)
    want = serving_sync(api, one, machine, "dense", np.float64)
    gap = max(float(np.abs(g - w).max() / np.abs(w).max())
              for g, w in zip(got["x"], want["x"]))
    same = got["state"] == want["state"] and got["stats"] == want["stats"]
    ok = ok and gap <= 1e-10 and same
    lines.append(f"sync gap {gap:.1e} state={same}")
    leads = grid.mesh.rank == 0
    for mode in ("plain", "fleet"):
        got = serving_async(api, grid, machine, mode, np.float64,
                            leads=leads)
        states = [None] * grid.p
        dist.all_gather_object(states, got["state"])
        agree = all(st == states[0] for st in states)
        line = f"async {mode}: fleet states equal={agree}"
        if leads:
            want = serving_async(api, one, machine, mode, np.float64)
            same = (got["stats"] == want["stats"]
                    and got["replans"] == want["replans"]
                    and [f[0] for f in got["futures"]]
                    == [f[0] for f in want["futures"]])
            gap = max([float(np.abs(g[1] - w[1]).max()
                             / np.abs(w[1]).max())
                       for g, w in zip(got["futures"], want["futures"])
                       if g[0] == "ok"], default=0.0)
            agree = (agree and same and gap <= 1e-10
                     and got["bad"] == [ValueError, ValueError])
            line += (f" stats/replans/outcomes as p = 1: {same} gap "
                     f"{gap:.1e} served {got['stats']['served']} shed "
                     f"{got['stats']['shed']} stranded "
                     f"{got['stats']['stranded']} replans "
                     f"{len(got['replans'])}")
        else:
            agree = agree and got["refused"] is errors.ServingError
            line += f" follower submit refused={got['refused'] is not None}"
        ok = ok and agree
        lines.append(line)
    return _result(f"serving p1={p1} p2={p2} n={n}: {'; '.join(lines)} "
                   f"{'OK' if ok else 'FAIL'}", ok)


# ------------------------- the serving scenarios -------------------------
#
# The same calls through either package's api (``repro_torch.api`` on a
# grid of any p, or the reference's ``repro.api``): numpy inputs from
# SERVE_SEED, numpy outputs.  A p > 1 port grid runs the synchronous
# scenario in every rank alike and the async one led by rank 0.

SERVE_SEED = 260
SERVE_DISPATCH_S = 5e-5
# the synchronous scenarios: (manifest, panel width, block mask); at
# k = 16 the order-64 bucket plans "inv" at n0 = 32 on (2, 1) and (1, 2)
# alike, and the 2 x 2 mask leaves out its one off-diagonal block
SYNC_CASES = {"dense": ({32: 2, 16: 2}, 4, None),
              "structured": ({64: 2, 32: 2}, 16, ((1, 0), (0, 1)))}
ASYNC_K = 4


class ManualClock:
    """A clock that moves only when told to (the async scenarios'
    schedule; ``monotonic``/``sleep``, as the servers inject it)."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


def serving_factor(d: int, rng, dtype=np.float64) -> np.ndarray:
    L = np.tril(rng.standard_normal((d, d)))
    L[np.diag_indices(d)] = np.abs(L[np.diag_indices(d)]) + d
    return L.astype(dtype)


def _np64(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def _plan_row(plan) -> list:
    return [(b.n, b.capacity, b.method, b.n0, b.orders, b.counts,
             b.structure is not None) for b in plan.buckets]


def serving_sync(api, grid, machine, which: str, dtype) -> dict:
    """The synchronous fleet tier: ``plan_fleet`` of SYNC_CASES[which]
    (two tenants, one factor per order each: the bucket full), a
    ``SolveServer`` over the fleet, 12 requests of widths 1..k in two
    drains, a replace, a third tenant's admission reclaiming the
    coldest slot across tenants, 6 more requests.  Returns every X in
    drain order, the plan, the server's counts and (the port) the
    fleet's state."""
    man, k, mask = SYNC_CASES[which]
    rng = np.random.default_rng(SERVE_SEED)
    structure = None if mask is None else api.FactorStructure.block_sparse(
        np.asarray(mask, bool))
    plan = api.plan_fleet(man, grid, k=k, machine=machine,
                          dispatch_s=SERVE_DISPATCH_S, dtype=dtype,
                          structure=structure)
    fleet = api.SolverFleet(grid, plan)
    keys = []
    for tenant in ("a", "b"):
        for d in sorted(man, reverse=True):
            fleet.admit(serving_factor(d, rng, dtype), tenant=tenant,
                        tag=f"o{d}")
            keys.append((tenant, f"o{d}", d))
    server = api.SolveServer(fleet, k).warmup()
    xs = []

    def serve(count):
        for i in range(count):
            tenant, tag, d = keys[i % len(keys)]
            w = int(rng.integers(1, k + 1))
            server.submit(rng.standard_normal((d, w)).astype(dtype),
                          tenant=tenant, tag=tag)
        outs = server.drain()
        for key in sorted(outs):
            xs.extend(_np64(x) for x in outs[key])

    serve(6)
    serve(6)
    d0 = keys[0][2]
    fleet.replace(fleet.lookup("a", tag=keys[0][1]),
                  serving_factor(d0, rng, dtype))
    d1 = min(man)
    fleet.admit(serving_factor(d1, rng, dtype), tenant="c", tag="burst")
    live = {(h.tenant, h.tag) for h in fleet.handles()}
    keys = [key for key in keys if key[:2] in live] + [("c", "burst", d1)]
    serve(6)
    state = fleet.state() if hasattr(fleet, "state") else None
    return dict(x=xs, plan=_plan_row(plan), state=state,
                stats=(server.requests_served, server.waves_solved,
                       fleet.stats()["reclaims"]))


def serving_rank(grid) -> dict:
    """One rank's run of every serving scenario on a p > 1 grid, fp64
    on the tpu_v5e cost model (the planner's parity machine): the two
    synchronous ones in every rank alike, the two async ones led by
    rank 0 and followed by the others."""
    from repro_torch import api
    from repro_torch.core import cost_model
    machine = cost_model.tpu_v5e()
    out = {("sync", which): serving_sync(api, grid, machine, which,
                                         np.float64)
           for which in SYNC_CASES}
    for mode in ("plain", "fleet"):
        out[("async", mode)] = serving_async(
            api, grid, machine, mode, np.float64,
            leads=grid.mesh.rank == 0)
    out[("stress",)] = serving_stress(api, grid, machine)
    return out


def serving_stress(api, grid, machine) -> dict:
    """The leader's drain thread against two submit threads and an
    admitting thread at once, a short switch interval: a fleet of 6
    factors, full, so each of the third tenant's 6 admissions reclaims
    the slot the concurrent submits' lookups left coldest, streamed
    while the waves go out.  The leader returns its fleet state, the
    stats, each future's outcome and whether every thread finished; a
    follower its fleet state."""
    import collections
    import threading
    rng = np.random.default_rng(SERVE_SEED + 2)
    man = {32: 3, 16: 3}
    fleet = api.SolverFleet(grid, api.plan_fleet(
        man, grid, k=ASYNC_K, machine=machine, dispatch_s=SERVE_DISPATCH_S))
    tags = []
    for d, count in man.items():
        for i in range(count):
            fleet.admit(serving_factor(d, rng, np.float32), tenant=f"t{d}",
                        tag=f"f{i}")
            tags.append((d, f"t{d}", f"f{i}"))
    srv = api.AsyncSolveServer(fleet, ASYNC_K, queue_depth=256).warmup()
    if grid.mesh.rank != 0:
        srv.follow()
        return dict(state=fleet.state())
    futs, errors = [], []

    def producer(seed):
        r = np.random.default_rng(seed)
        for _ in range(60):
            d, tenant, tag = tags[int(r.integers(len(tags)))]
            try:
                futs.append(srv.submit(r.standard_normal((d, 1)),
                                       tenant=tenant, tag=tag))
            except KeyError:
                pass                 # displaced by a reclaim: a miss
            except Exception as e:
                errors.append(repr(e))

    def admitter():
        r = np.random.default_rng(SERVE_SEED + 3)
        for j in range(6):
            try:
                fleet.admit(serving_factor(16, r, np.float32), tenant="c",
                            tag=f"m{j}")
            except Exception as e:
                errors.append(repr(e))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv.start()
        threads = [threading.Thread(target=producer, args=(s,))
                   for s in (1, 2)] + [threading.Thread(target=admitter)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        finished = not any(t.is_alive() for t in threads)
        srv.stop()
    finally:
        sys.setswitchinterval(prev)
    outcomes = collections.Counter(
        type(f.exception(timeout=60)).__name__ for f in futs)
    return dict(state=fleet.state(), stats=srv.stats(), finished=finished,
                errors=errors, outcomes=dict(outcomes))


def _outcome(f) -> tuple:
    err = f.exception(timeout=0)
    if err is not None:
        return (type(err).__name__,)
    return ("ok", _np64(f.result(timeout=0)))


def _replans(scaler) -> list:
    def keys(ks):
        return sorted((k[0], k[1].name) for k in ks)
    return [(r["t"], r["kind"], r["moved"], r["pressure"], r["dispatch_s"],
             keys(r["opened"]), keys(r["closed"]), keys(r["rebuilt"]))
            for r in (scaler.replans if scaler is not None else ())]


def _drain(srv, clock, advance):
    for _ in range(1000):
        clock.sleep(advance)
        srv.step()
        if not srv.pending() and not srv._inflight:
            srv.flush()
            return
    raise AssertionError("the server did not drain in 1000 waves")


def serving_async(api, grid, machine, mode: str, dtype, *,
                  leads: bool = True) -> dict:
    """The async tier under one fake-clock schedule.  ``mode`` "plain":
    a capacity-3 bank of order 32 (n0 = 16), queue depth 4, SLO 2.5 ms:
    a wave per slot (the service estimate), then with an
    ``AdmissionController`` a burst that sheds at depth and at the
    deadline, a replace, two requests queued on a slot that is then
    evicted (stranded) and re-admitted, a drain, a request to the
    re-admitted slot.  ``mode`` "fleet":
    ``plan_fleet({32: 3, 16: 3})`` (one merged bucket), an
    ``Autoscaler``: a measured wave, a burst that splits the bucket
    (requests in flight re-keyed, none stranded), a drain, idle ticks
    that merge it back, one more request, a third tenant's admission
    reclaiming the coldest slot (by the submits' lookups), a request to
    every handle (the displaced one misses).  Through the port's api the
    leader also makes two mutations with a bad argument after the first
    wave (plain: an admit into the full bank, a replace with a
    non-square factor; fleet: a non-square admit into the full bucket,
    a replace with a non-square factor), each of which must raise
    before it is streamed.  The leader returns every future's outcome
    (the error's name, or "ok" and X), the stats, the replans, the
    fleet's state, what the bad mutations raised and the stream's
    message counts; a follower (``leads`` False, a p > 1 port grid)
    follows, and returns the state, what its submit raised and its
    stream's message counts."""
    from repro_torch.core import errors as port_errors
    rng = np.random.default_rng(SERVE_SEED + (mode == "fleet"))
    clock = ManualClock()
    scaler = None
    if mode == "plain":
        bank = api.FactorBank(grid, 32, n0=16, capacity=3, dtype=dtype)
        for _ in range(3):
            bank.admit(serving_factor(32, rng, dtype))
        owner = bank
        srv = api.AsyncSolveServer(api.Solver.from_bank(bank), ASYNC_K,
                                   queue_depth=4, slo_ms=2.5, clock=clock)
    else:
        man = {32: 3, 16: 3}
        plan = api.plan_fleet(man, grid, k=ASYNC_K, machine=machine,
                              dispatch_s=SERVE_DISPATCH_S, dtype=dtype)
        fleet = api.SolverFleet(grid, plan)
        for d, count in man.items():
            for i in range(count):
                fleet.admit(serving_factor(d, rng, dtype), tenant=f"t{d}",
                            tag=f"f{i}")
        owner = fleet
        srv = api.AsyncSolveServer(fleet, ASYNC_K, queue_depth=64,
                                   clock=clock)
    srv.warmup()

    def state():
        if mode == "fleet":
            return owner.state() if hasattr(owner, "state") else None
        return (owner.live_slots(), [owner.slot_generation(s)
                                     for s in range(3)])

    def messages():
        return dict(srv.stream.messages) if getattr(
            srv, "stream", None) is not None else None

    if not leads:
        try:
            srv.submit(np.zeros((32, 1), dtype))
            refused = None
        except port_errors.ServingError as e:
            refused = type(e)
        srv.follow()
        return dict(state=state(), refused=refused, messages=messages())
    futs, bad = [], []

    def bad_mutations(*calls):
        # the port checks every argument before it streams a mutation
        if not api.__name__.startswith("repro_torch"):
            return
        for call in calls:
            try:
                call()
                bad.append(None)
            except Exception as e:
                bad.append(type(e))

    def sub(b, **kw):
        try:
            futs.append(srv.submit(b.astype(dtype), **kw))
        except Exception as e:       # a depth shed raises at submit
            futs.append(e)

    if mode == "plain":
        for slot in range(3):
            sub(rng.standard_normal((32, 2)), factor=slot)
        _drain(srv, clock, 0.001)
        bad_mutations(lambda: bank.admit(np.eye(32, dtype=dtype)),
                      lambda: bank.replace(0, np.eye(32, dtype=dtype)[1:]))
        srv.set_admission(api.AdmissionController(machine=machine))
        for j in range(6):
            sub(rng.standard_normal((32, 1)), factor=0)
        for j in range(3):
            sub(rng.standard_normal((32, 4)), factor=1)
        clock.sleep(0.001)
        srv.step()
        bank.replace(1, serving_factor(32, rng, dtype))
        for _ in range(2):
            sub(rng.standard_normal((32, 1)), factor=2)
        bank.evict(2)
        bank.admit(serving_factor(32, rng, dtype))
        _drain(srv, clock, 0.001)
        sub(rng.standard_normal((32, 3)), factor=2)
        _drain(srv, clock, 0.001)
    else:
        scaler = api.Autoscaler(srv, machine=machine, dwell_s=0.5,
                                rate_alpha=1.0)
        sub(rng.standard_normal((32, 2)), tenant="t32", tag="f0")
        _drain(srv, clock, 0.001)
        bad_mutations(
            lambda: fleet.admit(np.eye(16, dtype=dtype)[1:], tenant="x"),
            lambda: fleet.replace(fleet.handles("t16")[0],
                                  np.eye(16, dtype=dtype)[1:]))
        scaler.observe(now=clock.monotonic())
        for j in range(20):
            for d, i in ((32, 0), (32, 1), (32, 2), (16, 0), (16, 1),
                         (16, 2)):
                sub(rng.standard_normal((d, 4)), tenant=f"t{d}",
                    tag=f"f{i}")
        clock.sleep(0.01)
        scaler.tick(now=clock.monotonic())
        _drain(srv, clock, 0.001)
        for _ in range(5):
            clock.sleep(5.0)
            if scaler.tick(now=clock.monotonic()) is not None:
                break
        sub(rng.standard_normal((16, 1)), tenant="t16", tag="f1")
        _drain(srv, clock, 0.001)
        # a third tenant's admission reclaims the slot the submits'
        # lookups left coldest; the displaced tenant's lookup then misses
        fleet.admit(serving_factor(16, rng, dtype), tenant="c", tag="burst")
        for d, i in ((32, 0), (32, 1), (32, 2), (16, 0), (16, 1), (16, 2)):
            sub(rng.standard_normal((d, 1)), tenant=f"t{d}", tag=f"f{i}")
        sub(rng.standard_normal((16, 2)), tenant="c", tag="burst")
        _drain(srv, clock, 0.001)
    stats = srv.stats()
    srv.stop()
    return dict(futures=[(type(f).__name__,) if isinstance(f, Exception)
                         else _outcome(f) for f in futs],
                stats=stats, replans=_replans(scaler), state=state(),
                bad=bad, messages=messages())


def check_transpose(grid, case):
    """The cyclic-storage transpose (``cholesky.transpose_fn``): each
    rank's piece of A^T from its piece of A, A^T exactly."""
    from repro_torch.core import cholesky
    from repro_torch.core import grid as gridlib
    p1, p2, mr, nc = case
    A = np.random.default_rng(mr * nc + p1).standard_normal((mr, nc))
    piece = gridlib.local_piece(torch.as_tensor(A), grid, "L")
    T, cost = _traced(lambda: gridlib.gather_natural(
        cholesky.transpose_fn(grid, mr, nc)(piece), grid, "L", nc, mr))
    ok = np.array_equal(T, A.T)
    return _result(f"transpose p1={p1} p2={p2} {mr}x{nc}: "
                   f"{'OK' if ok else 'FAIL'}", ok, T, cost)


def _p1_grid(grid):
    from repro_torch.core import grid as gridlib
    return gridlib.make_trsm_mesh(1, 1, device=grid.device)


def check_cholesky(grid, case):
    """The reference's check_cholesky: ``cholesky.cholesky`` on the
    grid, max |L L^T - A| < 1e-8, L lower triangular, and within 1e-10
    of the p = 1 factorization; the cyclic output is this rank's piece
    of it."""
    from repro_torch.core import cholesky
    p1, p2, n, n0 = case
    A = spd(factor_seed(case), n)
    L, cost = _traced(lambda: cholesky.cholesky(torch.as_tensor(A), grid,
                                                n0))
    err = np.abs(L @ L.T - A).max()
    L1 = cholesky.cholesky(torch.as_tensor(A), _p1_grid(grid), n0)
    gap = _rel_gap(L, L1.cpu().numpy())
    from repro_torch.core import grid as gridlib
    piece = cholesky.cholesky_cyclic(torch.as_tensor(A), grid, n0)
    same = torch.equal(piece.cpu(), gridlib.local_piece(
        torch.as_tensor(L), grid, "L").cpu())
    ok = err < 1e-8 and not np.triu(L, 1).any() and gap <= 1e-10 and same
    return _result(f"cholesky p1={p1} p2={p2} n={n} n0={n0}: err={err:.2e} "
                   f"vs-p=1={gap:.1e} piece={same} "
                   f"{'OK' if ok else 'FAIL'}", ok, L, cost)


def check_lu(grid, case):
    """The reference's check_lu: ``lu.lu`` on the grid, max |L U - A| <
    1e-8, L unit lower and U upper triangular, within 1e-10 of the p = 1
    factorization.  ``out`` stacks L and U."""
    from repro_torch.core import lu
    p1, p2, n, n0 = case
    A = lu_input(factor_seed(case), n)
    LU, cost = _traced(lambda: torch.stack(lu.lu(torch.as_tensor(A), grid,
                                                 n0)))
    L, U = LU
    err = np.abs(L @ U - A).max()
    LU1 = torch.stack(lu.lu(torch.as_tensor(A), _p1_grid(grid), n0))
    gap = _rel_gap(LU, LU1.cpu().numpy())
    shape = (not np.triu(L, 1).any() and not np.tril(U, -1).any()
             and np.array_equal(np.diag(L), np.ones(n)))
    ok = err < 1e-8 and shape and gap <= 1e-10
    return _result(f"lu p1={p1} p2={p2} n={n} n0={n0}: err={err:.2e} "
                   f"vs-p=1={gap:.1e} {'OK' if ok else 'FAIL'}", ok, LU, cost)


def check_cyclic_ingest(grid, case):
    """The reference's check_bank cyclic ingestion: each rank's piece of
    ``cholesky_cyclic(A)`` admitted (``admit_cyclic``; also by
    ``replace_cyclic`` into a capacity bank), relres < 1e-10 against
    the natural ``cholesky(A)``."""
    from repro_torch import api
    from repro_torch.core import cholesky
    p1, p2 = case
    n, k = BANK_N, BANK_K
    L0 = random_tril(20, n)
    A = torch.as_tensor(L0 @ L0.T)
    piece = cholesky.cholesky_cyclic(A, grid)
    bank = api.FactorBank(grid, n, n0=BANK_N0, dtype=torch.float64)
    bank.admit_cyclic(piece)
    cap = api.FactorBank(grid, n, n0=BANK_N0, dtype=torch.float64,
                         capacity=2)
    cap.admit(torch.as_tensor(L0))
    cap.replace_cyclic(0, piece)
    B = rhs(22, n, k)
    X = api.Solver.from_bank(bank).solve(torch.as_tensor(B)[None])[0]
    X = X.cpu().numpy()
    Bc = np.zeros((2, n, k))
    Bc[0] = B
    Xc = api.Solver.from_bank(cap).solve(torch.as_tensor(Bc))[0].cpu()
    L = cholesky.cholesky(A, grid).cpu().numpy()
    rel = _relres(L, X, B)
    ok = rel < 1e-10 and _rel_gap(Xc.numpy(), X) <= 1e-12
    return _result(f"cyclic_ingest p1={p1} p2={p2}: relres={rel:.2e} "
                   f"{'OK' if ok else 'FAIL'}", ok, X)


STRUCT_N, STRUCT_K, STRUCT_N0 = 64, 16, 16


def _struct_inputs(precision, seed: int = 31):
    dt = np.float32 if precision else np.float64
    L = random_tril(seed, STRUCT_N, dt)
    B = rhs(seed + 1, STRUCT_N, STRUCT_K).astype(dt)
    return L, B


def check_structured(grid, case):
    """A structured ``Solver.from_factor`` at p > 1 (n = 64, k = 16, n0
    = 16; L unmasked, so admission's mask is what makes it structured):
    relres against the MASKED operator within 1e-10 (fp64) or 1e-5
    (bf16_refine), the gap to the p = 1 structured solve of the same
    inputs (1e-10 in fp64), the steady state; "inv" stages fewer words
    than the dense solve of the same factor (its narrowed panels).
    ``cost`` is the solve part of the trace (every pass's sweep or
    recursion); a refining preset's ``"residual"`` part is its passes'
    mm3d products (``cost_model.mm_cost``)."""
    from repro_torch import api
    from repro_torch.core import cost_model
    from repro_torch.core import precision as preclib
    p1, p2, kind, method, precision = case
    n, k, n0 = STRUCT_N, STRUCT_K, STRUCT_N0
    st = structure_of(kind, n)
    L, B = _struct_inputs(precision)
    Lm = masked(L.astype(np.float64), st, n0)
    kw = dict(method=method, n0=n0, precision=precision)
    solver = api.Solver.from_factor(torch.as_tensor(L), grid, structure=st,
                                    **kw)
    X, cost, res = _traced_parts(lambda: solver.solve(torch.as_tensor(B)))
    rel = _relres(Lm, X, B.astype(np.float64))
    (x2,), steady = _steady(solver, [torch.as_tensor(B)])
    X1 = api.Solver.from_factor(torch.as_tensor(L), _p1_grid(grid),
                                structure=st, **kw).solve(
        torch.as_tensor(B)).cpu().double().numpy()
    gap = _rel_gap(X, X1)
    ok = (rel < (1e-5 if precision else 1e-10) and steady
          and np.array_equal(X, x2)
          and (precision is not None or gap <= 1e-10))
    pol = preclib.resolve(precision, None if precision else torch.float64)
    if pol.refines:
        mm = cost_model.mm_cost(n, -(-k // grid.p) * grid.p, grid.p, p1, p2)
        ok = ok and (res["s"], res["w"]) == (pol.refine_steps * mm.s,
                                             pol.refine_steps * mm.w)
    fewer = ""
    if method == "inv":
        dense = api.Solver.from_factor(torch.as_tensor(L), grid, **kw)
        _, dcost, _ = _traced_parts(lambda: dense.solve(torch.as_tensor(B)))
        ok = ok and cost["w"] < dcost["w"]
        fewer = f" W={cost['w']:.0f}<dense {dcost['w']:.0f}"
    return _result(f"structured {kind} {method} p1={p1} p2={p2} "
                   f"{precision or 'fp64'}: relres={rel:.2e} "
                   f"vs-p=1={gap:.1e}{fewer} "
                   f"{'OK' if ok else 'FAIL'}", ok, X, cost)


def check_struct_capacity(grid, case):
    """A structured (banded) C = 4 capacity bank's lifecycle at p > 1
    (``capacity_script``: admits, a padded admission, replace, a
    replace_run, evict, re-admit): every live slot's relres against the
    MASKED factor it held within the bound, dead lanes and padded
    tails exactly zero, the solve program built once.  ``out`` is the
    last wave's X (``live`` flags the slots compared with the
    reference)."""
    from repro_torch import api
    from repro_torch.core import session
    p1, p2, method, precision = case
    n, d = BANK_N, BANK_N // 2
    st = structure_of("banded", n)
    dt = np.float32 if precision else np.float64
    bank = api.FactorBank(grid, n, method=method, n0=BANK_N0,
                          dtype=None if precision else torch.float64,
                          precision=precision, capacity=4, structure=st)
    waves = capacity_script(
        bank, n, d, 50, dt, lambda bank, B: api.Solver.from_bank(bank).solve(
            torch.as_tensor(B)).cpu().double().numpy())
    key = api.Solver.from_bank(bank).spec_for(BANK_K)
    bound = 1e-5 if precision else 1e-10
    worst, zeros = 0.0, True
    for B, X, live, held in waves:
        for s in range(bank.capacity):
            if s not in live:
                zeros = zeros and not np.any(X[s])
                continue
            L, pad = held[s]
            Lm = masked(L.astype(np.float64), st, BANK_N0)
            worst = max(worst, _relres(Lm, X[s], B[s]))
            if pad:
                zeros = zeros and not np.any(X[s, d:])
    ok = worst < bound and zeros and session.BUILD_COUNTS[key] == 1
    res = _result(f"struct_capacity {method} p1={p1} p2={p2} "
                  f"{precision or 'fp64'}: relres={worst:.2e} "
                  f"dead-and-tails-zero={zeros} {'OK' if ok else 'FAIL'}",
                  ok, waves[-1][1])
    res["live"] = list(waves[-1][2])
    return res


def check_struct_dense(grid, case):
    """``structure=dense`` is the unstructured spec, and a block-sparse
    mask that keeps every lower block builds the unstructured program:
    the same X, bit for bit ("inv" and "rec", fp64 and bf16_refine)."""
    from repro_torch import api
    p1, p2 = case
    lines, ok = [], True
    for method in ("inv", "rec"):
        for precision in (None, "bf16_refine"):
            L, B = _struct_inputs(precision, seed=41)
            kw = dict(method=method, n0=STRUCT_N0, precision=precision)
            outs = [api.Solver.from_factor(torch.as_tensor(L), grid,
                                           structure=st, **kw).solve(
                torch.as_tensor(B)) for st in
                (None, api.FactorStructure.dense(),
                 structure_of("full", STRUCT_N))]
            bit = all(torch.equal(o, outs[0]) for o in outs[1:])
            ok = ok and bit
            lines.append(f"{method} {precision or 'fp64'} bit-equal={bit}")
    return _result(f"struct_dense p1={p1} p2={p2}: {'; '.join(lines)} "
                   f"{'OK' if ok else 'FAIL'}", ok)


def check_struct_bits(grid, case):
    """A structured (banded) bf16_refine capacity bank of 3 factors at
    p > 1, its residuals on B4: "scan" gives "vmap"'s bits and overlap
    on gives off's; and the padded identity: an order-64 factor padded
    into a structured order-128 bank solves its leading rows bit for
    bit as an unpadded order-64 structured bank (its phase 1 on the
    all-gather), the tail exactly zero."""
    from repro_torch import api
    p1, p2, method = case
    st = structure_of("banded", BANK_N)
    n, d = 2 * BANK_N, BANK_N
    L = random_tril(d + 3, d, np.float32)
    b = rhs(d + 4, d, BANK_K).astype(np.float32)
    Xs = {}
    for order in (n, d):
        # the unpadded bank's phase 1 on the all-gather: B1 on the same
        # blocks (check_padded)
        mode = "allgather" if method == "inv" and order == d else None
        bank = api.FactorBank(grid, order, method=method, n0=BANK_N0,
                              precision="bf16_refine", capacity=2,
                              structure=st, mode=mode)
        bank.admit(torch.as_tensor(L), pad_to=order if order > d else None)
        Bp = np.zeros((2, order, BANK_K), np.float32)
        Bp[0, :d] = b
        Xs[order] = api.Solver.from_bank(bank).solve(torch.as_tensor(Bp))[0]
    padded = torch.equal(Xs[n][:d], Xs[d]) and not torch.any(Xs[n][d:])
    Ls, B = _bank_inputs("bf16_refine")
    outs = {}
    for map_mode, overlap in (("vmap", "on"), ("scan", "on"),
                              ("vmap", "off")):
        solver = api.Solver.from_factors(
            torch.as_tensor(Ls), grid, method=method, n0=BANK_N0,
            precision="bf16_refine", map_mode=map_mode, overlap=overlap,
            capacity=BANK_M, structure=st)
        outs[(map_mode, overlap)] = solver.solve(torch.as_tensor(B))
    ref = outs[("vmap", "on")]
    scan = torch.equal(outs[("scan", "on")], ref)
    off = torch.equal(outs[("vmap", "off")], ref)
    ok = scan and off and padded
    return _result(f"struct_bits {method} p1={p1} p2={p2}: "
                   f"scan==vmap={scan} overlap-off==on={off} "
                   f"padded-bit-equal={padded} {'OK' if ok else 'FAIL'}", ok)


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
       "serving": check_serving, "session": check_session,
       "session_refine": check_session_refine, "bank": check_bank,
       "cyclic": check_cyclic, "capacity": check_capacity,
       "padded": check_padded, "bank_bits": check_bank_bits,
       "transpose": check_transpose, "cholesky": check_cholesky,
       "lu": check_lu, "cyclic_ingest": check_cyclic_ingest,
       "structured": check_structured,
       "struct_capacity": check_struct_capacity,
       "struct_dense": check_struct_dense, "struct_bits": check_struct_bits}


def _run_items(grid, items):
    return [(name, i, RUN[name](grid, CASES[name][i])) for name, i in items]


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
