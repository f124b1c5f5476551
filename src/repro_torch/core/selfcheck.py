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
}
VARIANTS = ((True, False), (False, False), (True, True), (False, True))


def _traced(fn):
    """(fn's result as float64 numpy, its recorded cost trace)."""
    from repro_torch.core import comm
    with comm.trace() as t:
        out = fn()
    cost = dict(t.summary(), by_op=t.by_op())
    return np.asarray(out.detach().cpu().double()), cost


def _result(line, ok, out=None, cost=None):
    return dict(line=line, ok=bool(ok), out=out, cost=cost)


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
    """A refinement preset, a resident factor, a bank and a fleet on a
    p > 1 grid raise NotImplementedError naming the next slice."""
    from repro_torch import api, core
    p1, p2, n, k, n0 = case
    L, B = random_tril(n, n), rhs(7, n, k)
    attempts = {
        "bf16_refine": lambda: core.trsm(
            torch.as_tensor(L, dtype=torch.float32), torch.as_tensor(B),
            grid, n0=n0, precision="bf16_refine"),
        "from_factor": lambda: api.Solver.from_factor(torch.as_tensor(L),
                                                      grid, n0=n0),
        "bank": lambda: api.FactorBank(grid, n, n0=n0),
        "fleet": lambda: api.SolverFleet(grid, api.plan_fleet({n: 1}, grid,
                                                              k=k)),
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


RUN = {"order": check_order, "mm3d": check_mm3d, "tri_inv": check_tri_inv,
       "doubling": check_doubling, "it_inv_trsm": check_it_inv_trsm,
       "rec_trsm": check_rec_trsm, "trsm": check_trsm,
       "overlap": check_overlap, "face": check_face,
       "deferred": check_deferred}


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
                         cost=json.dumps(res["cost"]))
    print(f"selfcheck: {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
