"""The serving tier over p > 1 ranks (``SolverFleet``, ``SolveServer``,
``AsyncSolveServer`` and the control plane on torch.distributed) held
against the reference and against the port's own p = 1 run, on the CPU.

The scenarios are ``repro_torch.core.selfcheck``'s (``serving_sync``,
``serving_async``): the same calls through either package's api, numpy
inputs from one seed, fp64, planned on the tpu_v5e cost model (the
planner's parity machine).

* The reference runs in one subprocess over 8 forced host devices on
  make_trsm_mesh(2, 1) and (1, 2), single-controller, with its banks'
  phase 1 through the Pallas kernel hook (its default phase 1 fails on
  jax 0.9, ROADMAP C), patched in that process only.
* The port runs one subprocess per grid of gloo ranks on the CPU
  (``selfcheck.spawn`` of ``selfcheck.serving_rank``): the synchronous
  scenarios in every rank alike (SPMD), the async ones led by rank 0
  and followed by the others (``AsyncSolveServer.follow``).
* The port's p = 1 run of the same scenarios runs in this process.

The synchronous fleet and ``SolveServer``, dense and with one
structured "inv" bucket: the plan, the served counts and every X
against the reference's (2e-5 where a bucket is "inv": the reference's
fp64 "inv" bank through the hook is fp32-grade at p > 1; 1e-10 where
all are "rec") and against the p = 1 server's (1e-10), every rank's X
the same bits and its fleet state the p = 1 one.  The async tier under
one fake clock, plain (depth and deadline sheds, a streamed replace,
evict and re-admit, stranded requests) and fleet mode (the Autoscaler's
split and merge, a cross-tenant reclaim after the submits' lookups):
every future's outcome, X, ``stats()`` and the replans equal to the
reference's and the p = 1 run's, every rank's fleet state equal at
stop, a follower's submit refused, a leader's mutation with a bad
argument refused before it is streamed.  The leader's drain thread against
concurrent submit and admitting threads keeps every rank's fleet state
the leader's (``serving_stress``).  The CLI serves its five trsm
workloads at ``--p1 2 --p2 1`` on the CPU, and under a launcher without
a card it asks for ``--device cpu``.

One deadline (``DEADLINE_S``) bounds the module's subprocesses; a
timeout kills a subprocess's whole session, ranks included, and the
ranks' collectives time out well before it (``selfcheck.TIMEOUT_S``).
"""

import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.core import selfcheck
from torch_parity import assert_close

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRIDS = [(2, 1), (1, 2)]
DEADLINE_S = 300
MODES = ("plain", "fleet")

REFERENCE = r'''
import functools, pickle, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro import api
from repro.core import cost_model, fleet
from repro.kernels import ops
from repro_torch.core import selfcheck

fleet.FactorBank = functools.partial(fleet.FactorBank,
                                     block_inv=ops.block_inv_kernel)
api.FactorBank = functools.partial(api.FactorBank,
                                   block_inv=ops.block_inv_kernel)
out = {}
for p1, p2 in ((2, 1), (1, 2)):
    grid = api.make_trsm_mesh(p1, p2)
    machine = cost_model.tpu_v5e()
    for which in selfcheck.SYNC_CASES:
        out[(p1, p2, "sync", which)] = selfcheck.serving_sync(
            api, grid, machine, which, np.float64)
    for mode in ("plain", "fleet"):
        out[(p1, p2, "async", mode)] = selfcheck.serving_async(
            api, grid, machine, mode, np.float64)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''

PORT = r'''
import pickle, sys
from repro_torch.core import selfcheck
p1, p2 = int(sys.argv[2]), int(sys.argv[3])
ranks = selfcheck.spawn(p1, p2, "cpu", selfcheck.serving_rank)
with open(sys.argv[1], "wb") as f:
    pickle.dump(ranks, f)
'''


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(args, log, **env):
    with open(log, "w") as f:
        return subprocess.Popen(args, stdout=f, stderr=subprocess.STDOUT,
                                env=_env(**env), start_new_session=True)


def _finish(proc, log, out, timeout):
    """The pickled result of ``proc``, or a failure carrying its log."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        return None, f"killed at the deadline\n{log.read_text()[-4000:]}"
    if proc.returncode or not out.exists():
        return None, f"exit {proc.returncode}\n{log.read_text()[-4000:]}"
    with open(out, "rb") as f:
        return pickle.load(f), None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results by (p1, p2, kind, case), its failure),
    {grid: (every rank's results, failure)}, the port's p = 1 results by
    (kind, case), all within ``DEADLINE_S``."""
    from repro_torch import api
    from repro_torch.core import cost_model
    deadline = time.monotonic() + DEADLINE_S

    def left():
        return max(deadline - time.monotonic(), 1.0)

    tmp = tmp_path_factory.mktemp("serving")
    ref = _start([sys.executable, "-c", REFERENCE, str(tmp / "ref.pkl")],
                 tmp / "ref.log",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu")
    try:
        port = {}
        for p1, p2 in GRIDS:
            out = tmp / f"port_{p1}_{p2}.pkl"
            log = tmp / f"port_{p1}_{p2}.log"
            port[(p1, p2)] = _finish(_start(
                [sys.executable, "-c", PORT, str(out), str(p1), str(p2)],
                log), log, out, left())
        one = api.make_trsm_mesh(1, 1, device="cpu")
        machine = cost_model.tpu_v5e()
        p1_runs = {("sync", w): selfcheck.serving_sync(
            api, one, machine, w, np.float64) for w in selfcheck.SYNC_CASES}
        for mode in MODES:
            p1_runs[("async", mode)] = selfcheck.serving_async(
                api, one, machine, mode, np.float64)
        reference = _finish(ref, tmp / "ref.log", tmp / "ref.pkl", left())
    finally:
        if ref.poll() is None:
            os.killpg(ref.pid, signal.SIGKILL)
            ref.wait()
    return reference, port, p1_runs


def _ranks(runs, grid):
    ranks, failure = runs[1][grid]
    assert failure is None, f"the port's ranks on {grid} failed: {failure}"
    return ranks


def _reference(runs, grid, kind, case):
    results, failure = runs[0]
    assert failure is None, f"the reference failed: {failure}"
    return results[(*grid, kind, case)]


def _gap(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


SYNC = [pytest.param(g, w, id=f"{g[0]}x{g[0]}x{g[1]}-{w}")
        for g in GRIDS for w in selfcheck.SYNC_CASES]
ASYNC = [pytest.param(g, m, id=f"{g[0]}x{g[0]}x{g[1]}-{m}")
         for g in GRIDS for m in MODES]


@pytest.mark.parametrize("grid,which", SYNC)
def test_sync_fleet_matches_reference(runs, grid, which):
    """The plan, the served requests, waves and reclaims, and every X
    against the reference's ``SolverFleet`` + ``SolveServer`` on the
    same grid."""
    got = _ranks(runs, grid)[0][("sync", which)]
    want = _reference(runs, grid, "sync", which)
    assert got["plan"] == want["plan"]
    assert got["stats"] == want["stats"]
    assert len(got["x"]) == len(want["x"])
    tol = 1e-10 if all(b[2] == "rec" for b in got["plan"]) else 2e-5
    for x, w in zip(got["x"], want["x"]):
        assert_close(x, w, tol)


@pytest.mark.parametrize("grid,which", SYNC)
def test_sync_fleet_matches_p1(runs, grid, which):
    """Every rank's X within 1e-10 of the port's p = 1 server on the same
    calls, the same bits in every rank, and each rank's fleet state
    (handles, generations, LRU stamps, admits, reclaims) the p = 1
    fleet's."""
    ranks = _ranks(runs, grid)
    want = runs[2][("sync", which)]
    for r in ranks:
        got = r[("sync", which)]
        assert got["stats"] == want["stats"]
        assert got["state"] == want["state"]
        for x, w, x0 in zip(got["x"], want["x"], ranks[0][("sync", which)]
                            ["x"]):
            assert _gap(x, w) <= 1e-10
            assert np.array_equal(x, x0)


@pytest.mark.parametrize("grid,mode", ASYNC)
def test_async_matches_reference(runs, grid, mode):
    """The leader's futures (their outcomes: served, shed at depth or
    at the deadline, stranded, a lookup miss), X, ``stats()`` and the
    Autoscaler's replans against the reference's single-controller
    server under the same fake-clock schedule."""
    got = _ranks(runs, grid)[0][("async", mode)]
    want = _reference(runs, grid, "async", mode)
    assert [f[0] for f in got["futures"]] == [f[0] for f in want["futures"]]
    for f, w in zip(got["futures"], want["futures"]):
        if f[0] == "ok":
            assert_close(f[1], w[1], 2e-5)
    assert got["stats"] == want["stats"]
    assert len(got["replans"]) == len(want["replans"])
    for r, w in zip(got["replans"], want["replans"]):
        assert r[:3] == w[:3] and r[5:] == w[5:]
        assert r[3] == pytest.approx(w[3], rel=1e-12)
        assert r[4] == pytest.approx(w[4], rel=1e-12, abs=1e-18)


@pytest.mark.parametrize("grid,mode", ASYNC)
def test_async_matches_p1(runs, grid, mode):
    """The same schedule at p = 1: the same outcomes, stats and replans,
    X within 1e-10."""
    got = _ranks(runs, grid)[0][("async", mode)]
    want = runs[2][("async", mode)]
    assert [f[0] for f in got["futures"]] == [f[0] for f in want["futures"]]
    for f, w in zip(got["futures"], want["futures"]):
        if f[0] == "ok":
            assert _gap(f[1], w[1]) <= 1e-10
    assert got["stats"] == want["stats"]
    assert got["replans"] == want["replans"]
    if mode == "plain":
        st = got["stats"]
        assert st["shed"] > st["tenants"]["default"]["deadline_shed"] > 0
        assert st["stranded"] > 0
    else:
        assert [r[1] for r in got["replans"]] == ["split", "merge"]
        assert "KeyError" in [f[0] for f in got["futures"]]


@pytest.mark.parametrize("grid,mode", ASYNC)
def test_async_followers_hold_the_leaders_state(runs, grid, mode):
    """At stop every rank's fleet (or bank) state equals the leader's and
    the p = 1 run's (the streamed LRU touches made every reclaim pick
    the same slot), and a follower's submit raised ``ServingError``."""
    from repro_torch.core import errors
    ranks = _ranks(runs, grid)
    lead = ranks[0][("async", mode)]
    assert lead["state"] == runs[2][("async", mode)]["state"]
    for r in ranks[1:]:
        got = r[("async", mode)]
        assert got["state"] == lead["state"]
        assert got["refused"] is errors.ServingError


@pytest.mark.parametrize("grid,mode", ASYNC)
def test_async_bad_mutation_raises_before_it_is_streamed(runs, grid, mode):
    """A mutation with a bad argument on the started leader (plain: an
    admit into the full bank, a non-square replace; fleet: a non-square
    admit into the full bucket, a non-square replace) raises
    ``ValueError`` before anything is streamed: no MUTATE goes out for
    it (the three that do are the scenario's valid mutations), every
    follower receives the same messages as the leader sent and keeps
    following to the STOP, and every rank's state is the leader's and
    the p = 1 run's, which made the same refused calls."""
    ranks = _ranks(runs, grid)
    lead = ranks[0][("async", mode)]
    one = runs[2][("async", mode)]
    assert lead["bad"] == one["bad"] == [ValueError, ValueError]
    assert lead["messages"]["mutate"] == 3
    assert lead["messages"]["stop"] == 1
    assert lead["state"] == one["state"]
    for r in ranks[1:]:
        got = r[("async", mode)]
        assert got["messages"] == lead["messages"]
        assert got["state"] == lead["state"]


def test_launched_cli_without_a_card_needs_device_cpu(monkeypatch, capsys):
    """Under a launcher (``WORLD_SIZE``/``RANK`` set) with no CUDA device
    and no ``--device``, the CLI stops with "no CUDA device" before it
    joins any world, as its spawning path does; ``world.join`` raises
    the same way: neither falls back to the CPU unasked."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import world
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit) as exc:
        serve.main(["--workload", "trsm", "--n", "64", "--p1", "2",
                    "--p2", "1"])
    assert exc.value.code == 2
    assert "no CUDA device: pass --device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        world.join(2, 1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("grid", [pytest.param(g, id=f"{g[0]}x{g[0]}x{g[1]}")
                                  for g in GRIDS])
def test_async_stress_keeps_the_ranks_in_step(runs, grid):
    """The leader's drain thread, two submit threads and an admitting
    thread at once (``selfcheck.serving_stress``, a short switch
    interval): every thread finishes, every future resolves (served,
    or stranded by a reclaim), the counts conserve, and every rank's
    fleet state equals the leader's at stop: a lookup's LRU touch that
    missed the stream would make a follower reclaim another slot."""
    ranks = _ranks(runs, grid)
    lead = ranks[0][("stress",)]
    assert lead["finished"] and not lead["errors"]
    st = lead["stats"]
    assert st["submitted"] == st["served"] + st["stranded"] > 0
    assert st["pending"] == st["inflight"] == 0
    assert set(lead["outcomes"]) <= {"NoneType", "StrandedRequestError"}
    assert lead["state"]["reclaims"] == 6
    for r in ranks[1:]:
        assert r[("stress",)]["state"] == lead["state"]


CLI = ["trsm", "trsm-bank", "trsm-churn", "trsm-fleet", "trsm-traffic"]


@pytest.mark.parametrize("workload", CLI)
def test_cli_serves_every_trsm_workload_at_p_gt_1(capsys, workload):
    """``--p1 2 --p2 1 --device cpu``: the CLI starts its 4 gloo ranks,
    serves the workload, and rank 0 prints the reference's summary line
    with the grid; ``trsm-fleet`` serves the requests, bucket-waves and
    reclaims the p = 1 run serves."""
    import re

    from repro_torch.launch import serve
    flags = ["--workload", workload, "--n", "64", "--requests", "24",
             "--updates", "6", "--bank", "4", "--panel-k", "4",
             "--device", "cpu"]
    serve.main(flags + ["--p1", "2", "--p2", "1"])
    out = capsys.readouterr().out
    assert "on grid p1=2 p2=1 (cpu)" in out
    served = {"trsm-traffic": "served 24/24 open-loop requests",
              "trsm-fleet": "served 24 mixed-order requests"}
    assert served.get(workload, "served 24 solve requests") in out
    if workload == "trsm-fleet":
        serve.main(flags)
        one = capsys.readouterr().out

        def counts(text):
            m = re.search(r"served (\d+) mixed-order requests .* in (\d+) "
                          r"bucket-waves, .* (\d+) cross-tenant reclaims",
                          text)
            return m.groups()
        assert counts(out) == counts(one)
