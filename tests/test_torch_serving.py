"""The open-loop async tier (DESIGN.md Sec. 13) of the port against the
JAX package's, on the CPU: ``repro_torch.core.serving`` beside
``repro.core.serving``.

The counterparts of the 26 tests of tests/test_async_serving.py, run
on the port; the deterministic ones also drive the reference with the
same numpy factors and right-hand sides under their own fake clock and
hold the two against each other: the same pushes give the same
``FairQueue`` waves and the same virtual-finish stamps, the same
submits give the same wave compositions, completion stamps and typed
strandings, and the futures' X agree within the reference's fp32
tolerance (2e-5 of the solution's scale, ``torch_parity``; each served
request also within the reference's residual bound, 1e-4).  The
reference's banks pass ``block_inv=repro.kernels.ops.block_inv_kernel``
and its fleet is patched as ``tests/test_torch_fleet.py`` patches it:
its default phase 1 fails on jax 0.9.  Fleet plans get an explicit
``cost_model.tpu_v5e()`` and ``dispatch_s`` on both sides: the
reference's default machine is calibrated, the port's is the H100
preset.  Everything except the lifecycle and stress tests runs with
no thread and no wall-clock: the ``fake_clock`` fixture and a
``DrainDriver`` (tests/conftest.py) step the waves by hand.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import cost_model as jcm
from repro.core import fleet as jfleet
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.core import cost_model as cm
from repro_torch.core import session
from repro_torch.core.serving import FairQueue, _Request
from torch_parity import FairQueuePair, assert_close

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = japi.make_trsm_mesh(1, 1)
TOL = 2e-5
RELRES = 1e-4


@pytest.fixture
def jref(monkeypatch):
    """The reference's fleet with the kernel phase 1 hook in its banks
    (its default phase 1 fails on jax 0.9)."""
    monkeypatch.setattr(jfleet, "FactorBank", functools.partial(
        jfleet.FactorBank, block_inv=jops.block_inv_kernel))
    return jfleet


@pytest.fixture
def jclock(fake_clock):
    """A second fake clock, for the reference's server."""
    return type(fake_clock)()


def _factors(M, n=32, seed=0):
    rng = np.random.default_rng(seed)
    Ls = np.stack([np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
                   for _ in range(M)])
    return Ls.astype(np.float32), rng


def _server(*, M=2, n=32, capacity=None, panel_k=4, ref=False, **kw):
    """A plain-mode server over a bank of M factors (the reference's
    with ``ref=True``); returns (server, Ls, bank, rng)."""
    Ls, rng = _factors(M, n)
    if ref:
        mod = japi
        bank = japi.FactorBank(JGRID, n, n0=8, capacity=capacity,
                               dtype=np.float32,
                               block_inv=jops.block_inv_kernel)
    else:
        mod = api
        bank = api.FactorBank(CPU, n, n0=8, capacity=capacity,
                              dtype=np.float32)
    if capacity is None:
        bank.admit_stack(Ls)
    else:
        for L in Ls:
            bank.admit(L)
    solver = mod.Solver.from_bank(bank)
    return (mod.AsyncSolveServer(solver, panel_k, **kw).warmup(),
            Ls, bank, rng)


def _rel(L, X, b):
    X = np.asarray(torch.as_tensor(X).double().numpy()
                   if isinstance(X, torch.Tensor) else X, np.float64)
    return (np.linalg.norm(L.astype(np.float64) @ X - np.asarray(b))
            / max(np.linalg.norm(b), 1e-30))


def _np(X):
    return np.asarray(X.numpy() if isinstance(X, torch.Tensor) else X)


# ---------------------- futures + wave correctness ----------------------

def test_futures_resolve_correct_solutions(fake_clock, jclock,
                                           drain_driver):
    srv, Ls, _, rng = _server(clock=fake_clock)
    jsrv, _, _, _ = _server(clock=jclock, ref=True)
    reqs = [(i % 2, rng.standard_normal((32, 1 + i % 3))
             .astype(np.float32)) for i in range(7)]
    futs = [srv.submit(b, factor=f) for f, b in reqs]
    jfuts = [jsrv.submit(b, factor=f) for f, b in reqs]
    assert srv.pending() == 7 and not any(f.done() for f in futs)
    drain_driver(srv).run_until_idle(advance=0.25)
    type(drain_driver(srv))(jsrv, jclock).run_until_idle(advance=0.25)
    for (f, b), fut, jfut in zip(reqs, futs, jfuts):
        assert fut.done() and fut.exception() is None
        X = fut.result()
        assert isinstance(X, torch.Tensor) and X.shape == b.shape
        assert _rel(Ls[f], X, b) < RELRES
        assert_close(X, _np(jfut.result()), TOL)
        # completion stamps come from the injected clock, as the
        # reference's do
        assert fut.latency() is not None and fut.latency() > 0
        assert fut.latency() == jfut.latency()
    st, jst = srv.stats(), jsrv.stats()
    assert st["served"] == 7 and st["shed"] == 0
    assert st["p99_ms"] >= st["p50_ms"] > 0
    assert st == jst


def test_vector_rhs_served_as_column(fake_clock, drain_driver):
    srv, Ls, _, rng = _server(clock=fake_clock)
    b = rng.standard_normal(32).astype(np.float32)
    fut = srv.submit(b)
    drain_driver(srv).run_until_idle()
    assert tuple(fut.result().shape) == (32, 1)
    assert _rel(Ls[0], fut.result()[:, 0], b) < RELRES


def test_future_timeout_raises_not_hangs(fake_clock):
    srv, _, _, rng = _server(clock=fake_clock)
    fut = srv.submit(rng.standard_normal((32, 1)).astype(np.float32))
    with pytest.raises(TimeoutError, match="drain loop"):
        fut.result(timeout=0.01)    # nobody is stepping the server
    with pytest.raises(TimeoutError):
        fut.exception(timeout=0.01)


# ------------------- admission control / queue bounds -------------------

def test_queue_bound_sheds_with_typed_overloaded(fake_clock,
                                                 drain_driver):
    srv, Ls, _, rng = _server(queue_depth=3, clock=fake_clock)
    bs = [rng.standard_normal((32, 1)).astype(np.float32)
          for _ in range(3)]
    futs = [srv.submit(b, factor=1) for b in bs]
    with pytest.raises(api.Overloaded, match="shed"):
        srv.submit(bs[0], factor=1)
    # per-slot bound: the OTHER slot's queue still admits
    other = srv.submit(bs[0], factor=0)
    assert srv.stats()["shed"] == 1 and srv.pending() == 4
    # shedding never poisons the queue: everything admitted serves
    drain_driver(srv).run_until_idle()
    for b, f in zip(bs, futs):
        assert _rel(Ls[1], f.result(), b) < RELRES
    assert other.done() and srv.stats()["served"] == 4


def test_submit_validation_errors(fake_clock):
    srv, _, bank, rng = _server(M=2, capacity=4, clock=fake_clock)
    b = rng.standard_normal((32, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="unknown factor"):
        srv.submit(b, factor=7)
    with pytest.raises(ValueError, match="inactive slot"):
        srv.submit(b, factor=3)
    with pytest.raises(ValueError, match="wider than panel"):
        srv.submit(rng.standard_normal((32, 9)).astype(np.float32))
    with pytest.raises(ValueError, match=r"must be \(32, j\)"):
        srv.submit(rng.standard_normal((16, 1)).astype(np.float32))
    with pytest.raises(ValueError, match="needs a fleet"):
        srv.submit(b, tag="adapter")
    with pytest.raises(ValueError, match=r"must be \(n, j\)"):
        srv.submit(np.zeros((32, 1, 1), np.float32))
    # validation rejects are NOT sheds, and nothing was enqueued
    assert srv.stats()["shed"] == 0 and srv.pending() == 0


# ----------------------- ordering and fairness -----------------------

def _waves_of(srv, futs, drv, max_waves=50):
    """Step until idle, recording which futures complete on each
    step — the observable wave/resolution order."""
    waves = []
    for _ in range(max_waves):
        before = [f.done() for f in futs]
        drv.step(advance=0.1)
        newly = [i for i, (was, f) in enumerate(zip(before, futs))
                 if not was and f.done()]
        if newly:
            waves.append(newly)
        if not srv.pending() and not srv._inflight:
            break
    assert all(f.done() for f in futs)
    return waves


def _both_waves(fake_clock, jclock, drain_driver, submits, **kw):
    """The same submits through both packages' servers; returns the
    port's (futures, waves) after asserting the reference packed the
    same waves, stamped the same completions and solved within TOL."""
    out = []
    for ref, clock in ((False, fake_clock), (True, jclock)):
        srv, _, _, rng = _server(clock=clock, ref=ref, **kw)
        futs = [srv.submit(rng.standard_normal((32, 1))
                           .astype(np.float32), tenant=t)
                for t in submits]
        drv = type(drain_driver(srv))(srv, clock)
        out.append((futs, _waves_of(srv, futs, drv)))
    (futs, waves), (jfuts, jwaves) = out
    assert waves == jwaves
    for f, jf in zip(futs, jfuts):
        assert f.completed == jf.completed
        assert_close(f.result(timeout=0), _np(jf.result(timeout=0)), TOL)
    return futs, waves


def test_fifo_per_tenant_and_resolution_order(fake_clock, jclock,
                                              drain_driver):
    """Per tenant, futures resolve in submit order, and completion
    timestamps are nondecreasing across waves — the reference's waves
    and stamps."""
    futs, waves = _both_waves(
        fake_clock, jclock, drain_driver,
        ["alice" if i % 2 == 0 else "bob" for i in range(6)],
        M=1, panel_k=2, max_inflight=1)
    assert len(waves) == 3 and all(len(w) == 2 for w in waves)
    flat = [i for w in waves for i in w]
    for tenant in ("alice", "bob"):
        order = [i for i in flat if futs[i].tenant == tenant]
        assert order == sorted(order)          # FIFO per tenant
    stamps = [futs[w[0]].completed for w in waves]
    assert stamps == sorted(stamps)


def test_weighted_fairness_within_one_wave(fake_clock, jclock,
                                           drain_driver):
    """Backlogged 3:1 tenants split an 8-wide panel 6:2 in the first
    wave (unit-width requests => exact weight proportionality), as in
    the reference."""
    futs, waves = _both_waves(
        fake_clock, jclock, drain_driver,
        [t for _ in range(8) for t in ("a", "b")],
        M=1, panel_k=8, max_inflight=1, queue_depth=32,
        weights={"a": 3.0, "b": 1.0})
    first = [futs[i].tenant for i in waves[0]]
    assert len(first) == 8
    assert first.count("a") == 6 and first.count("b") == 2
    # weights shape WHO shares a wave, never whether someone is served
    assert all(f.done() and f.exception() is None for f in futs)


def test_unweighted_tenants_share_equally(fake_clock, jclock,
                                          drain_driver):
    futs, waves = _both_waves(
        fake_clock, jclock, drain_driver,
        [t for _ in range(4) for t in ("a", "b")],
        M=1, panel_k=4, max_inflight=1, queue_depth=32)
    for w in waves:
        tenants = [futs[i].tenant for i in w]
        assert tenants.count("a") == 2 and tenants.count("b") == 2


def test_max_inflight_pipelines_waves(fake_clock, drain_driver):
    """With the default pipeline depth, one wave stays un-finalized
    while the next is packed; flush() resolves the tail.  On the CPU a
    wave carries no event: it was complete when dispatched."""
    srv, _, _, rng = _server(M=1, panel_k=1, max_inflight=2,
                             clock=fake_clock)
    futs = [srv.submit(rng.standard_normal((32, 1)).astype(np.float32))
            for _ in range(3)]
    drv = drain_driver(srv)
    drv.step()
    assert len(srv._inflight) == 1 and not futs[0].done()
    assert srv._inflight[0][1] is None
    drv.step()                      # dispatch #2 finalizes #1
    assert futs[0].done() and not futs[1].done()
    drv.step()
    assert futs[1].done() and not futs[2].done()
    srv.flush()
    assert futs[2].done() and len(srv._inflight) == 0


# -------------------- evict-under-flight: stranding --------------------

def test_stranded_future_on_evict_then_readmit_plain(fake_clock, jclock,
                                                     drain_driver):
    """The generation counter catches slot TURNOVER, not just death:
    evict + re-admit leaves the slot live, but the queued request
    fails through its future with the typed error — no hang, no solve
    against the new occupant — on both sides alike."""
    Lnew, _ = _factors(1, seed=99)
    outs = []
    for ref, clock in ((False, fake_clock), (True, jclock)):
        srv, Ls, bank, rng = _server(M=2, capacity=2, clock=clock,
                                     ref=ref)
        b = rng.standard_normal((32, 1)).astype(np.float32)
        stale = srv.submit(b, factor=1)
        bank.evict(1)
        assert bank.admit(Lnew[0]) == 1 and bank.is_live(1)
        fresh = srv.submit(b, factor=1)   # new generation: stays valid
        type(drain_driver(srv))(srv, clock).run_until_idle()
        outs.append((srv, stale, fresh, b))
    (srv, stale, fresh, b), (jsrv, jstale, jfresh, _) = outs
    err = stale.exception(timeout=0)
    assert isinstance(err, api.StrandedRequestError)
    assert isinstance(err, ValueError)    # old except-clauses keep working
    assert "evicted after submission" in str(err)
    assert str(err) == str(jstale.exception(timeout=0))
    with pytest.raises(api.StrandedRequestError):
        stale.result(timeout=0)
    assert _rel(Lnew[0], fresh.result(timeout=0), b) < RELRES
    assert_close(fresh.result(timeout=0), _np(jfresh.result(timeout=0)),
                 TOL)
    st = srv.stats()
    assert st["stranded"] == 1 and st["served"] >= 1
    assert st == jsrv.stats()


def test_dead_slot_strands_whole_queue_plain(fake_clock, drain_driver):
    srv, _, bank, rng = _server(M=2, capacity=2, clock=fake_clock)
    futs = [srv.submit(rng.standard_normal((32, 1)).astype(np.float32),
                       factor=0) for _ in range(3)]
    bank.evict(0)
    drain_driver(srv).run_until_idle()
    for f in futs:
        assert isinstance(f.exception(timeout=0),
                          api.StrandedRequestError)
    assert srv.stats()["stranded"] == 3


def _fleet(manifest, ref):
    kw = dict(k=4, dispatch_s=5e-5)
    if ref:
        plan = japi.plan_fleet(manifest, JGRID, machine=jcm.tpu_v5e(),
                               **kw)
        return japi.SolverFleet(JGRID, plan)
    plan = api.plan_fleet(manifest, CPU, machine=cm.tpu_v5e(), **kw)
    return api.SolverFleet(CPU, plan)


def test_stranded_future_on_fleet_cross_tenant_reclaim(jref, fake_clock,
                                                       jclock,
                                                       drain_driver):
    """Fleet mode records the FleetHandle generation at submit; a
    cross-tenant LRU reclaim of the slot strands exactly the displaced
    tenant's queued requests while the reclaimer's serve fine — as in
    the reference, within TOL of its solution."""
    outs = []
    for ref, clock in ((False, fake_clock), (True, jclock)):
        fleet = _fleet({64: 1}, ref)
        assert fleet.plan.buckets[0].capacity == 1   # full => reclaims
        Ls, rng = _factors(2, n=64, seed=3)
        fleet.admit(Ls[0], tenant="alice")
        srv = (japi if ref else api).AsyncSolveServer(
            fleet, panel_k=4, clock=clock).warmup()
        b = rng.standard_normal((64, 1)).astype(np.float32)
        doomed = srv.submit(b, tenant="alice")
        fleet.admit(Ls[1], tenant="bob")      # reclaims alice's slot
        fresh = srv.submit(b, tenant="bob")
        type(drain_driver(srv))(srv, clock).run_until_idle()
        outs.append((srv, doomed, fresh, b, Ls))
        # and alice's route is gone at ADMISSION now, not at drain
        with pytest.raises(KeyError, match="re-admit"):
            srv.submit(b, tenant="alice")
    (srv, doomed, fresh, b, Ls), (jsrv, jdoomed, jfresh, _, _) = outs
    assert isinstance(doomed.exception(timeout=0),
                      api.StrandedRequestError)
    assert isinstance(jdoomed.exception(timeout=0),
                      japi.StrandedRequestError)
    assert _rel(Ls[1], fresh.result(timeout=0), b) < RELRES
    assert_close(fresh.result(timeout=0), _np(jfresh.result(timeout=0)),
                 TOL)
    assert srv.stats() == jsrv.stats()


def test_fleet_async_mixed_orders_slice_back(jref, fake_clock, jclock,
                                             drain_driver):
    """Mixed-order tenants share a bucket; each solution comes back at
    its TRUE order (padded rows sliced off), within TOL of the
    reference's."""
    outs = []
    for ref, clock in ((False, fake_clock), (True, jclock)):
        fleet = _fleet({48: 1, 64: 1}, ref)
        assert [b.n for b in fleet.plan.buckets] == [64]    # merged
        rng = np.random.default_rng(4)
        Ls = {}
        for t, order in (("alice", 48), ("bob", 64)):
            L = (np.tril(rng.standard_normal((order, order)))
                 + order * np.eye(order)).astype(np.float32)
            Ls[t] = L
            fleet.admit(L, tenant=t)
        srv = (japi if ref else api).AsyncSolveServer(
            fleet, panel_k=4, clock=clock).warmup()
        reqs = {t: rng.standard_normal((L.shape[0], 2)).astype(np.float32)
                for t, L in Ls.items()}
        futs = {t: srv.submit(b, tenant=t) for t, b in reqs.items()}
        type(drain_driver(srv))(srv, clock).run_until_idle()
        outs.append(futs)
    futs, jfuts = outs
    for t, f in futs.items():
        X = f.result(timeout=0)
        assert tuple(X.shape) == (Ls[t].shape[0], 2)
        assert f.exception() is None
        assert _rel(Ls[t], X, reqs[t]) < RELRES
        assert_close(X, _np(jfuts[t].result(timeout=0)), TOL)


# ------------------------- the steady state -------------------------

def test_async_steady_state_zero_build_zero_transfer(fake_clock,
                                                     drain_driver):
    """After warmup + one priming wave, waves pack and dispatch with
    ZERO program builds, and a submit of an RHS already on the device
    at the I/O dtype queues that very tensor (no copy); on the card
    tests/test_torch_gpu.py also holds the waves under sync-debug mode
    "error"."""
    srv, Ls, _, rng = _server(M=2, panel_k=4, max_inflight=1,
                              clock=fake_clock)
    spec = srv.solver.spec_for(srv.panel_k)
    bs = [torch.as_tensor(rng.standard_normal((32, 2))
                          .astype(np.float32)) for _ in range(8)]
    drv = drain_driver(srv)
    srv.submit(bs[0], factor=0)               # priming wave
    drv.run_until_idle()
    before = session.BUILD_COUNTS[spec]
    futs = []
    for i, b in enumerate(bs):
        futs.append(srv.submit(b, factor=i % 2))
        assert srv._queues[i % 2]._reqs[-1].b is b      # no copy
    drv.run_until_idle()
    assert session.BUILD_COUNTS[spec] == before == 1   # zero builds
    for i, (b, f) in enumerate(zip(bs, futs)):
        assert _rel(Ls[i % 2], f.result(timeout=0), b.numpy()) < RELRES


# ----------------------- lifecycle + the thread -----------------------

def test_context_manager_runs_real_drain_loop():
    srv, Ls, _, rng = _server()
    spawned = []
    real_factory = threading.Thread

    def factory(**kw):                        # injectable executor
        t = real_factory(**kw)
        spawned.append(t)
        return t

    srv._thread_factory = factory
    bs = [rng.standard_normal((32, 1)).astype(np.float32)
          for _ in range(5)]
    with srv:
        futs = [srv.submit(b, factor=i % 2) for i, b in enumerate(bs)]
        outs = [f.result(timeout=60) for f in futs]
    assert len(spawned) == 1 and not spawned[0].is_alive()
    for i, (b, X) in enumerate(zip(bs, outs)):
        assert _rel(Ls[i % 2], X, b) < RELRES
    with pytest.raises(RuntimeError, match="already running"):
        with srv:
            srv.start()


def test_stop_drains_queued_work():
    """stop(drain=True) serves everything still queued, so no future
    is ever left hanging by a clean shutdown."""
    srv, _, _, rng = _server()
    futs = [srv.submit(rng.standard_normal((32, 1)).astype(np.float32))
            for _ in range(4)]
    srv.start()
    srv.stop(drain=True)
    assert all(f.done() for f in futs)
    assert srv.stats()["served"] == 4 and srv.pending() == 0


def test_concurrency_stress_producers_vs_churn():
    """N producer threads against ONE real drain loop while a churn
    thread replaces and evicts/re-admits slots: every future completes
    (served or typed-stranded, never a hang), counts conserve, and the
    wave program is never rebuilt."""
    n, C, panel_k = 32, 4, 4
    Ls, rng = _factors(C, n, seed=11)
    bank = api.FactorBank(CPU, n, n0=8, capacity=C, dtype=np.float32)
    for L in Ls:
        bank.admit(L)
    solver = api.Solver.from_bank(bank)
    srv = api.AsyncSolveServer(solver, panel_k, queue_depth=16,
                               max_inflight=2).warmup()
    spec = solver.spec_for(panel_k)
    builds = session.BUILD_COUNTS[spec]
    N, per = 4, 25
    futures, shed = [], [0] * N
    flock = threading.Lock()
    barrier = threading.Barrier(N + 2)
    stop_churn = threading.Event()
    errors = []

    def producer(w):
        try:
            prng = np.random.default_rng(100 + w)
            barrier.wait()
            for i in range(per):
                b = prng.standard_normal((n, 1)).astype(np.float32)
                # steady slots 0/1 only; churn owns slots 2/3
                try:
                    f = srv.submit(b, factor=(w + i) % 2,
                                   tenant=f"w{w}")
                except api.Overloaded:
                    shed[w] += 1
                    continue
                with flock:
                    futures.append(f)
        except Exception as e:                # pragma: no cover
            errors.append(e)

    def churn():
        try:
            crng = np.random.default_rng(999)
            barrier.wait()
            while not stop_churn.is_set():
                slot = int(crng.integers(2, C))
                Lnew = (np.tril(crng.standard_normal((n, n)))
                        + n * np.eye(n)).astype(np.float32)
                if crng.integers(2):
                    bank.replace(slot, Lnew)  # generation-preserving
                else:
                    bank.evict(slot)
                    bank.admit(Lnew)          # turnover: strands queue
        except Exception as e:                # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(w,))
               for w in range(N)]
    threads.append(threading.Thread(target=churn))
    for t in threads:
        t.start()
    with srv:
        barrier.wait()
        for t in threads[:-1]:
            t.join(60)
        stop_churn.set()
        threads[-1].join(60)
        # submit a few against the churned slots too: they either
        # serve or strand with the typed error — never hang
        for slot in (2, 3):
            if bank.is_live(slot):
                try:
                    futures.append(srv.submit(
                        np.zeros((n, 1), np.float32), factor=slot))
                except (ValueError, api.Overloaded):
                    pass
    assert not errors
    assert not any(t.is_alive() for t in threads)
    assert all(f.done() for f in futures)     # stop(drain=True) above
    outcomes = [f.exception() for f in futures]
    assert all(e is None or isinstance(e, api.StrandedRequestError)
               for e in outcomes)
    st = srv.stats()
    assert st["served"] + st["stranded"] == len(futures)
    assert st["shed"] == sum(shed)            # count conservation
    # capacity churn NEVER rebuilds the wave program
    assert session.BUILD_COUNTS[spec] == builds


# ------------------------- FairQueue unit tests -------------------------

def test_fairqueue_width_bound_stops_at_first_nonfit():
    fq = FairQueuePair(panel_k=4, depth=16)
    for seq, w in enumerate([2, 3, 1]):       # 2 fits, 3 doesn't, STOP
        fq.push(seq, width=w)
    assert [r.seq for r in fq.pack()] == [0]  # no skip-ahead past #1
    assert [r.seq for r in fq.pack()] == [1, 2]


def test_fairqueue_wide_request_never_starves():
    """A panel-wide request pays its width (later virtual finish), but
    a CONTINUOUS stream of narrow competitors cannot starve it: its
    fixed tag becomes the minimum within a bounded number of waves,
    and it then packs alone into a fresh panel."""
    fq = FairQueuePair(panel_k=4, depth=64)
    fq.push(0, "slow", width=4)
    seq, served = 1, []
    for _ in range(10):
        for _ in range(4):                    # keep the pressure on
            fq.push(seq, "fast", width=1)
            seq += 1
        served.append([r.seq for r in fq.pack()])
        if [0] in served:
            break
    assert [0] in served[:3]                  # alone, within 3 waves


def test_fairqueue_depth_bound_and_idle_reset():
    fq = FairQueuePair(panel_k=4, depth=2)
    fq.push(0)
    fq.push(1)
    with pytest.raises(api.Overloaded, match="full"):
        fq.fqs[0].push(_Request(seq=2, b=None, width=1, tenant="t",
                                key=0, gen=0, order=32, future=None))
    fq.pack()
    port = fq.fqs[0]
    assert port._vclock == 0.0 and not port._vt   # idle => WFQ reset
    fq.push(3)                                # and admission reopens
    assert len(fq) == 1
    fq.push(4)
    fq.push(5, force=True)                    # migration bypasses depth
    assert len(fq) == 3


def test_fairqueue_pop_if_removes_matching_fifo():
    fq = FairQueuePair(panel_k=8, depth=16)
    for seq in range(6):
        fq.push(seq, tenant="a" if seq % 2 else "b")
    hit = fq.pop_if(lambda r: r.tenant == "a")
    assert [r.seq for r in hit] == [1, 3, 5]
    assert len(fq) == 3
    assert fq.pop_if(lambda r: False) == []


def test_fairqueue_pop_if_frees_width_and_depth():
    fq = FairQueuePair(panel_k=8, depth=2)
    fq.push(0, width=3)
    fq.push(1, width=2)
    assert fq.fqs[0].queued_width() == fq.fqs[1].queued_width() == 5
    fq.pop_if(lambda r: r.seq == 0)
    assert fq.fqs[0].queued_width() == 2
    fq.push(2)                        # depth slot freed by the pop
    assert [r.seq for r in fq.pack()] == [1, 2]
    assert fq.pop_if(lambda r: True) == []    # empty queue: no-op


def test_fairqueue_weight_update_under_churn():
    fq = FairQueuePair(panel_k=2, depth=64)
    seq = 0

    def burst(counts):
        nonlocal seq
        for t, c in counts:
            for _ in range(c):
                fq.push(seq, t)
                seq += 1

    burst([("a", 2), ("b", 2)])
    drained = []
    while len(fq):
        drained.extend(fq.pack())
    # equal weights: the wave interleaves fairly
    assert sorted(r.tenant for r in drained[:2]) == ["a", "b"]
    fq.set_weight("a", 4.0)           # mid-stream reweigh
    with pytest.raises(ValueError, match="weight"):
        fq.fqs[0].set_weight("a", 0.0)
    burst([("a", 4), ("b", 4)])
    drained2 = []
    while len(fq):
        drained2.extend(fq.pack())
    # churn loses nothing, per-tenant FIFO holds, and the heavier
    # tenant now FRONT-LOADS the drain order
    assert len(drained2) == 8
    for t in ("a", "b"):
        mine = [r.seq for r in drained2 if r.tenant == t]
        assert mine == sorted(mine)
    first_half = [r.tenant for r in drained2[:4]]
    assert first_half.count("a") > first_half.count("b")


def test_server_set_weight_applies_to_live_and_future_queues(
        fake_clock, drain_driver):
    srv, Ls, _, rng = _server(clock=fake_clock,
                              weights={"a": 1.0, "b": 1.0})
    b = rng.standard_normal((32, 1)).astype(np.float32)
    f0 = srv.submit(b, factor=0, tenant="a")  # queue 0 exists now
    srv.set_weight("a", 8.0)
    with pytest.raises(ValueError, match="weight"):
        srv.set_weight("a", -1.0)
    assert srv._queues[0].weight("a") == 8.0  # live queue updated
    f1 = srv.submit(b, factor=1, tenant="a")  # queue 1 created after
    assert srv._queues[1].weight("a") == 8.0
    drain_driver(srv).run_until_idle()
    srv.flush()
    assert f0.exception(timeout=0) is None
    assert f1.exception(timeout=0) is None


def test_fairqueue_rejects_bad_config():
    with pytest.raises(ValueError, match="depth"):
        FairQueue(panel_k=4, depth=0)
    with pytest.raises(ValueError, match="weight"):
        FairQueue(panel_k=4, depth=4, weights={"t": 0.0})
    assert api.FairQueue is FairQueue


def test_async_server_rejects_wrapping_a_solveserver():
    Ls, _ = _factors(1)
    solver = api.Solver.from_factor(Ls[0], CPU, n0=8)
    with pytest.raises(TypeError, match="directly"):
        api.AsyncSolveServer(api.SolveServer(solver, 4))
    with pytest.raises(ValueError, match="max_inflight"):
        api.AsyncSolveServer(solver, 4, max_inflight=0)


@pytest.mark.parametrize("flags", [[], ["--admission", "slo", "--stats-json"],
                                   ["--autoscale", "--stats-json"]])
def test_the_traffic_cli_runs_on_the_cpu(capsys, flags):
    """``--workload trsm-traffic`` on the plain versions: the
    reference's summary line, every request served at this light load,
    and with ``--stats-json`` one JSON line whose counts conserve."""
    import json

    from repro_torch.launch import serve
    serve.main(["--workload", "trsm-traffic", "--device", "cpu", "--n",
                "64", "--rate", "200", "--requests", "24", *flags])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("served 24/24 open-loop requests")
    assert "vs SLO 50 ms" in lines[0] and "precision=fp32" in lines[0]
    if "--autoscale" in flags:
        assert lines[1].startswith("autoscaler: ")
    if "--stats-json" in flags:
        st = json.loads(lines[-1])
        assert st["submitted"] == st["served"] + st["stranded"]
        assert st["pending"] == st["inflight"] == 0
        assert ("admission" in st) == ("slo" in flags)
        assert ("autoscaler" in st) == ("--autoscale" in flags)
