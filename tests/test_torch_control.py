"""The control plane (DESIGN.md Sec. 15) of the port against the JAX
package's, on the CPU: ``repro_torch.core.control`` and
``cost_model.queue_wait_estimate`` beside ``repro.core.control``.

The counterparts of tests/test_control.py, apart from its two tests of
the reference's deprecated error spellings (the port has no legacy
callers and keeps no alias): the serving-error hierarchy, the stats
contracts, SLO-aware admission (deadline stamping, DeadlineUnmeetable
through the future, the idle probe path), deadline-EDF packing inside
a tenant's fair-share window, and the planner-driven autoscaler
(split under saturation, merge at idle, convergence, live migration
that strands nothing, no build on non-migrating waves).

Each deterministic test drives both packages under one FakeClock
schedule (tests/conftest.py; one fake clock per side, advanced alike)
and holds the port to the reference: ``queue_wait_estimate`` equal,
the same requests shed with the same deadlines, the Autoscaler's
replans equal (time, pressure, dispatch budget, kind, moved, the
bucket keys opened, closed and rebuilt, and the bucket keys after),
the same stats, and every served X within the reference's fp32
tolerance (2e-5, ``torch_parity``) and its residual bound (1e-4).
Both sides plan and seed with an explicit ``cost_model.tpu_v5e()``
and dispatch budget: the reference's default machine is calibrated,
the port's is the H100 preset.  The reference's fleet banks get the
kernel phase 1 hook, as in tests/test_torch_fleet.py.
"""

import functools
import json

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
from torch_parity import FairQueuePair, assert_close

pytestmark = pytest.mark.control

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = japi.make_trsm_mesh(1, 1)
TOL = 2e-5
RELRES = 1e-4
DISPATCH_S = 5e-5


@pytest.fixture
def jref(monkeypatch):
    """The reference's fleet with the kernel phase 1 hook in its banks
    (its default phase 1 fails on jax 0.9)."""
    monkeypatch.setattr(jfleet, "FactorBank", functools.partial(
        jfleet.FactorBank, block_inv=jops.block_inv_kernel))
    return jfleet


def _lower(d, rng):
    L = np.tril(rng.standard_normal((d, d))).astype(np.float32)
    L[np.diag_indices(d)] = np.abs(L[np.diag_indices(d)]) + d
    return L


def _np(X):
    return np.asarray(X.numpy() if isinstance(X, torch.Tensor) else X,
                      np.float64)


def _rel(L, X, b):
    X = _np(X)[:L.shape[0]]
    return (np.linalg.norm(L.astype(np.float64) @ X - np.asarray(b))
            / max(np.linalg.norm(b), 1e-30))


class Side:
    """One package's fleet-mode server on its own fake clock: ``mod``
    is ``repro_torch.api`` or ``repro.api``."""

    def __init__(self, mod, clock, driver_cls, *, man, panel_k=4,
                 depth=64, slo_ms=None, admission=False, seed=0):
        ref = mod is japi
        self.mod, self.clock, self.ref = mod, clock, ref
        self.machine = (jcm if ref else cm).tpu_v5e()
        rng = np.random.default_rng(seed)
        plan = mod.plan_fleet(dict(man), JGRID if ref else CPU,
                              k=panel_k, machine=self.machine,
                              dispatch_s=DISPATCH_S)
        self.fleet = mod.SolverFleet(JGRID if ref else CPU, plan)
        self.Ls, self.handles = {}, {}
        for d, count in man.items():
            for i in range(count):
                self.Ls[(d, i)] = _lower(d, rng)
                self.handles[(d, i)] = self.fleet.admit(
                    self.Ls[(d, i)], tenant=f"t{d}", tag=f"f{i}")
        self.ctrl = None
        if admission is not False:
            self.ctrl = mod.AdmissionController(machine=self.machine,
                                                **admission)
        self.srv = mod.AsyncSolveServer(
            self.fleet, panel_k, queue_depth=depth, slo_ms=slo_ms,
            admission=self.ctrl, clock=clock).warmup()
        self.drv = driver_cls(self.srv, clock)
        self.rng = rng

    def scaler(self, **kw):
        return self.mod.Autoscaler(self.srv, machine=self.machine, **kw)

    def submit(self, d, i, b):
        return self.srv.submit(b, tenant=f"t{d}", tag=f"f{i}")

    def drain(self, advance=0.001):
        self.drv.run_until_idle(advance=advance)
        self.srv.flush()

    def buckets(self):
        return sorted(key[0] for key in self.fleet.buckets)


def _pair(fake_clock, drain_driver, *, man={32: 3, 24: 3}, **kw):
    """(port side, reference side) of one manifest.  The reference's
    fleet needs the ``jref`` patch in place."""
    driver_cls = type(drain_driver(None))
    return (Side(api, fake_clock, driver_cls, man=man, **kw),
            Side(japi, type(fake_clock)(), driver_cls, man=man, **kw))


def _keys(keys):
    return sorted((k[0], k[1].name) for k in keys)


def _same_replans(scaler, jscaler):
    """The Autoscaler's decisions, equal on both sides."""
    assert len(scaler.replans) == len(jscaler.replans)
    for r, jr in zip(scaler.replans, jscaler.replans):
        assert (r["t"], r["kind"], r["moved"]) \
            == (jr["t"], jr["kind"], jr["moved"])
        assert r["pressure"] == pytest.approx(jr["pressure"], rel=1e-12)
        assert r["dispatch_s"] == pytest.approx(jr["dispatch_s"],
                                                rel=1e-12, abs=1e-18)
        for f in ("opened", "closed", "rebuilt"):
            assert _keys(r[f]) == _keys(jr[f])


def _same_served(futs, jfuts, Ls, reqs):
    for f, jf, (key, b) in zip(futs, jfuts, reqs):
        err, jerr = f.exception(timeout=0), jf.exception(timeout=0)
        assert type(err).__name__ == type(jerr).__name__
        if err is None:
            assert _rel(Ls[key], f.result(timeout=0), b) < RELRES
            assert_close(f.result(timeout=0), _np(jf.result(timeout=0)),
                         TOL)


# ------------------------- error hierarchy -------------------------

def test_serving_error_hierarchy():
    assert issubclass(api.Overloaded, api.ServingError)
    assert issubclass(api.DeadlineUnmeetable, api.Overloaded)
    assert issubclass(api.StrandedRequestError, api.ServingError)
    # stdlib bases are part of the compat contract: handlers written
    # against them keep catching
    assert issubclass(api.Overloaded, RuntimeError)
    assert issubclass(api.StrandedRequestError, ValueError)
    assert not issubclass(api.StrandedRequestError, api.Overloaded)
    # one catch-all for "the serving tier refused/failed this request"
    for exc in (api.Overloaded("x"), api.DeadlineUnmeetable("x"),
                api.StrandedRequestError("x")):
        with pytest.raises(api.ServingError):
            raise exc


# ------------------------- stats contracts -------------------------

def test_stats_empty_window_is_none(jref, fake_clock, drain_driver):
    side, jside = _pair(fake_clock, drain_driver)
    st = side.srv.stats()
    assert st["served"] == 0 and st["shed"] == 0
    assert st["p50_ms"] is None and st["p99_ms"] is None
    assert st["max_ms"] is None
    assert st["tenants"] == {}
    assert st == jside.srv.stats()


def test_stats_per_tenant_breakdown(jref, fake_clock, drain_driver):
    sides = _pair(fake_clock, drain_driver, slo_ms=0.5)
    for s in sides:
        rng = np.random.default_rng(7)
        for (d, i) in s.handles:
            s.submit(d, i, rng.standard_normal((d, 2)).astype(np.float32))
        s.drain(advance=0.25)            # every wave blows the SLO
    st = sides[0].srv.stats()
    assert set(st["tenants"]) == {"t32", "t24"}
    for t in ("t32", "t24"):
        ts = st["tenants"][t]
        assert ts["submitted"] == ts["served"] == 3
        assert ts["slo_violations"] == 3
        assert ts["shed"] == ts["deadline_shed"] == 0
        assert ts["stranded"] == 0
    assert st["slo_violations"] == 6
    assert st == sides[1].srv.stats()
    # the breakdown is a copy: mutating it never corrupts the server
    st["tenants"]["t32"]["served"] = 999
    assert sides[0].srv.stats()["tenants"]["t32"]["served"] == 3


# ------------------------- admission -------------------------

@pytest.mark.parametrize("args,want", [
    ((7, 1, 1, 4, 0.01), 0.03),    # 7 queued + 1 new = 2 waves of 4,
    ((0, 1, 0, 4, 0.01), 0.01),    # plus 1 in flight = 3 waves
    ((7, 1, 1, 4, 0.01, 0.001), 0.033),   # dispatch paid per wave
    ((33, 3, 2, 16, 2.5e-3, 5e-5), None),
    ((0, 16, 0, 16, 1e-3), None), ((5, 2, 0, 0.5, 1.0), None)])
def test_queue_wait_estimate_arithmetic(args, want):
    got = cm.queue_wait_estimate(*args)
    if want is not None:
        assert got == pytest.approx(want)
    assert got == jcm.queue_wait_estimate(*args)   # the same formula


@pytest.mark.parametrize("occupancy", [1, 6])    # 1 and C (=3+3)
def test_admission_sheds_deadline_unmeetable(jref, fake_clock,
                                             drain_driver, occupancy):
    man = {32: min(occupancy, 3), 24: max(occupancy - 3, 0)}
    man = {d: c for d, c in man.items() if c}
    sides = _pair(fake_clock, drain_driver, man=man, slo_ms=50.0,
                  admission=dict(slo_ms=50.0))
    outs = []
    for s in sides:
        keys = sorted(s.handles)
        rng = np.random.default_rng(5)
        # measured signal: one wave at 10 ms -> EWMA seeds to 10 ms/wave
        d0, i0 = keys[0]
        first = s.submit(d0, i0, rng.standard_normal((d0, 1))
                         .astype(np.float32))
        s.drain(advance=0.010)
        assert first.exception(timeout=0) is None
        unit = next(iter(s.fleet.buckets))
        assert s.srv._wave_ewma[unit] == pytest.approx(0.010)
        # 50 ms / 10 ms-per-wave / (panel_k=4 cols) -> ~20 columns
        # admit; beyond that the estimate exceeds the SLO and submits
        # shed
        futs, reqs = [], []
        for j in range(40 * len(keys)):
            d, i = keys[j % len(keys)]
            b = rng.standard_normal((d, 1)).astype(np.float32)
            reqs.append(((d, i), b))
            futs.append(s.submit(d, i, b))     # NEVER raises
        shed = [j for j, f in enumerate(futs) if f.done()]
        deadlines = sorted((r.seq, r.deadline)
                           for fq in s.srv._queues.values()
                           for r in fq._reqs)
        outs.append((futs, reqs, shed, deadlines))
        ok = [f for f in futs if not f.done()]
        assert shed and ok, (len(shed), len(ok))
        for j in shed:
            err = futs[j].exception(timeout=0)
            assert isinstance(err, s.mod.DeadlineUnmeetable)
            assert isinstance(err, s.mod.Overloaded)
        st = s.srv.stats()
        assert st["shed"] == len(shed) == s.ctrl.shed
        assert sum(ts["deadline_shed"]
                   for ts in st["tenants"].values()) == len(shed)
    # the same requests shed, the same deadlines stamped
    (futs, reqs, shed, dl), (jfuts, _, jshed, jdl) = outs
    assert shed == jshed and dl == jdl
    assert sides[0].ctrl.stats() == sides[1].ctrl.stats()
    for j in shed:        # the same estimate (the keys spell dtypes apart)
        msg, jmsg = (str(x[j].exception(timeout=0)) for x in (futs, jfuts))
        assert msg.split("cannot meet")[1] == jmsg.split("cannot meet")[1]
    # admitted requests were stamped and ALL serve
    for s in sides:
        s.drain()
        assert s.srv.stranded == 0
    assert all(f.exception(timeout=0) is None
               for j, f in enumerate(futs) if j not in shed)
    _same_served(futs, jfuts, sides[0].Ls, reqs)
    assert sides[0].srv.stats() == sides[1].srv.stats()


def test_admission_probe_path_unwedges(jref, fake_clock, drain_driver):
    sides = _pair(fake_clock, drain_driver, slo_ms=10.0,
                  admission=dict(slo_ms=10.0))
    b = np.random.default_rng(1).standard_normal((32, 1)) \
        .astype(np.float32)
    for s in sides:
        unit = next(iter(s.fleet.buckets))
        s.srv._wave_ewma[unit] = 10.0    # poisoned: 10 s per wave
        # idle system: the probe admits anyway (and refreshes the EWMA)
        fut = s.submit(32, 0, b)
        assert not fut.done()            # admitted, not shed
        s.drain(advance=0.0005)
        assert fut.exception(timeout=0) is None
        assert s.srv._wave_ewma[unit] < 10.0   # signal recovered
    assert sides[0].srv._wave_ewma[next(iter(sides[0].fleet.buckets))] \
        == sides[1].srv._wave_ewma[next(iter(sides[1].fleet.buckets))]


def test_admission_without_slo_is_depth_only(jref, fake_clock,
                                             drain_driver):
    b = np.random.default_rng(0).standard_normal((32, 1)) \
        .astype(np.float32)
    for s in _pair(fake_clock, drain_driver, depth=2, admission={}):
        s.submit(32, 0, b)
        s.submit(32, 0, b)
        with pytest.raises(s.mod.Overloaded):   # depth bound raises
            s.submit(32, 0, b)
        assert s.ctrl.shed == 0          # the controller shed nothing


# ------------------------- deadline EDF packing -------------------------

def test_pack_reorders_within_tenant_by_deadline():
    fq = FairQueuePair(panel_k=3, depth=16)
    fq.push(0, deadline=9.0)
    fq.push(1, deadline=1.0)
    fq.push(2, deadline=5.0)
    assert [r.seq for r in fq.pack()] == [1, 2, 0]


def test_pack_without_deadlines_is_fifo():
    fq = FairQueuePair(panel_k=3, depth=16)
    for seq in range(3):
        fq.push(seq)
    assert [r.seq for r in fq.pack()] == [0, 1, 2]


def test_deadline_reorder_preserves_cross_tenant_shares():
    # identical queues, one with deadlines: tenant B's positions and
    # every tenant's SLOT COUNT in the wave must be unchanged —
    # deadlines reorder only WITHIN a tenant's fair-share window
    def fill(fq, with_deadlines):
        dl = [7.0, 1.0, 4.0] if with_deadlines else [None] * 3
        fq.push(0, "a", deadline=dl[0])
        fq.push(1, "b")
        fq.push(2, "a", deadline=dl[1])
        fq.push(3, "b")
        fq.push(4, "a", deadline=dl[2])
        fq.push(5, "b")
    plain = FairQueuePair(panel_k=6, depth=16)
    edf = FairQueuePair(panel_k=6, depth=16)
    fill(plain, False)
    fill(edf, True)
    base = [(r.tenant, r.seq) for r in plain.pack()]
    wave = [(r.tenant, r.seq) for r in edf.pack()]
    assert [t for t, _ in base] == [t for t, _ in wave]
    assert [s for t, s in wave if t == "b"] \
        == [s for t, s in base if t == "b"]
    assert [s for t, s in wave if t == "a"] == [2, 4, 0]  # EDF
    # None deadlines sort LAST within the tenant, FIFO among them
    fq = FairQueuePair(panel_k=3, depth=16)
    fq.push(0)
    fq.push(1, deadline=1.0)
    fq.push(2)
    assert [r.seq for r in fq.pack()] == [1, 0, 2]


def test_deadline_reorder_respects_width_bound():
    # EDF brings seq 2 forward; the width bound still stops the wave
    # at the first non-fit IN PACK ORDER
    fq = FairQueuePair(panel_k=3, depth=16)
    fq.push(0, width=2, deadline=5.0)
    fq.push(1, width=3, deadline=9.0)
    fq.push(2, width=1, deadline=1.0)
    assert [r.seq for r in fq.pack()] == [2, 0]
    assert [r.seq for r in fq.pack()] == [1]


# ------------------------- autoscaler -------------------------

def _pressurize(side, scaler, count=20):
    """Re-baseline the rate window, then offer a burst over a short
    interval so the next tick sees saturation."""
    scaler.observe(now=side.clock.monotonic())
    futs, reqs = [], []
    for j in range(count):
        for (d, i) in sorted(side.handles):
            b = side.rng.standard_normal((d, 4)).astype(np.float32)
            reqs.append(((d, i), b))
            futs.append(side.submit(d, i, b))
    side.clock.advance(0.01)
    return futs, reqs


def test_autoscaler_requires_fleet(fake_clock):
    Ls = np.stack([_lower(16, np.random.default_rng(0))])
    solver = api.Solver.from_factors(Ls, CPU, n0=8)
    srv = api.AsyncSolveServer(solver, 4, clock=fake_clock)
    with pytest.raises(ValueError, match="fleet"):
        api.Autoscaler(srv)


def _split(side, **kw):
    """One measured wave, then saturation: the first tick splits."""
    scaler = side.scaler(**kw)
    side.submit(32, 0, side.rng.standard_normal((32, 2))
                .astype(np.float32))
    side.drain()
    futs, reqs = _pressurize(side, scaler)
    report = scaler.tick(now=side.clock.monotonic())
    return scaler, report, futs, reqs


def test_autoscale_split_triggers_and_converges(jref, fake_clock,
                                                drain_driver):
    sides = _pair(fake_clock, drain_driver)
    outs = []
    for s in sides:
        assert s.buckets() == [32]                   # merged
        scaler, report, futs, reqs = _split(s, dwell_s=0.5,
                                            rate_alpha=1.0)
        assert report is not None and len(report["moved"]) == 3
        assert s.buckets() == [24, 32]
        assert scaler.replans[-1]["kind"] == "split"
        # generations: every live handle still round-trips the directory
        for h in s.fleet.handles():
            assert s.fleet.bucket(h.bucket).bank.slot_generation(
                h.slot) == h.generation
        # nothing stranded: every queued future resolves CORRECTLY
        s.drain()
        assert s.srv.stranded == 0
        assert all(f.exception(timeout=0) is None for f in futs)
        # convergence: sustained pressure re-prices to the SAME buckets
        s.clock.advance(1.0)
        more, _ = _pressurize(s, scaler)
        assert scaler.tick(now=s.clock.monotonic()) is None
        assert len(scaler.replans) == 1
        # ...and the split-time dispatch budget itself is a fixed point
        fixed = scaler.replan(scaler.replans[-1]["dispatch_s"])
        assert set(b.key for b in fixed.buckets) == set(s.fleet.buckets)
        s.drain()
        outs.append((scaler, futs + more, reqs))
    (scaler, futs, reqs), (jscaler, jfuts, _) = outs
    _same_replans(scaler, jscaler)
    assert _keys(sides[0].fleet.buckets) == _keys(sides[1].fleet.buckets)
    _same_served(futs, jfuts, sides[0].Ls, reqs)
    assert sides[0].srv.stats() == sides[1].srv.stats()


def test_autoscale_merge_triggers_and_converges(jref, fake_clock,
                                                drain_driver):
    sides = _pair(fake_clock, drain_driver)
    outs = []
    for s in sides:
        scaler, _, _, _ = _split(s, dwell_s=0.5, rate_alpha=1.0)
        s.drain()
        assert s.buckets() == [24, 32]
        # idle: the offered EWMA decays to ~0 -> merge back to one bucket
        s.clock.advance(5.0)
        report = None
        for _ in range(4):
            s.clock.advance(5.0)
            report = scaler.tick(now=s.clock.monotonic())
            if report is not None:
                break
        assert report is not None
        assert s.buckets() == [32]
        assert scaler.replans[-1]["kind"] == "merge"
        assert s.srv.stranded == 0
        # converged: further idle ticks are no-ops
        s.clock.advance(5.0)
        assert scaler.tick(now=s.clock.monotonic()) is None
        # the re-merged bucket still serves every order correctly
        b = s.rng.standard_normal((24, 1)).astype(np.float32)
        f = s.submit(24, 1, b)
        s.drain()
        assert f.exception(timeout=0) is None
        assert _rel(s.Ls[(24, 1)], f.result(timeout=0), b) < RELRES
        outs.append((scaler, f))
    (scaler, f), (jscaler, jf) = outs
    _same_replans(scaler, jscaler)
    assert _keys(sides[0].fleet.buckets) == _keys(sides[1].fleet.buckets)
    assert_close(f.result(timeout=0), _np(jf.result(timeout=0)), TOL)


@pytest.mark.parametrize("occupancy", [1, 6])
def test_migrate_under_flight_strands_nothing(jref, fake_clock,
                                              drain_driver, occupancy):
    man = {32: min(occupancy, 3), 24: max(occupancy - 3, 0)}
    man = {d: c for d, c in man.items() if c}
    sides = _pair(fake_clock, drain_driver, man=man)
    outs = []
    for s in sides:
        # attach=False: this test drives replan/apply BY HAND while a
        # wave is in flight — no step-driven ticks interfering
        scaler = s.scaler(attach=False)
        keys = sorted(s.handles)
        # queue several waves' worth, dispatch ONE (leaves it in flight)
        futs, reqs = [], []
        for j in range(4):
            for (d, i) in keys:
                b = s.rng.standard_normal((d, 2)).astype(np.float32)
                reqs.append(((d, i), b))
                futs.append(s.submit(d, i, b))
        s.drv.step(advance=0.001)
        assert s.srv._inflight
        # force a migration while that wave is in flight: re-price at
        # zero dispatch budget (full split by order)
        plan = scaler.replan(0.0)
        moved = None
        if len(man) > 1:
            assert len(plan.buckets) == 2    # it IS a real split
            report = scaler.apply(plan)
            moved = [(o.bucket[0], o.slot, n.bucket[0], n.slot,
                      n.generation) for o, n in report["moved"]]
            assert len(report["moved"]) == man[24]
        s.drain()
        assert s.srv.stranded == 0
        for ((d, i), b), f in zip(reqs, futs):
            assert f.exception(timeout=0) is None
            X = f.result(timeout=0)
            assert tuple(X.shape) == (d, 2)
            assert _rel(s.Ls[(d, i)], X, b) < RELRES
        assert s.srv.pending() == 0 and not s.srv._inflight
        outs.append((futs, reqs, moved))
    (futs, reqs, moved), (jfuts, _, jmoved) = outs
    assert moved == jmoved
    _same_served(futs, jfuts, sides[0].Ls, reqs)
    assert sides[0].srv.stats() == sides[1].srv.stats()


def test_non_migrating_waves_build_nothing(jref, fake_clock,
                                           drain_driver):
    """After a split, steady waves build no program (the reference's
    zero-retrace half; the no-host-sync half is checked on the card)."""
    side, jside = _pair(fake_clock, drain_driver)
    # dwell blocks every replan after the first: steady-state waves
    # must run with NO further migrations
    replans = []
    for s in (side, jside):
        scaler = s.scaler(dwell_s=1e9, rate_alpha=1.0)
        s.submit(32, 0, s.rng.standard_normal((32, 2))
                 .astype(np.float32))
        s.drain()
        _pressurize(s, scaler, count=3)
        assert scaler.tick(now=s.clock.monotonic()) is not None
        s.drain()
        replans.append(scaler)
    _same_replans(*replans)
    # steady state AFTER the migration: no build, nothing stranded
    specs = [side.fleet.solver(key).spec_for(side.srv.panel_k)
             for key in side.fleet.buckets]
    builds0 = sum(session.BUILD_COUNTS[k] for k in specs)
    pool = {d: torch.as_tensor(side.rng.standard_normal((d, 4))
                               .astype(np.float32)) for d in (32, 24)}
    steady = []
    for j in range(6):
        for (d, i) in sorted(side.handles):
            steady.append(side.submit(d, i, pool[d]))
        side.drain()
    assert sum(session.BUILD_COUNTS[k] for k in specs) == builds0
    for f in steady:
        assert f.exception(timeout=0) is None
    assert side.srv.stranded == 0 and len(replans[0].replans) == 1


def test_autoscaler_stats_json_serializable(jref, fake_clock,
                                            drain_driver):
    side, jside = _pair(fake_clock, drain_driver)
    scaler, jscaler = side.scaler(), jside.scaler()
    ctrl = api.AdmissionController(slo_ms=5.0)
    json.dumps(scaler.stats())
    json.dumps(ctrl.stats())
    json.dumps(side.srv.stats())
    assert scaler.stats() == jscaler.stats()
    assert ctrl.stats() == japi.AdmissionController(slo_ms=5.0).stats()
