"""The port's host spans (``repro_torch.core.trace``) on the CPU: the
module itself, the spans of ``Solver.solve``, the refined solve, the
program cache and the K-FAC banking, and the probe that reads them
beside the benchmark's device trace (``chip_probes/program_spans.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""

import importlib
import importlib.util
import json
import pathlib
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = api.make_trsm_mesh(1, 1, device="cpu")


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _factor(n, seed=0):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    return L.astype(np.float32), rng


def _by_name(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ------------------------------ the module ------------------------------

def test_off_records_nothing_and_returns_one_object():
    assert not trace.enabled()
    got = {id(trace.span("solver.solve")) for _ in range(100)}
    got.add(id(trace.span("kfac.bank", {"a": 1}, sync="cpu")))
    assert got == {id(trace.OFF)}
    with trace.span("solver.solve") as sp:
        with trace.span("solver.plan"):
            pass
    assert sp is trace.OFF
    assert trace.take() == []


def test_off_reads_no_clock(monkeypatch):
    def refuse():
        raise AssertionError("a clock was read with tracing off")
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    with trace.span("solver.solve"):
        pass
    trace.enable()
    with pytest.raises(AssertionError, match="clock"):
        with trace.span("solver.solve"):
            pass


def test_on_nesting_gives_parents_and_times():
    trace.enable()
    with trace.span("outer", {"k": 3}):
        with trace.span("inner"):
            pass
        with trace.span("inner"):
            pass
    with trace.span("after"):
        pass
    spans = trace.take()
    assert [s.name for s in spans] == ["inner", "inner", "outer", "after"]
    outer = spans[2]
    assert outer.parent is None and outer.attrs == {"k": 3}
    for inner in spans[:2]:
        assert inner.parent == outer.id
        assert outer.start <= inner.start <= inner.end <= outer.end
    assert spans[3].parent is None
    assert len({s.id for s in spans}) == 4


def test_threads_keep_separate_stacks():
    trace.enable()
    inside, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("thread.outer"):
            inside.set()
            release.wait(5)
            with trace.span("thread.inner"):
                pass

    with trace.span("main.outer"):
        t = threading.Thread(target=worker)
        t.start()
        inside.wait(5)
        with trace.span("main.inner"):
            release.set()
            t.join(5)
    s = {sp.name: sp for sp in trace.take()}
    assert s["thread.outer"].parent is None
    assert s["thread.inner"].parent == s["thread.outer"].id
    assert s["main.inner"].parent == s["main.outer"].id


def test_take_clears_and_an_exception_still_records():
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("fails"):
            raise ValueError("inside")
    assert [s.name for s in trace.take()] == ["fails"]
    assert trace.take() == []
    with trace.span("again", sync="cpu"):       # no CUDA device: no wait
        pass
    trace.disable()
    assert [s.name for s in trace.take()] == ["again"]


# ------------------------- the program's spans -------------------------

@pytest.mark.parametrize("precision", ["bf16_refine", "fp32"])
def test_refined_solve_spans_and_answers_bit_identical(precision):
    n, k = 64, 8
    L, rng = _factor(n, seed=3)
    B = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32))
    solver = api.Solver.from_factor(L, CPU, n0=16, precision=precision,
                                    cache=api.CompiledSolverCache())
    solver.warmup(k)
    off = solver.solve(B)
    trace.enable()
    on = solver.solve(B)
    trace.disable()
    assert torch.equal(on, off)
    spans = trace.take()
    by = _by_name(spans)
    steps = solver.policy.refine_steps
    assert (steps > 0) == (precision == "bf16_refine")
    solve, = by["solver.solve"]
    plan, = by["solver.plan"]
    assert solve.parent is None and plan.parent == solve.id
    assert len(by["refine.sweep"]) == 1 + steps
    assert len(by.get("refine.residual", [])) == steps
    assert [s.attrs["pass"] for s in by["refine.sweep"]] == \
        list(range(1 + steps))
    for s in by["refine.sweep"] + by.get("refine.residual", []):
        assert s.parent == solve.id
        assert plan.end <= s.start and s.end <= solve.end
    assert "program.build" not in by            # warmed up
    assert set(by) <= {"solver.solve", "solver.plan", "refine.sweep",
                       "refine.residual"}


def test_program_build_spans_count_the_cache_misses():
    n = 32
    L, rng = _factor(n, seed=5)
    cache = api.CompiledSolverCache()
    trace.enable()
    solver = api.Solver.from_factor(L, CPU, n0=8, precision="bf16_refine",
                                    cache=cache)
    before = cache.stats()["misses"]
    for k in (4, 8):
        solver.warmup(k)
    builds = [s for s in trace.take() if s.name == "program.build"]
    assert len(builds) == cache.stats()["misses"] - before == 2
    assert sorted(s.attrs["k"] for s in builds) == [4, 8]
    assert all(s.attrs["kind"] == "solve" and s.attrs["n"] == n
               and s.attrs["width"] == solver.width for s in builds)
    assert trace.take() == []
    for k in (4, 8, 4):
        solver.solve(torch.as_tensor(
            rng.standard_normal((n, k)).astype(np.float32)))
    spans = trace.take()
    assert cache.stats()["misses"] - before == 2
    assert not [s for s in spans if s.name == "program.build"]
    assert sum(s.name == "solver.plan" for s in spans) == 3


def _kfac_state():
    kfac = importlib.import_module("repro_torch.optim.kfac_ca")
    from repro_torch.optim.tree import tree_map
    g = torch.Generator().manual_seed(13)
    params = {"w": torch.randn((32, 16), generator=g),
              "stack": torch.randn((2, 32, 16), generator=g),
              "norm": torch.ones((32,))}
    opt = kfac.kfac_ca()
    state = opt.init(params)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g), params)
    _, state, _ = opt.update(grads, state, params)
    return kfac, state


def test_kfac_banking_spans_one_cholesky_per_factor():
    kfac, state = _kfac_state()
    factors = list(kfac._iter_kron_factors(state))
    assert len(factors) == 4
    trace.enable()
    banks, manifest = kfac.factor_banks_from_state(state, grid=CPU)
    spans = trace.take()
    by = _by_name(spans)
    bank, = by["kfac.bank"]
    chol = by["kfac.cholesky"]
    assert bank.parent is None
    assert len(chol) == len(factors)
    assert all(c.parent == bank.id and bank.start <= c.start
               and c.end <= bank.end for c in chol)
    assert sorted(banks) == [16, 32]
    # banking builds each bank's updater inside the banking span
    assert all(b.parent == bank.id for b in by.get("program.build", []))
    kfac.refresh_banks(banks, manifest, state)   # refresh: no such spans
    assert not [s for s in trace.take()
                if s.name in ("kfac.bank", "kfac.cholesky")]


# --------------------- the probe beside the harness ---------------------

def _probe():
    spec = importlib.util.spec_from_file_location(
        "program_spans_probe", ROOT / "chip_probes" / "program_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, start, end):
    return types.SimpleNamespace(name=name, start=start, end=end)


def test_probe_readers_on_synthetic_spans():
    probe = _probe()
    # window [1000, 2000) ns; trace clock = perf ns + 500, in us
    spans = [_span("kfac.bank", 0, 400), _span("kfac.cholesky", 10, 110),
             _span("kfac.cholesky", 200, 250),
             _span("solver.plan", 1100, 1104),
             _span("solver.plan", 1500, 1510),
             _span("solver.plan", 2100, 2200),          # after the window
             _span("program.build", 900, 950),          # in set-up
             _span("program.build", 1600, 1700)]
    assert probe.plan_us(spans, 1000, 2000) == pytest.approx(0.007)
    assert probe.program_builds(spans, 1000, 2000) == 1
    assert probe.program_builds(spans, 1800, 2000) == 0
    assert probe.total_s(spans, "kfac.bank") == pytest.approx(400e-9)
    assert probe.total_s(spans, "kfac.cholesky") == pytest.approx(150e-9)
    assert probe.total_s(spans, "refine.sweep") is None
    assert probe.plan_us(spans, 3000, 4000) is None


def test_probe_solve_idle_is_zero_without_solves_and_a_part_of_idle():
    probe = _probe()
    window = (10.0, 20.0)                               # trace us
    idle = [[10.0, 11.0], [14.0, 15.0], [19.0, 20.0]]
    assert probe.solve_idle_pct(idle, [], 0, window) == 0.0
    # solver.solve spans at 10.5-14.5 us and 18-30 us (perf ns 10500...)
    solves = [_span("solver.solve", 10500, 14500),
              _span("solver.solve", 18000, 30000),
              _span("solver.plan", 10500, 10600)]
    got = probe.solve_idle_pct(idle, solves, 0, window)
    assert got == pytest.approx(100.0 * (0.5 + 0.5 + 1.0) / 10.0)
    device_idle = 100.0 * sum(e - s for s, e in idle) / 10.0
    assert got <= device_idle
    # the offset moves the spans onto the trace's clock
    moved = [_span(s.name, s.start - 1000, s.end - 1000) for s in solves]
    assert probe.solve_idle_pct(idle, moved, 1000, window) == \
        pytest.approx(got)


def test_probe_idle_intervals_and_gap_names_from_program_spans():
    """The harness's ``reduce_events`` given program spans names each
    gap by the innermost span over it; busy, window and the device ops
    are as without them."""
    probe = _probe()                  # puts the repo's root on sys.path
    from solvebench import tracing
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 12, "dur": 8},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 30, "dur": 10},
          {"ph": "X", "cat": "cuda_runtime", "name": "x", "ts": 21,
           "dur": 3}]
    window = (0.0, 50.0)
    assert probe.idle_intervals(ev, window) == [[10.0, 12.0], [20.0, 30.0],
                                                [40.0, 50.0]]
    harness_spans = [("solve", 0, 40000)]
    prog = [_span("solver.solve", 5000, 39000),
            _span("refine.residual", 19000, 26000),
            _span("solver.plan", 9000, 13000)]
    plain = tracing.reduce_events(ev, window, harness_spans, 0)
    named = tracing.reduce_events(
        ev, window, harness_spans + probe.host_spans(prog), 0)
    for key in ("busy_s", "window_s", "device_ops"):
        assert named[key] == plain[key]
    assert [g[0] for g in plain["idle_gaps"]] == ["solve", "host", "solve"]
    assert [g[0] for g in named["idle_gaps"]] == \
        ["refine.residual", "host", "solver.plan"]


def test_probe_runs_a_tiny_cell_on_the_cpu():
    """The probe around ``harness.run_cell`` at a tiny size: the set-up
    spans and the window's plans are read, no program is built in the
    window, and the run is as correct as without the spans."""
    t0 = time.monotonic()
    probe = _probe()
    from solvebench import harness, statistics
    bench, cell, cfg, traffic = harness.load_cell(
        ROOT, "smollm-360m-kfac.precondition")
    cfg = json.loads(json.dumps(cfg))
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96, num_hidden_layers=2)
    cfg["kfac"] = dict(cfg["kfac"], max_dim=128)
    out = probe.run(bench, cell, cfg, traffic, seed=2**31 + 7, seconds=0.2,
                    profile=True, program_trace=True, device="cpu",
                    t_start=t0)
    assert out["correct"], out
    prog = out["program"]
    assert prog["program_builds"] == 0
    assert prog["plan_us"] > 0
    assert 0 < prog["cholesky_s"] < prog["banking_s"] \
        < time.monotonic() - t0
    assert prog["spans"]["kfac.bank"] == len(statistics.weight_groups(cfg))
    assert not trace.enabled()
    assert "solve_idle" not in prog              # no device trace here
    split = prog["setup_split"]
    assert split["banking_s"] == pytest.approx(prog["banking_s"])
    assert all(v >= 0 for v in split.values())
    assert split["before_banking_s"] + split["banking_s"] \
        + split["between_banks_s"] + split["after_banking_s"] \
        <= time.monotonic() - t0
    off = probe.run(bench, cell, cfg, traffic, seed=2**31 + 7, seconds=0.2,
                    profile=False, program_trace=False, device="cpu",
                    t_start=time.monotonic())
    assert off["correct"] and off["program"]["spans"] == {}
