#!/usr/bin/env python3
"""One run of a benchmark cell with the program's own spans
(``repro_torch.core.trace``) read beside the benchmark's.

    PYTHONPATH=src python3 chip_probes/program_spans.py \\
        --workload smollm-360m-kfac.precondition --seed 12345 \\
        --seconds 10 --profile 1 --program-trace 1

It runs ``solvebench.harness.run_cell`` unchanged, in this process,
with the program's tracing switched on before the cell's set-up
(``--program-trace 1``) and the profiler window on or off
(``--profile``), and prints the harness's result line with a
``"program"`` object beside it:

* ``solve_idle``: 100 x the share of the window in which the device
  was idle while the host was inside a ``solver.solve`` span (the
  device trace's idle intervals against the spans, laid on the trace's
  clock by the harness's ``cudaDeviceSynchronize`` anchor), a part of
  ``device_idle``;
* ``plan_us``: the mean ``solver.plan`` span in the window, in us;
* ``program_builds``: ``program.build`` spans in the window;
* ``banking_s`` and ``cholesky_s``: the total of ``kfac.bank`` and of
  ``kfac.cholesky`` spans (set-up);
* ``idle_gaps``: the window's longest idle gaps, each named by the
  innermost span, the program's or the harness's, that covered it;
  ``idle_intervals`` and ``offset_ns``: every idle interval of the
  window in trace us, and the offset from perf_counter ns to trace ns;
  ``window_ns`` and ``span_list``: the window and every span, as
  (name, start, end, id, parent), on perf_counter ns (these two and
  the intervals only in ``--out``'s file).

The harness's own record (``breakdown``, the per-layer metrics) reads
what it reads untraced by the program.  ``--program-trace 0`` runs the
cell as ``solvebench/run.py`` does, for the cost of tracing: the same
seed's ``solved_cols_per_s`` and ``setup_s`` on and off.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def idle_intervals(events, window) -> list:
    """[start, end] of every gap in the window, in trace us, in which no
    kernel, copy or memset ran on the device."""
    from solvebench import tracing
    w0, w1 = window
    busy = tracing.merge(
        (max(float(ev["ts"]), w0),
         min(float(ev["ts"]) + float(ev.get("dur", 0.0)), w1))
        for ev in events
        if ev.get("ph") == "X" and ev.get("cat") in tracing.DEVICE_CATS
        and float(ev["ts"]) < w1
        and float(ev["ts"]) + float(ev.get("dur", 0.0)) > w0)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append([prev, s])
        prev = max(prev, e)
    if w1 > prev:
        gaps.append([prev, w1])
    return gaps


def host_spans(spans) -> list:
    """The program's spans as the harness keeps its own: (name, start
    ns, end ns) on perf_counter."""
    return [(s.name, s.start, s.end) for s in spans]


def on_trace_clock(spans, offset_ns) -> list:
    """(name, start, end) in trace us of each span (perf_counter ns)."""
    return [(s.name, (s.start + offset_ns) * 1e-3,
             (s.end + offset_ns) * 1e-3) for s in spans]


def solve_idle_pct(idle, spans, offset_ns, window):
    """100 x the share of ``window`` (trace us) in ``idle`` intervals
    that a ``solver.solve`` span covers; None without a window."""
    from solvebench import tracing
    w0, w1 = window
    if w1 <= w0:
        return None
    solve = tracing.merge((a, b) for n, a, b in on_trace_clock(
        spans, offset_ns) if n == "solver.solve")
    both = i = j = 0
    while i < len(idle) and j < len(solve):    # both sorted, disjoint
        (s, e), (a, b) = idle[i], solve[j]
        lo, hi = max(s, a, w0), min(e, b, w1)
        if hi > lo:
            both += hi - lo
        if e < b:
            i += 1
        else:
            j += 1
    return 100.0 * both / (w1 - w0)


def inside(spans, name, t0, t1) -> list:
    """The spans called ``name`` that started in [t0, t1) (perf ns)."""
    return [s for s in spans if s.name == name and t0 <= s.start < t1]


def plan_us(spans, t0, t1):
    plans = inside(spans, "solver.plan", t0, t1)
    if not plans:
        return None
    return sum(s.end - s.start for s in plans) * 1e-3 / len(plans)


def program_builds(spans, t0, t1) -> int:
    return len(inside(spans, "program.build", t0, t1))


def total_s(spans, name):
    got = [s.end - s.start for s in spans if s.name == name]
    return sum(got) * 1e-9 if got else None


def setup_split(spans, t_start, t0):
    """Set-up (``t_start``, time.monotonic s, to the window's start
    ``t0``, perf ns: one clock, CLOCK_MONOTONIC) in seconds: before the
    first ``kfac.bank`` (imports, the card, statistics), the banking
    spans, what lies between them (slicing the statistics), and after
    the last (solvers, right-hand sides, the warm-up steps, of which
    ``warmup_s`` from the first ``solver.solve``); None without
    banking spans.  With the profiler on, "after" holds its start."""
    bank = sorted((s.start, s.end) for s in spans if s.name == "kfac.bank")
    if not bank:
        return None
    solves = [s.start for s in spans
              if s.name == "solver.solve" and bank[-1][1] <= s.start < t0]
    banking = sum(b - a for a, b in bank)
    return {"before_banking_s": (bank[0][0] - t_start * 1e9) * 1e-9,
            "banking_s": banking * 1e-9,
            "between_banks_s": (bank[-1][1] - bank[0][0] - banking) * 1e-9,
            "after_banking_s": (t0 - bank[-1][1]) * 1e-9,
            "warmup_s": (t0 - min(solves)) * 1e-9 if solves else None}


def run(bench, cell, cfg, traffic, *, seed, seconds, profile,
        program_trace, device, t_start) -> dict:
    """``harness.run_cell`` with the program's spans on (or off), its
    result with a ``"program"`` object of the readings above."""
    from repro_torch.core import trace
    from solvebench import harness, tracing

    seen: dict = {}
    reduce_events = tracing.reduce_events

    def reduce_with_program(events, window, spans=(), offset_ns=None):
        prog = trace.take()
        seen.update(events=events, window=window, offset=offset_ns,
                    program=prog)
        return reduce_events(events, window, list(spans) + host_spans(prog),
                             offset_ns)

    class Kept(tracing.Profiled):
        def __exit__(self, *exc):
            seen["prof"] = self
            return super().__exit__(*exc)

    tracing.reduce_events, profiled = reduce_with_program, tracing.Profiled
    tracing.Profiled = Kept
    trace.take()
    if program_trace:
        trace.enable()
    try:
        out = harness.run_cell(bench, cell, cfg, traffic, seed=seed,
                               seconds=seconds, trace=profile,
                               device=device, t_start=t_start)
    finally:
        trace.disable()
        tracing.reduce_events, tracing.Profiled = reduce_events, profiled
    spans = seen.get("program", []) + trace.take()
    prof = seen["prof"]
    t0, t1 = prof.t0, prof.t1
    prog = {"plan_us": plan_us(spans, t0, t1),
            "program_builds": program_builds(spans, t0, t1)
            if program_trace else None,
            "banking_s": total_s(spans, "kfac.bank"),
            "cholesky_s": total_s(spans, "kfac.cholesky"),
            "spans": {n: sum(1 for s in spans if s.name == n)
                      for n in sorted({s.name for s in spans})}}
    if "events" in seen and seen["offset"] is not None:
        idle = idle_intervals(seen["events"], seen["window"])
        prog.update(
            solve_idle=solve_idle_pct(idle, spans, seen["offset"],
                                      seen["window"]),
            idle_gaps=out["breakdown"]["idle_gaps"],
            idle_intervals=idle, offset_ns=seen["offset"])
    prog["setup_split"] = setup_split(spans, t_start, t0)
    prog["window_ns"] = [t0, t1]
    prog["span_list"] = [(s.name, s.start, s.end, s.id, s.parent)
                         for s in spans]
    out["program"] = prog
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--program-trace", type=int, choices=(0, 1),
                    default=1)
    ap.add_argument("--out", help="also write the record (with every "
                    "idle interval) to this JSON file")
    args = ap.parse_args(argv)
    from solvebench import harness
    bench, cell, cfg, traffic = harness.load_cell(ROOT, args.workload)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = run(bench, cell, cfg, traffic, seed=args.seed,
              seconds=args.seconds, profile=bool(args.profile),
              program_trace=bool(args.program_trace), device=device,
              t_start=T_START)
    out["card"] = harness.card_line()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out))
    for key in ("idle_intervals", "span_list"):
        out["program"].pop(key, None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
