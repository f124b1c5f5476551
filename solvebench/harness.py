"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result's line.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (the file ``BENCHMARK.json`` names), its
traffic in ``traffic/<traffic>.json``, whose ``loop`` names the module
of ``loops/`` that drives it, and each metric in ``metrics/<name>.py``,
whose ``read(ctx)`` returns the metric's value or None.  A later cell,
mix or metric is a new file and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_traffic(root: pathlib.Path, name: str) -> dict:
    return load_json(root / HERE.name / "traffic" / f"{name}.json")


def load_cell(root: pathlib.Path, workload: str):
    """(benchmark, cell, configuration, traffic) for a cell's name, from
    the checkout at ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    cell = find(bench["workloads"], workload, "workload")
    cfg_entry = find(bench["configs"], cell["config"], "config")
    cfg = load_json(root / cfg_entry["file"])
    return bench, cell, cfg, load_traffic(root, cell["traffic"])


def metric_reader(name: str, root: pathlib.Path = HERE.parent):
    """The ``read`` function of ``metrics/<name>.py`` in the checkout
    at ``root``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "solvebench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end ones
    without trace, the per-layer ones with it; an entry with a
    ``workloads`` key only in the cells it lists."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    reported = {m["name"] for m in metrics_for(bench, cell, False)}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def forbidden_modules() -> list:
    """Modules of JAX or the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi: not read"


def run_cell(bench: dict, cell: dict, cfg: dict, traffic: dict, *,
             seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False,
             root: pathlib.Path = HERE.parent) -> dict:
    """Set up, measure for ``seconds``, check, and return the result
    object (without printing it)."""
    import torch

    from solvebench import tracing
    loop = importlib.import_module(f"solvebench.loops.{traffic['loop']}")
    spans = tracing.Spans()
    runner = loop.Runner(cfg, traffic, seed=seed, seconds=seconds,
                           device=device, control=control, spans=spans)
    runner.setup()
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
    gc.collect()
    setup_s = time.monotonic() - t_start
    gc.disable()
    try:
        with tracing.Profiled(trace and on_cuda, spans) as prof:
            window = runner.window(prof)
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    checks = runner.check()
    ctx = dict(window, setup_s=setup_s, cell=cell["name"],
               trace=prof.record, config=cfg, traffic=traffic)
    metrics = {}
    for m in metrics_for(bench, cell, trace):
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()) and not window.get("errors")
    device_rec = {"platform": "gpu" if on_cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_cuda
                  else "cpu",
                  "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics,
           "device": device_rec}
    if prof.record is not None:
        device_rec["busy_s"] = prof.record["busy_s"]
        device_rec["window_s"] = prof.record["window_s"]
        out["breakdown"] = {"device_ops": prof.record["device_ops"],
                            "idle_gaps": prof.record["idle_gaps"]}
    out["checks"] = checks
    return out
