#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` on the card this
machine holds, and print its result as the last line of standard output.

    python3 solvebench/run.py --workload granite-8b-kfac.precondition \\
        --seed 12345 --seconds 10 --trace 0

The cell, its configuration and its traffic are found by name from
``BENCHMARK.json`` at the root of the checkout.  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from
a profiled window.  Every run checks the answers of its window against
the plain reference (``solvebench/reference.py``) and prints each
number compared beside its limit as the last lines of standard error.
``--control`` runs the configuration's lower-precision control in the
program's place; its runs must come out not correct.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from solvebench import harness
    bench, cell, cfg, traffic = harness.load_cell(ROOT, args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"solvebench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (the program; absent: ImportError)
    card = harness.card_line()
    result = harness.run_cell(bench, cell, cfg, traffic, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda", t_start=T_START,
                              control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"solvebench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for c in result["checks"].values():
        c["value"] = _finite(c["value"])
    print(f"card: {card}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
