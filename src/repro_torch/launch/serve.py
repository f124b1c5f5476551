"""Serving CLI: TRSM solve requests against one resident factor.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm \
        --n 8192 --panel-k 16 --requests 64 [--n0 4096] \
        [--method inv|rec|auto] \
        [--precision fp32|bf16|bf16_refine|fp64_refine] [--cache-stats] \
        [--structure dense|banded[:BW]|block-sparse] [--device cuda:0|cpu]

The factor is L = tril(randn) + n I from seed 0; requests have random
widths 1..panel_k.  ``--method rec`` serves through the recursive
baseline (its base cases on the substitution kernel), ``auto`` lets
the cost model choose at k = panel_k.  ``--structure`` declares a
block structure; admission masks the factor to it, so the solves are
against the masked operator.  Prints requests served, panels and ms
per panel.
The other workloads of ``repro.launch.serve`` are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# workload -> the ROADMAP item that ports it
_NOT_PORTED = {"lm": "A15", "trsm-bank": "A7", "trsm-churn": "A7",
               "trsm-fleet": "A11", "trsm-traffic": "A10"}


def _print_cache_stats():
    from repro_torch import api
    st = api.default_cache().stats()
    print(f"compiled-solver cache: size={st['size']} hits={st['hits']} "
          f"misses={st['misses']} evictions={st['evictions']} "
          f"hit_rate={st['hit_rate']:.3f}")


def serve_trsm(args):
    """Serve TRSM solve requests against a device-resident factor."""
    from repro_torch import api
    grid = api.make_trsm_mesh(1, 1, device=args.device)
    rng = np.random.default_rng(0)
    n = args.n
    gen = torch.Generator(device=grid.device).manual_seed(0)
    L = torch.randn((n, n), generator=gen, device=grid.device,
                    dtype=torch.float64).tril_()
    L.diagonal().add_(n)
    if args.precision != "fp64_refine":
        L = L.float()
    structure = api.FactorStructure.parse(args.structure, n=n) \
        if args.structure else None
    solver = api.Solver.from_factor(L, grid, method=args.method,
                                    n0=args.n0, precision=args.precision,
                                    k_hint=args.panel_k,
                                    structure=structure)
    server = api.SolveServer(solver, args.panel_k).warmup()
    widths = rng.integers(1, args.panel_k + 1, args.requests)
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    t0 = time.perf_counter()
    for w in widths:
        server.submit(torch.randn((n, int(w)), generator=gen,
                                  device=grid.device))
    server.drain()
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    dt = time.perf_counter() - t0
    panels = server.panels_solved
    policy = solver.policy
    print(f"served {server.requests_served} solve requests "
          f"({int(widths.sum())} columns) in {panels} panels, "
          f"{dt:.3f}s ({dt / max(panels, 1) * 1e3:.2f} ms/panel) "
          f"on {grid.device} n={n} "
          f"n0={solver.spec_for(args.panel_k).n0} "
          f"method={solver.method} precision={policy.name} "
          f"structure={args.structure or 'dense'} "
          f"({policy.describe()})")
    if args.cache_stats:
        _print_cache_stats()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="trsm",
                    choices=["trsm", *_NOT_PORTED])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--n0", type=int, default=None)
    ap.add_argument("--panel-k", type=int, default=16)
    ap.add_argument("--method", default="inv",
                    choices=["inv", "rec", "auto"],
                    help="It-Inv-TRSM, the recursive baseline, or the "
                         "cost model's choice")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "bf16_refine", "fp64_refine"],
                    help="mixed-precision policy of the solve pipeline")
    ap.add_argument("--structure", default=None,
                    metavar="dense|banded[:BW]|block-sparse",
                    help="factor block structure for the trsm workload "
                         "(level-scheduled sweep; DESIGN.md Sec. 14)")
    ap.add_argument("--cache-stats", action="store_true",
                    help="print compiled-solver cache stats after the "
                         "drain")
    ap.add_argument("--device", default=None,
                    help="device of the 1 x 1 x 1 grid (default cuda:0)")
    args = ap.parse_args(argv)
    if args.workload != "trsm":
        ap.error(f"workload {args.workload!r} is not ported yet (ROADMAP "
                 f"{_NOT_PORTED[args.workload]})")
    serve_trsm(args)


if __name__ == "__main__":
    main()
