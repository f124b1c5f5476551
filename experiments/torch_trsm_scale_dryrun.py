"""Pod-scale dry run of the port's TRSM engine: trace It-Inv-TRSM and
Rec-TRSM as rank 0 of 256-rank (8x8x4) and 512-rank (16x16x2) abstract
grids at n = 65536, on meta tensors (nothing computed, no process
started), and set the traced alpha-beta-gamma costs beside the
Sec. VII closed forms at production scale.

    PYTHONPATH=src python experiments/torch_trsm_scale_dryrun.py

A rank's piece bytes (its "L", "B" and "X" pieces in fp32) stand where
the reference prints XLA's temp bytes.  The records go to
build/torch_trsm_scale.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import comm, cost_model as cm, grid as gridlib
from repro_torch.core import inv_trsm, rec_trsm, tuning
from repro_torch.core.solver import plan_grid

OUT = os.path.join(os.path.dirname(__file__), "..", "build",
                   "torch_trsm_scale.json")


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def run_one(p1, p2, n, k, results):
    p = p1 * p1 * p2
    grid = gridlib.abstract_grid(p1, p2)
    plan = tuning.tune_for_grid(n, k, plan_grid(p1, p2))
    n0 = plan.n0
    L, B = _meta(n, n), _meta(n, k)
    pieces = sum(gridlib.local_piece(A, grid, layout).nbytes
                 for A, layout in ((L, "L"), (B, "B"), (B, "X")))
    for name, solve in [
            ("it_inv", lambda: inv_trsm.solve(L, B, grid, n0)),
            ("rec", lambda: rec_trsm.solve(L, B, grid))]:
        t0 = time.time()
        tr = comm.traced_cost(solve)
        dt = time.time() - t0
        model = (cm.it_inv_trsm_cost(n, k, n0, p1, p2, plan.r1, plan.r2)
                 if name == "it_inv" else cm.rec_trsm_cost(n, k, p))
        results.append(dict(
            algo=name, p1=p1, p2=p2, p=p, n=n, k=k, n0=n0,
            trace_s=round(dt, 2), traced=dict(S=tr.s, W=tr.w, F=tr.f),
            traced_by_op=tr.by_op(),
            model=dict(S=model.s, W=model.w, F=model.f),
            piece_gb=pieces / 1e9))
        print(f"{name} p={p} ({p1}x{p1}x{p2}) n={n} k={k} n0={n0}: "
              f"trace {dt:.1f}s | traced S={tr.s:.0f} W={tr.w:.3e} | "
              f"model S={model.s:.0f} W={model.w:.3e} | "
              f"pieces/rank {pieces / 1e9:.2f} GB", flush=True)


def main():
    results = []
    # single pod: 256 ranks as 8x8x4; multi-pod: 512 as 16x16x2
    run_one(8, 4, 1 << 16, 1 << 11, results)
    run_one(16, 2, 1 << 16, 1 << 11, results)
    # latency-bound shape (k << n), the paper's headline regime
    run_one(8, 4, 1 << 16, 1 << 8, results)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1, default=float)
    print(f"-> {os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
