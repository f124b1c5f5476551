"""The paper end to end on the PyTorch port: distributed TRSM,
triangular inversion, Cholesky, the 3D product and LU on a 2x2x2 grid
of ranks, the Sec. VIII tuning and the Sec. IX comparison, on one page.

    PYTHONPATH=src python examples/torch_trsm_demo.py              # the card
    PYTHONPATH=src python examples/torch_trsm_demo.py --device cpu

The grid's 8 ranks are processes of a gloo world
(``core.world.spawn_ranks``), all on one device: on the card they share
it and every exchange is staged through host memory.  Each rank checks
every result against numpy in fp64; the run exits 1 when any rank's
error misses its bound.
"""

import argparse
import datetime
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import (cholesky, cost_model as cm, grid as gridlib,
                              inv_trsm, lu, mm3d, rec_trsm, tri_inv, tuning,
                              world)
from repro_torch.kernels import tri_inv_block, trmm, trsm_block

P1, P2 = 2, 2
# each check's error, relative to the largest entry of what it is held to
BOUNDS = {"it_inv": 1e-12, "rec": 1e-12, "tri_inv": 1e-12,
          "cholesky": 1e-13, "mm3d": 1e-13, "lu": 1e-12}


def _np(x):
    return x.detach().cpu().double().numpy()


def rank_body(device, n=256, k=64):
    """One rank of the 2x2x2 grid: every distributed algorithm on the
    same seeded fp64 inputs, each result against numpy's."""
    grid = gridlib.make_trsm_mesh(
        P1, P2, device=device,
        timeout=datetime.timedelta(seconds=world.TIMEOUT_S))
    rng = np.random.default_rng(0)
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    B = rng.standard_normal((n, k))
    ref = np.linalg.solve(L, B)
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    Add = rng.standard_normal((n, n)) + n * np.eye(n)
    T = torch.as_tensor
    counters = (tri_inv_block.tri_inv_blocks, trmm.trmm,
                trsm_block.trsm_substitution)
    before = [c.launches for c in counters]

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    errors = {}
    errors["it_inv"] = rel(_np(inv_trsm.solve(T(L), T(B), grid, 32)), ref)
    errors["rec"] = rel(_np(rec_trsm.solve(T(L), T(B), grid, 32)), ref)
    errors["tri_inv"] = rel(_np(tri_inv.invert(T(L), grid)) @ L, np.eye(n))
    C = _np(cholesky.cholesky(T(A), grid))
    errors["cholesky"] = rel(C @ C.T, A)
    errors["mm3d"] = rel(_np(mm3d.matmul(T(L), T(B), grid)), L @ B)
    Lf, Uf = lu.lu(T(Add), grid)
    errors["lu"] = rel(_np(Lf) @ _np(Uf), Add)
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    after = [c.launches for c in counters]
    return dict(errors=errors, launches=dict(zip(
        ("B1", "B2", "B3"), (a - b for a, b in zip(after, before)))))


def run(device: str = "cuda") -> dict:
    """Spawn the grid's ranks and gather their checks; -> a summary
    with each check's worst error over the ranks, its bound, and the
    kernels' launches summed over the ranks."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "ranks on the CPU")
    ranks = world.spawn_ranks(P1 * P1 * P2, device, rank_body)
    errors = {name: max(r["errors"][name] for r in ranks) for name in BOUNDS}
    launches = {key: sum(r["launches"][key] for r in ranks)
                for key in ("B1", "B2", "B3")}
    print(f"== distributed solvers ({P1}x{P1}x{P2} grid, "
          f"{P1 * P1 * P2} gloo ranks on {device}) ==")
    names = {"it_inv": "It-Inv-TRSM (Secs. VI-VII, B1 + B2)",
             "rec": "Rec-TRSM baseline (Sec. IV, B3)",
             "tri_inv": "RecTriInv (Sec. V)",
             "cholesky": "Cholesky via selective inversion",
             "mm3d": "Sec. III 3D matmul",
             "lu": "LU via selective inversion"}
    for name, label in names.items():
        print(f"{label:38s} err={errors[name]:.2e} "
              f"(bound {BOUNDS[name]:.0e})")

    print("\n== Sec. VIII a-priori tuning ==")
    for (nn, kk, p) in [(1 << 14, 1 << 10, 256), (1 << 12, 1 << 14, 256),
                        (1 << 17, 1 << 8, 256)]:
        plan = tuning.tune(nn, kk, p)
        print(f"n={nn} k={kk} p={p}: regime={plan.regime} "
              f"grid={plan.grid} n0={plan.n0}")

    print("\n== Sec. IX comparison (closed forms, p=512) ==")
    table = []
    for nn in [1 << 12, 1 << 16, 1 << 19]:
        row = cm.paper_table_row(nn, 1 << 10, 512)
        s_ratio = row["standard"]["S"] / row["new"]["S"]
        w_ratio = row["standard"]["W"] / row["new"]["W"]
        table.append(dict(n=nn, regime=row["regime"], s_ratio=s_ratio,
                          w_ratio=w_ratio))
        print(f"n={nn}: regime={row['regime']} latency improvement "
              f"{s_ratio:.1f}x, bandwidth ratio {w_ratio:.2f}x")
    return dict(device=device, errors=errors, bounds=BOUNDS,
                ok=all(errors[name] <= BOUNDS[name] for name in BOUNDS),
                launches=launches, paper_table=table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps({"trsm_demo": out}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
