"""Quickstart on the PyTorch port: the paper's TRSM engine in five
minutes.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Solves L X = B on one device with It-Inv-TRSM (paper Secs. VI-VII; its
diagonal blocks inverted by kernel B1, its sweep's products on B2) and
the recursive baseline (Sec. IV; base cases on B3), each held against
``numpy.linalg.solve``, recovers fp32 accuracy from a bf16 sweep
(``precision="bf16_refine"``), and prints the Sec. VIII tuning decision
and both algorithms' alpha-beta-gamma costs on a 2x2x2 grid, traced as
one rank of an abstract grid on meta tensors: no processes, nothing
computed.  Exits 1 when an error misses its bound.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import core
from repro_torch.core import comm, grid as gridlib, inv_trsm, rec_trsm, tuning
from repro_torch.kernels import tri_inv_block, trmm, trsm_block

# max |X - X_ref| / max |X_ref| against numpy's fp64 solve
BOUNDS = {"inv": 1e-12, "rec": 1e-12, "bf16_refine": 1e-5}


def launches() -> dict:
    return {"B1": tri_inv_block.tri_inv_blocks.launches,
            "B2": trmm.trmm.launches,
            "B3": trsm_block.trsm_substitution.launches}


def run(device: str = "cuda", n: int = 512, k: int = 128) -> dict:
    """The quickstart's checks; -> a summary with every error, its
    bound, the kernels' launches and the traced costs."""
    p1, p2 = 2, 2
    rng = np.random.default_rng(0)
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    B = rng.standard_normal((n, k))
    ref = np.linalg.solve(L, B)

    # 1. a-priori tuning (paper Sec. VIII)
    plan = tuning.tune(n, k, p1 * p1 * p2)
    print(f"tuned: regime={plan.regime} grid={plan.grid} n0={plan.n0} "
          f"r1={plan.r1} r2={plan.r2}")

    # 2. solve with both algorithms on one device
    # device None is cuda:0, and raises without a card
    grid = gridlib.make_trsm_mesh(1, 1, device=None if device == "cuda"
                                  else device)
    before = launches()
    Lt, Bt = torch.as_tensor(L), torch.as_tensor(B)

    def err(X):
        X = X.detach().cpu().double().numpy()
        return float(np.abs(X - ref).max() / np.abs(ref).max())

    errors = {"inv": err(core.trsm(Lt, Bt, grid, method="inv")),
              "rec": err(core.trsm(Lt, Bt, grid, method="rec"))}
    # 3. mixed precision: a bf16 sweep and iterative refinement recover
    #    fp32 accuracy (DESIGN.md Sec. 7)
    errors["bf16_refine"] = err(core.trsm(
        Lt.float(), Bt.float(), grid, method="inv",
        precision="bf16_refine"))
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    after = launches()
    for name, e in errors.items():
        print(f"{name:12s} relative error {e:.2e} (bound {BOUNDS[name]:.0e})")

    # 4. the paper's S/W/F of both algorithms on a 2x2x2 grid
    agrid = gridlib.abstract_grid(p1, p2)
    Lm = torch.empty((n, n), dtype=torch.float64, device="meta")
    Bm = torch.empty((n, k), dtype=torch.float64, device="meta")
    ti = comm.traced_cost(lambda: inv_trsm.solve(Lm, Bm, agrid, plan.n0))
    tr = comm.traced_cost(lambda: rec_trsm.solve(Lm, Bm, agrid))
    print(f"traced It-Inv: S={ti.s:.0f} messages, W={ti.w:.0f} words")
    print(f"traced Rec   : S={tr.s:.0f} messages, W={tr.w:.0f} words")
    print(f"latency improvement: {tr.s / max(ti.s, 1):.2f}x "
          f"(paper: Theta((n/k)^1/6 p^2/3) in the 3D regime)")
    return dict(
        device=str(grid.device), errors=errors, bounds=BOUNDS,
        ok=all(errors[name] <= BOUNDS[name] for name in BOUNDS),
        launches={key: after[key] - before[key] for key in after},
        traced={"inv": ti.summary(), "rec": tr.summary()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps({"quickstart": out}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
