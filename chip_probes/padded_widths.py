#!/usr/bin/env python3
"""Padded admission against unpadded solves on the card: an order-d
factor admitted with ``pad_to=n`` into a capacity bank of width Cp,
against the same factor in an order-d bank of width Cu, at the same n0
(inv) or the default base case (rec), for bf16_refine and fp32.  Prints
per case whether the leading d x 16 block is bit-equal, and the largest
difference.

    PYTHONPATH=src python3 chip_probes/padded_widths.py
"""

import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch import api  # noqa: E402


def main() -> int:
    grid = api.make_trsm_mesh(1, 1)
    g = torch.Generator(device=grid.device).manual_seed(0)

    def fresh(n):
        L = torch.randn((n, n), generator=g, device=grid.device).tril_()
        L.diagonal().add_(n)
        return L

    for n, d, n0 in ((1024, 512, 256), (8192, 4096, 4096)):
        for method in ("inv", "rec"):
            for prec in ("bf16_refine", "fp32"):
                T = fresh(d)
                b = torch.randn((d, 16), generator=g, device=grid.device)
                row = dict(n=n, d=d, method=method, precision=prec)
                kw = dict(method=method, precision=prec,
                          n0=n0 if method == "inv" else None)
                for Cp, Cu in ((1, 1), (4, 4), (16, 16), (16, 1), (1, 16)):
                    big = api.FactorBank(grid, n, capacity=Cp, **kw)
                    small = api.FactorBank(grid, d, capacity=Cu, **kw)
                    big.admit(T, pad_to=n)
                    small.admit(T)
                    Bb = torch.zeros((Cp, n, 16), device=grid.device)
                    Bb[0, :d] = b
                    Bs = torch.zeros((Cu, d, 16), device=grid.device)
                    Bs[0] = b
                    Xb = api.Solver.from_bank(big).solve(Bb)[0]
                    Xs = api.Solver.from_bank(small).solve(Bs)[0]
                    row[f"padded{Cp}_vs_unpadded{Cu}"] = torch.equal(
                        Xb[:d], Xs)
                    row[f"maxdiff{Cp}_{Cu}"] = \
                        (Xb[:d] - Xs).abs().max().item()
                    del big, small
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
