#!/usr/bin/env python3
"""How accurately the port solves with a K-FAC factor on the card, path
by path, on one input.

The factor is the damped Cholesky factor of an order-6144 Gram EMA as
K-FAC keeps it for an MLP's 6144-wide side (``kfac_ca._damped_chol``,
damping 1e-3 of the mean eigenvalue): M = sum over 3 steps of
0.05 * 0.95^(2 - t) * G_t^T G_t with G_t (2048, 6144) from randn, the
EMA of phase 11 of ``chip_smoke.py`` without its clipping (the damping
is relative, so the scale does not matter).  One RHS of 16 columns is
solved in fp32 by: the port's bank (phase 1 on B1 at n0 = 2048, the
sweep on B2 and cuBLAS), It-Inv with the plain doubling as the block
inverter, It-Inv with B1 (``kernels.ops.block_inv_kernel``), and
``torch.linalg.solve_triangular``; each with its relres
||L X - B|| / ||B|| in fp64.  The factor itself is held to the damped
matrix M + lam I (written out here, not taken from the optimizer):
||L L^T - (M + lam I)|| / ||M + lam I|| in fp64, beside
``torch.linalg.cholesky``'s on the same matrix.  Then each diagonal block's inverse, by B1
and by the plain doubling, against the fp64 inverse
(``solve_triangular`` on the fp64 block), and the condition number of L
in fp64.  With ``--order``/``--width`` another shape.

    PYTHONPATH=src python3 chip_probes/harder_factors.py
"""

import argparse
import importlib
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import api  # noqa: E402
from repro_torch.core import blocked  # noqa: E402
from repro_torch.kernels import ops, tri_inv_block  # noqa: E402


def relres(L64, X, B) -> float:
    B64 = B.double()
    return (torch.linalg.norm(L64 @ X.double() - B64)
            / torch.linalg.norm(B64)).item()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", type=int, default=6144)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--n0", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("harder_factors: needs a CUDA card", file=sys.stderr)
        return 1
    kfac = importlib.import_module("repro_torch.optim.kfac_ca")
    grid = api.make_trsm_mesh(1, 1)
    dev = grid.device
    g = torch.Generator(device=dev).manual_seed(0)
    d, n0 = args.order, args.n0
    M = torch.zeros((d, d), device=dev)
    for _ in range(3):
        G = torch.randn((args.width, d), generator=g, device=dev)
        M = 0.95 * M + 0.05 * (G.T @ G)
    del G
    L = kfac._damped_chol(M, 1e-3)
    L64 = L.double()
    B = torch.randn((d, 16), generator=g, device=dev)
    rec = {"order": d, "width": args.width, "n0": n0}
    Md = M + 1e-3 * (torch.trace(M) / d + 1e-12) * torch.eye(d, device=dev)
    M64 = Md.double()
    for name, F in (("factor", L64),
                    ("library_factor", torch.linalg.cholesky(Md).double())):
        rec[f"{name}_rel_residual"] = (torch.linalg.norm(F @ F.T - M64)
                                       / torch.linalg.norm(M64)).item()
    del Md, M64

    bank = api.FactorBank(grid, d, n0=n0, capacity=1)
    bank.admit(L)
    rec["relres_bank"] = relres(
        L64, api.Solver.from_bank(bank).solve(B[None])[0], B)
    rec["relres_it_inv_plain"] = relres(L64, blocked.it_inv_trsm_local(
        L, B, n0, block_inv=tri_inv_block.tri_inv_blocks_plain), B)
    rec["relres_it_inv_b1"] = relres(L64, blocked.it_inv_trsm_local(
        L, B, n0, block_inv=ops.block_inv_kernel), B)
    rec["relres_solve_triangular"] = relres(
        L64, torch.linalg.solve_triangular(L, B, upper=False), B)
    blocks = blocked.diag_blocks(L, n0).contiguous()
    eye = torch.eye(n0, device=dev, dtype=torch.float64)
    want = torch.linalg.solve_triangular(blocks.double(), eye.expand(
        blocks.shape), upper=False)
    for name, fn in (("b1", ops.block_inv_kernel),
                     ("plain", tri_inv_block.tri_inv_blocks_plain)):
        got = fn(blocks).double()
        rec[f"block_inverse_rel_err_{name}"] = [
            (torch.linalg.norm(got[i] - want[i])
             / torch.linalg.norm(want[i])).item()
            for i in range(blocks.shape[0])]
    sv = torch.linalg.svdvals(L64)
    rec["cond_L"] = (sv[0] / sv[-1]).item()
    rec["cond_diag_blocks"] = [
        (s[0] / s[-1]).item() for s in torch.linalg.svdvals(blocks.double())]
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
