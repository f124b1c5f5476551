#!/usr/bin/env python3
"""Padded admission against unpadded solves on the card, with the
trailing updates and refinement residuals on cuBLAS and on the
hand-written tri-GEMM (``SolveSpec.fixed_order``, ``ops.gemm``).

An order-d factor is admitted with ``pad_to=n`` into a capacity bank of
width C, and the same factor into an order-d bank of the same width, at
the same n0 (inv) or the default base case n0 = n (rec).  Both banks'
programs are built twice, with ``fixed_order`` off and on, whatever the
bank's own choice (``solver.FIXED_ORDER_WIDTH``), and each solve's
leading d x 16 block is compared bit for bit.  Cases: d = 512 into
n = 1024 at n0 = 256, "inv" under fp32 and bf16_refine for the four
(lower, transpose) variants, and "rec" lower under both; d = 4096 into
n = 8192 at n0 = 4096, lower only, "inv" and "rec" under both; widths
1, 2, 4 and 16.  Then the times (CUDA events, median, L2 flushed) of
one residual product and one trailing update on each route, and of a
whole width-1 solve with each, at the shapes those cases run.

    PYTHONPATH=src python3 chip_probes/padded_widths.py
"""

import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import session  # noqa: E402
from repro_torch.core.precision import matmul_as  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

K = 16
VARIANTS = ((True, False), (True, True), (False, False), (False, True))


def programs(bank):
    """{fixed_order: program} for the bank's width-K spec."""
    spec = api.Solver.from_bank(bank).spec_for(K)
    return {fo: session._build_solver(dataclasses.replace(
        spec, fixed_order=fo)) for fo in (False, True)}


def cases():
    for prec in ("fp32", "bf16_refine"):
        for lower, transpose in VARIANTS:
            yield 1024, 512, "inv", 256, prec, lower, transpose
        yield 1024, 512, "rec", None, prec, True, False
    for method, n0 in (("inv", 4096), ("rec", None)):
        for prec in ("fp32", "bf16_refine"):
            yield 8192, 4096, method, n0, prec, True, False


def main() -> int:
    grid = api.make_trsm_mesh(1, 1)
    dev = grid.device
    print("card:", chip_smoke.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.Timer(dev)

    def fresh(n, lower):
        L = torch.randn((n, n), generator=g, device=dev).tril_()
        L.diagonal().add_(n)
        return L if lower else L.T.contiguous()

    solve_ms = []
    for n, d, method, n0, prec, lower, transpose in cases():
        T = fresh(d, lower)
        b = torch.randn((d, K), generator=g, device=dev)
        row = dict(n=n, d=d, method=method, n0=n0, precision=prec,
                   lower=lower, transpose=transpose)
        kw = dict(method=method, precision=prec, n0=n0, lower=lower,
                  transpose=transpose)
        for C in (1, 2, 4, 16):
            big = api.FactorBank(grid, n, capacity=C, **kw)
            small = api.FactorBank(grid, d, capacity=C, **kw)
            big.admit(T, pad_to=n)
            small.admit(T)
            Bb = torch.zeros((C, n, K), device=dev)
            Bb[0, :d] = b
            Bs = torch.zeros((C, d, K), device=dev)
            Bs[0] = b
            pb, ps = programs(big), programs(small)
            for fo in (False, True):
                Xb = pb[fo].solve(big.stacks(), Bb, valid=big.valid)[0]
                Xs = ps[fo].solve(small.stacks(), Bs, valid=small.valid)[0]
                tag = f"C{C}_{'fixed' if fo else 'cublas'}"
                row[f"equal_{tag}"] = torch.equal(Xb[:d], Xs)
                row[f"maxdiff_{tag}"] = (Xb[:d] - Xs).abs().max().item()
                row[f"tail_zero_{tag}"] = not Xb[d:].any()
                if C == 1 and lower and not transpose:
                    ms = {f: timer.ms(lambda f=f: pb[f].solve(
                        big.stacks(), Bb, valid=big.valid), 10)
                        for f in (False, True)}
                    solve_ms.append(dict(n=n, method=method, n0=n0,
                                         precision=prec, C=1,
                                         solve_ms_cublas=ms[False],
                                         solve_ms_fixed=ms[True]))
            del big, small, pb, ps
        print(json.dumps(row), flush=True)
    for r in solve_ms:
        print(json.dumps(r), flush=True)

    # one product of each route at the test's shapes, width 1 and 16
    for C in (1, 16):
        for n in (1024, 8192):
            L = torch.randn((C, n, n), generator=g, device=dev).tril_()
            X = torch.randn((C, n, K), generator=g, device=dev)
            cub = timer.ms(lambda: matmul_as(L, X, torch.float32,
                                             torch.float32), 10)
            own = timer.ms(lambda: ops.gemm(L, X, lower=True), 10)
            print(json.dumps(dict(product="residual fp32", C=C,
                                  shape=[n, n, K], cublas_ms=cub,
                                  gemm_lower_ms=own)), flush=True)
            del L, X
        for n, n0 in ((1024, 256), (8192, 4096)):
            for dt in (torch.float32, torch.bfloat16):
                Lf = torch.randn((C, n, n), generator=g,
                                 device=dev).to(dt)
                A = Lf[:, n0:, :n0]
                Xi = torch.randn((C, n0, K), generator=g,
                                 device=dev).to(dt)
                cub = timer.ms(lambda: matmul_as(A, Xi, torch.float32, dt),
                               10)
                own = timer.ms(lambda: ops.gemm(A, Xi), 10)
                print(json.dumps(dict(
                    product=f"update {str(dt)[6:]}", C=C,
                    shape=[n - n0, n0, K], cublas_ms=cub, gemm_ms=own,
                    max_abs_diff=(ops.gemm(A, Xi).float() - matmul_as(
                        A, Xi, torch.float32, dt).float()).abs().max()
                    .item())), flush=True)
                del Lf, A, Xi
    return 0


if __name__ == "__main__":
    sys.exit(main())
