#!/usr/bin/env python3
"""First look at kernel B6 (``trsm_substitution(valid=)``) on the card:
small cases against the plain version (NaN in the invalid systems, an
all-ones mask against B3, quadrant views), CUDA-event medians of B3 at
(1, 8192, 8192) x 16 and of B6 over a (16, 8192, 8192) x 16 stack with
several masks (bf16 factor, fp32 X), and whether a cuBLAS fp32 product
of a zero-padded order-8192 stack gives, in its leading 4096 rows, the
bits of the unpadded order-4096 product (at stack widths 1 and 16).

    PYTHONPATH=src python3 chip_probes/b6_first_look.py
"""

import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import trsm_block as tb  # noqa: E402


def system(g, dev, m, n, k, dtype, ldtype):
    L = torch.randn((m, n, n), generator=g, device=dev,
                    dtype=torch.float64).tril_() / n ** 0.5
    L.diagonal(dim1=-2, dim2=-1).copy_(
        1 + torch.rand((m, n), generator=g, device=dev, dtype=torch.float64))
    B = torch.randn((m, n, k), generator=g, device=dev, dtype=torch.float64)
    return L.to(ldtype), B.to(dtype)


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)[reps // 2]


def main() -> int:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    for m, n, k, ldt, dt in ((4, 200, 40, torch.float32, torch.float32),
                             (3, 100, 7, torch.float64, torch.float64),
                             (4, 512, 16, torch.bfloat16, torch.float32)):
        L, B = system(g, dev, m, n, k, dt, ldt)
        v = torch.tensor([1, 0] * (m // 2) + [1] * (m % 2), device=dev,
                         dtype=torch.int32)
        live = v.bool()
        got = tb.trsm_substitution(L, B, valid=v)
        want = tb.trsm_substitution_plain(L, B, valid=v)
        Lp = torch.where(live[:, None, None], L,
                         torch.full_like(L, float("nan")))
        Lp.diagonal(dim1=-2, dim2=-1).masked_fill_(~live[:, None], 0)
        Bp = torch.where(live[:, None, None], B,
                         torch.full_like(B, float("nan")))
        print(json.dumps(dict(
            case=[m, n, k, str(ldt), str(dt)],
            err=((got.double() - want.double()).abs().max()
                 / want.double().abs().max()).item(),
            poison_equal=torch.equal(tb.trsm_substitution(Lp, Bp, valid=v),
                                     got),
            dead_zero=not got[~live].any(),
            ones_equal_b3=torch.equal(
                tb.trsm_substitution(L, B, valid=torch.ones_like(v)),
                tb.trsm_substitution(L, B)))))
    L, B = system(g, dev, 4, 1024, 16, torch.float32, torch.float32)
    v = torch.tensor([0, 1, 1, 0], device=dev, dtype=torch.int32)
    got = tb.trsm_substitution(L[:, 512:, 512:], B[:, 512:], valid=v)
    want = tb.trsm_substitution_plain(L[:, 512:, 512:], B[:, 512:], valid=v)
    print("strided err", ((got - want).abs().max() / want.abs().max()).item())
    L1, B1 = system(g, dev, 1, 8192, 16, torch.float32, torch.bfloat16)
    print("B3 (1, 8192) bf16 ms", ms(lambda: tb.trsm_substitution(L1, B1)))
    L16 = torch.cat([system(g, dev, 1, 8192, 16, torch.float32,
                            torch.bfloat16)[0] for _ in range(16)])
    B16 = torch.randn((16, 8192, 16), generator=g, device=dev)
    for name, mask in (("half_second", [1] * 8 + [0] * 8),
                       ("half_alt", [1, 0] * 8), ("all", [1] * 16),
                       ("none", [0] * 16)):
        v = torch.tensor(mask, device=dev, dtype=torch.int32)
        print("B6 (16, 8192)", name,
              ms(lambda: tb.trsm_substitution(L16, B16, valid=v)))
    print("B3 (16, 8192)", ms(lambda: tb.trsm_substitution(L16, B16)))
    d, n = 4096, 8192
    L = torch.randn((d, d), generator=g, device=dev).tril_() \
        + d * torch.eye(d, device=dev)
    X = torch.randn((d, 16), generator=g, device=dev)
    Lp = torch.zeros((16, n, n), device=dev)
    Lp[3, :d, :d] = L
    Lp[3].diagonal()[d:] = 1
    Xp = torch.zeros((16, n, 16), device=dev)
    Xp[3, :d] = X
    y1 = torch.matmul(L[None], X[None])[0]
    y16 = torch.matmul(Lp, Xp)[3, :d]
    Lu = torch.zeros((16, d, d), device=dev)
    Lu[3] = L
    Xu = torch.zeros((16, d, 16), device=dev)
    Xu[3] = X
    print("cublas padded==unpadded width1", torch.equal(y16, y1),
          "padded==unpadded width16",
          torch.equal(y16, torch.matmul(Lu, Xu)[3]),
          "maxdiff", (y16 - y1).abs().max().item())
    return 0


if __name__ == "__main__":
    sys.exit(main())
