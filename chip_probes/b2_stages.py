#!/usr/bin/env python3
"""Kernel B2's ring depth on the card: compiles copies of
``src/repro_torch/kernels/csrc/trmm_tri.cu`` with ``kStages`` set to 2..6
and the launch bounds' CTAs per SM to 1 or 2 (both only where the ring
fits twice in an SM's shared memory), prints each copy's registers, and
times each with CUDA events (median, L2 flushed before each run, as
``chip_smoke.Timer``) beside one ``torch.matmul`` at B2's phase-2 shapes
and a fleet bucket's (4, 1024, 1024) x 16.  Every copy must give the
shipped kernel's bits: the ring depth moves loads, not sums.

    python3 chip_probes/b2_stages.py

Needs nvcc and one card; the copies are built under
``build/b2_stages/``.
"""

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.kernels import build, trmm  # noqa: E402

SRC = build.CSRC / "trmm_tri.cu"
OUT = ROOT / "build" / "b2_stages"
SHAPES = ((1, 4096, torch.bfloat16), (1, 4096, torch.float32),
          (16, 4096, torch.bfloat16), (8, 4096, torch.bfloat16),
          (4, 1024, torch.bfloat16), (1, 256, torch.bfloat16),
          (16, 4096, torch.float32))
SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def variants() -> dict:
    """{name: loaded library} of the edited copies, built in parallel."""
    text = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for stages in (2, 3, 4, 5, 6):
        for per_sm in (1, 2) if stages <= 4 else (1,):
            name = f"stages{stages}_cta{per_sm}"
            src = OUT / f"{name}.cu"
            src.write_text(
                text.replace("constexpr int kStages = 3;",
                             f"constexpr int kStages = {stages};")
                .replace("__launch_bounds__(kWarps * 32, 2)",
                         f"__launch_bounds__(kWarps * 32, {per_sm})"))
            lib = OUT / f"lib{name}.so"
            procs.append((name, lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(lib), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        print(name, "rc", proc.returncode, "registers",
              re.findall(r"Used (\d+) registers", log), flush=True)
        if proc.returncode == 0:
            libs[name] = ctypes.CDLL(str(lib))
    return libs


def entry(lib, dtype):
    fn = getattr(lib, "repro_trmm_" + SUFFIX[dtype])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, P, LL, P, LL, I, I, P]
    fn.restype = I
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print("card:", chip_smoke.card_line(), flush=True)
    libs = variants()
    dev = torch.device("cuda")
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    for b, n, dtype in SHAPES:
        L = torch.randn((b, n, n), generator=g, device=dev).tril_().to(dtype)
        X = torch.randn((b, n, 16), generator=g, device=dev).to(dtype)
        shipped = trmm.trmm(L, X)
        row = {}
        for name, lib in libs.items():
            fn = entry(lib, dtype)
            C = torch.empty_like(X)

            def launch():
                status = fn(L.data_ptr(), L.stride(0), X.data_ptr(),
                            X.stride(0), C.data_ptr(), b, n, 16,
                            torch.cuda.current_stream().cuda_stream)
                build.check(status, name)

            launch()
            torch.cuda.synchronize()
            if not torch.equal(C, shipped):
                print(name, "differs from the shipped kernel", flush=True)
                return 1
            row[name] = timer.ms(launch, 30 if b > 1 else 60)
        row["matmul"] = timer.ms(lambda: torch.matmul(L, X), 30)
        print(json.dumps(dict(shape=[b, n, n, 16],
                              dtype=SUFFIX[dtype], ms=row)), flush=True)
        del L, X
    return 0


if __name__ == "__main__":
    sys.exit(main())
