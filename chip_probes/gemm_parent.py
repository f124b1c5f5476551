#!/usr/bin/env python3
"""The ordered product ``trmm.gemm`` (``csrc/trmm.cu``) against the
version it replaces (an earlier ``trmm.cu`` on ``tri_gemm.cuh``'s 8 x 16
tiles) and ``torch.matmul`` on one card.

    mkdir -p build/gemm_parent
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x -C build/gemm_parent --strip-components=4
    python3 chip_probes/gemm_parent.py build/gemm_parent

The old ``trmm.cu`` of that directory (with its ``tri_gemm.cuh``) is
compiled with the flags of ``kernels/build.py`` into a side library
under ``build/gemm_parent_lib/``.  Prints the card, both builds'
``-Xptxas -v`` lines, ``trmm.gemm_info`` for both column tile widths,
``trmm.gemm_order_checks`` in fp32, bf16 and fp64 (exit 1 on a check
that fails), then one JSON line per case and dtype: the new and the old
kernel against an fp64 ``torch.matmul`` (max error relative to its
largest entry), and CUDA-event medians (L2 flushed before each run, as
``chip_smoke.Timer``) timed old, new, new, old, beside ``torch.matmul``
and the least time the card could take (``chip_smoke.bound``).  The
cases are ``chip_smoke.GEMM_CASES``: the residual and a trailing update
of a width-1 bank at n = 8192, and the two local products of phase 13's
C = 4 bank on (2, 2).
"""

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.kernels import build, trmm  # noqa: E402

OUT = ROOT / "build" / "gemm_parent_lib"


def build_parent(old_dir: pathlib.Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libtrmm_parent.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", str(lib), str(old_dir / "trmm.cu")],
                          capture_output=True, text=True)
    (OUT / "trmm_parent.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def parent_gemm(lib, A, X, lower):
    fn = getattr(lib, "repro_gemm_" + trmm._SUFFIX[A.dtype])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, LL, P, LL, P, LL, I, I, I, I, P]
    fn.restype = I
    b, M, K = A.shape
    N = X.shape[2]
    C = torch.empty((b, M, N), dtype=X.dtype, device=X.device)
    build.check(fn(A.data_ptr(), A.stride(0), A.stride(1), X.data_ptr(),
                   X.stride(0), C.data_ptr(), b, M, K, N, int(lower),
                   torch.cuda.current_stream().cuda_stream), "parent gemm")
    return C


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "Compiling entry" in line]


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_parent: needs a CUDA card", file=sys.stderr)
        return 1
    libs = build.build_all()
    old = build_parent(pathlib.Path(sys.argv[1]))
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps(dict(ptxas_new=ptxas_lines(
        (build.BUILD_DIR / f"{libs['trmm'].stem}.log").read_text()),
        ptxas_parent=ptxas_lines((OUT / "trmm_parent.log").read_text()))),
        flush=True)
    ok = True
    for dtype in chip_smoke.GEMM_DTYPES:
        info = {w: trmm.gemm_info(dtype, w) for w in (False, True)}
        checks = trmm.gemm_order_checks(dtype, dev)
        torch.cuda.synchronize()
        ok &= all(checks.values())
        print(json.dumps(dict(dtype=str(dtype), info_n16=info[False],
                              info_wide=info[True], order_checks=checks)),
              flush=True)
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for dtype in chip_smoke.GEMM_DTYPES:
        for what, A, X, lower in chip_smoke.gemm_operands(dev, dtype, g):
            want = torch.matmul((A.tril() if lower else A).double(),
                                X.double())
            new = trmm.gemm(A, X, lower=lower)
            par = parent_gemm(old, A, X, lower)
            err = {k: chip_smoke.errors(v, want)[1]
                   for k, v in (("new", new), ("parent", par))}
            f_new = lambda: trmm.gemm(A, X, lower=lower)  # noqa: E731
            f_par = lambda: parent_gemm(old, A, X, lower)  # noqa: E731
            t = [timer.ms(f, 30) for f in (f_par, f_new, f_new, f_par)]
            lib_ms = timer.ms(lambda: torch.matmul(A, X), 30)
            b_ms, b_by = chip_smoke.gemm_bound(A, X, lower)
            print(json.dumps(dict(
                what=what, dtype=str(dtype), shape=[list(A.shape),
                                                    list(X.shape)],
                rel_err=err, ms_parent=[t[0], t[3]], ms_new=[t[1], t[2]],
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)),
                flush=True)
            del want, new, par
        torch.cuda.empty_cache()
    print("GEMM_ORDER_CHECKS", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
