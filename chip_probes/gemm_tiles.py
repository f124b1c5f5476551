#!/usr/bin/env python3
"""The ordered product's kernel (``csrc/trmm.cu``) with one of its tile
constants edited, against the shipped kernel, on one card.

    python3 chip_probes/gemm_tiles.py [--variants NAME ...] [--host]
        [--dtypes float32 float64 bfloat16]

Each variant is a copy of ``trmm.cu`` with ``kBM`` (rows of a unit),
``kStagesDense`` or ``kStagesLower`` (the cp.async ring's depth for a
dense or a lower A), ``kTM`` (rows a thread owns),
``kRowBytes`` (an A row's bytes a k-step) or ``GEMM_L2_PREFETCH`` (the
copies' L2 prefetch) set otherwise, compiled with the flags of
``kernels/build.py`` into
``build/gemm_tiles/<variant>/`` (all nvcc's started together).  KC and
the order do not change with them, so every variant must give the
shipped kernel's C bit for bit; a differing bit exits 1.  Prints the
card, each variant's registers, CTAs per SM, threads and shared bytes
(``repro_gemm_info_*``), then one JSON line per case of
``chip_smoke.gemm_operands`` and dtype: CUDA-event medians (L2 flushed
before each run, as ``chip_smoke.Timer``) of the shipped kernel and of
each variant, timed in turns (shipped, variants, variants reversed,
shipped), beside ``torch.matmul`` and the bound; with ``--host``
first the host's microseconds a call (``host_us``); with
``--read-flush`` the L2 is flushed by a read (``ReadFlushTimer``).
``VARIANTS``
names every variant; ``--variants`` picks some (``DEFAULT`` else).
"""

import argparse
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

OUT = ROOT / "build" / "gemm_tiles"
# the copies of trmm.cu this probe can time against it; DEFAULT is the
# set whose times PERF.md Sec. 6 cites
VARIANTS = {
    "no_l2_prefetch": dict(GEMM_L2_PREFETCH='""'),
    "dense_s2": dict(kStagesDense=2),
    "lower_s3": dict(kStagesLower=3),
    "bm64": dict(kBM=64),
    "bm64_s2": dict(kBM=64, kStagesDense=2, kStagesLower=2),
    "bm64_s4": dict(kBM=64, kStagesDense=4, kStagesLower=4),
    "bm64_s6": dict(kBM=64, kStagesDense=6, kStagesLower=6),
    "bm128_s4": dict(kStagesDense=4, kStagesLower=4),
    "bm256_s2": dict(kBM=256, kStagesDense=2, kStagesLower=2),
    "tm2": dict(kTM=2),
    "r64_s3": dict(kRowBytes=64, kStagesLower=3),
    "r64_s4": dict(kRowBytes=64, kStagesDense=4, kStagesLower=4),
    "r256": dict(kRowBytes=256, kStagesLower=3),
    "r256_s2": dict(kRowBytes=256, kStagesDense=2),
}
DEFAULT = ("no_l2_prefetch", "dense_s2", "lower_s3", "bm64")


def build_variants(names) -> dict:
    src = (build.CSRC / "trmm.cu").read_text()
    procs = {}
    for name in names:
        consts = VARIANTS[name]
        text = src
        for const, value in consts.items():
            if const.isupper():           # a macro
                text, n = re.subn(rf"#define {const} .*",
                                  f"#define {const} {value}", text)
            else:
                text, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
            assert n == 1, const
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "trmm.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(d / "libtrmm.so"), str(d / "trmm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (OUT / name / "ptxas.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / name / "libtrmm.so"))
    return libs


def variant_gemm(lib, A, X, lower):
    sfx = trmm._SUFFIX[A.dtype]
    fn = getattr(lib, "repro_gemm_" + sfx)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, LL, P, LL, P, P, LL, I, I, I, I, I, P]
    fn.restype = I
    b, M, K = A.shape
    N = X.shape[2]
    C = torch.empty((b, M, N), dtype=X.dtype, device=X.device)
    nbytes = trmm.gemm_workspace_bytes(A.dtype, b, M, K, N)
    W = torch.empty((nbytes,), dtype=torch.uint8, device=A.device) \
        if nbytes else None
    build.check(fn(A.data_ptr(), A.stride(0), A.stride(1), X.data_ptr(),
                   X.stride(0), C.data_ptr(),
                   0 if W is None else W.data_ptr(), b, M, K, N, int(lower),
                   A.device.index, torch.cuda.current_stream().cuda_stream),
                "variant gemm")
    return C


def variant_info(lib, dtype, wide: bool, lower: bool) -> dict:
    fn = getattr(lib, "repro_gemm_info_" + trmm._SUFFIX[dtype])
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 10)()
    build.check(fn(int(wide), int(lower), ctypes.addressof(vals)),
                "variant info")
    return dict(zip(("registers", "ctas_per_sm", "threads", "shared_bytes",
                     "local_bytes"), vals))


def host_us(dev) -> dict:
    """Host microseconds a call, over 2000 back-to-back calls at a shape
    whose device time is a few microseconds ((1, 128, 128) @ (1, 128, 16)
    fp32, one chunk; and K = 1024, two chunks and a workspace), for the
    wrapper, the raw C entry on preallocated C (and W), torch.matmul,
    and the wrapper's pieces one at a time."""
    import time
    out = {}
    for kk in (128, 1024):
        A = torch.randn((1, 128, kk), device=dev)
        X = torch.randn((1, kk, 16), device=dev)
        C = torch.empty((1, 128, 16), device=dev)
        nbytes = trmm.gemm_workspace_bytes(A.dtype, 1, 128, kk, 16)
        W = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
        fn = trmm._gemm_entry(A.dtype)
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            build.check(fn(A.data_ptr(), A.stride(0), A.stride(1),
                           X.data_ptr(), X.stride(0), C.data_ptr(),
                           W.data_ptr(), 1, 128, kk, 16, 0, dev.index,
                           stream), "raw")

        def ctx():
            with torch.cuda.device(dev):
                pass
        calls = dict(wrapper=lambda: trmm.gemm(A, X), raw=raw,
                     matmul=lambda: torch.matmul(A, X),
                     empty=lambda: torch.empty((1, 128, 16), device=dev),
                     device_ctx=ctx,
                     current_stream=lambda: torch.cuda.current_stream(
                         dev).cuda_stream)
        for name, f in calls.items():
            for _ in range(50):
                f()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2000):
                f()
            host = (time.perf_counter() - t) / 2000 * 1e6
            torch.cuda.synchronize()
            out[f"{name} K={kk}"] = host
    return out


class ReadFlushTimer(chip_smoke.Timer):
    """``chip_smoke.Timer`` with the L2 flushed by reading 256 MB, not by
    writing it: the lines it leaves are clean, so the timed call pays
    no write-back of the flush's dirty lines."""

    def ms(self, fn, reps: int, warm: int = 2) -> float:
        import numpy as np
        for _ in range(warm):
            fn()
        words = self.flush_buf.view(torch.int32)
        pairs = []
        for _ in range(reps):
            words.max()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", nargs="*",
                    default=["float32", "float64", "bfloat16"])
    ap.add_argument("--variants", nargs="*", default=list(DEFAULT),
                    choices=sorted(VARIANTS))
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--read-flush", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    build.build_all()
    libs = build_variants(args.variants)
    dev = torch.device("cuda", torch.cuda.current_device())
    print(chip_smoke.card_line(), flush=True)
    if args.host:
        print(json.dumps(dict(host_us_per_call=host_us(dev))), flush=True)
    dtypes = [getattr(torch, d) for d in args.dtypes]
    for dtype in dtypes:
        for lower in (False, True):
            print(json.dumps(dict(
                dtype=str(dtype), lower=lower,
                shipped=trmm.gemm_info(dtype, lower=lower),
                variants={n: variant_info(lib, dtype, False, lower)
                          for n, lib in libs.items()})), flush=True)
    timer = (ReadFlushTimer if args.read_flush else chip_smoke.Timer)(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    same_all = True
    for dtype in dtypes:
        for what, A, X, lower in chip_smoke.gemm_operands(dev, dtype, g):
            ref = trmm.gemm(A, X, lower=lower)
            same = {n: torch.equal(variant_gemm(lib, A, X, lower), ref)
                    for n, lib in libs.items()}
            torch.cuda.synchronize()
            same_all &= all(same.values())
            fns = [("shipped", lambda: trmm.gemm(A, X, lower=lower))] + [
                (n, lambda lib=lib: variant_gemm(lib, A, X, lower))
                for n, lib in libs.items()]
            order = fns + fns[::-1]
            times = {}
            for n, f in order:
                times.setdefault(n, []).append(timer.ms(f, 20))
            lib_ms = timer.ms(lambda: torch.matmul(A, X), 20)
            b_ms, _ = chip_smoke.gemm_bound(A, X, lower)
            print(json.dumps(dict(what=what, dtype=str(dtype),
                                  ms=times, library_ms=lib_ms,
                                  bound_ms=b_ms, same_bits=same)),
                  flush=True)
            del ref
        torch.cuda.empty_cache()
    print("GEMM_TILES_SAME_BITS", same_all)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
