#!/usr/bin/env python3
"""Kernels B3 and B6 (``csrc/trsm_chain.cu``) against the version they
replace (``trsm_block.cu``: one chain of row-block CTAs per system and
column tile, tickets system-major, one flag per row block) on one card:
bit for bit, timed in turns, with each kernel's registers and resident
CTAs per SM.

    mkdir -p build/parent
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x -C build/parent --strip-components=4
    python3 chip_probes/b3_parent.py build/parent

The old ``trsm_block.cu`` of that directory is compiled with the flags
of ``kernels/build.py`` into a side library under ``build/b3_parent/``,
with a small C entry appended that reports its kernels' registers and
occupancy as ``repro_trsm_info_*`` does for the new ones (its kernels
are left as they were).  The cases are ``chip_smoke.py`` phase 2's
substitution and validity-gated shapes, and the (16, 8192, 8192) x 16
stack with a bf16 factor under an all-ones mask, the half-valid mask
and no mask (B3 on every system).  Systems as in phase 2 (tril(randn) /
sqrt(n) with a diagonal in [1, 2)).  Each case prints one JSON line:
whether the two X are equal bit for bit, and CUDA-event medians of
both kernels (L2 flushed before each run, as ``chip_smoke.Timer``),
timed parent, new, new, parent.  Exits 1 on any bit that differs.
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
from repro_torch.kernels import build, trsm_block  # noqa: E402

OUT = ROOT / "build" / "b3_parent"
N = chip_smoke.N
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
WHICH = {(F32, F32): 0, (BF16, F32): 1, (F64, F64): 2}
# the old source's kernels, by (which, gated), for the appended entry
SHIM = r"""
namespace {
template <typename TL, typename TX, int R, bool G>
int parent_info(int* out) {
  const void* fn = (const void*)trsm_chain_kernel<TL, TX, R, G>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * KT,
                                                    0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs; out[1] = per_sm; out[2] = 32 * KT;
  out[3] = (int)a.sharedSizeBytes; out[4] = (int)a.localSizeBytes;
  return 0;
}
}  // namespace
extern "C" int repro_trsm_parent_info(int which, int gated, int* out) {
  switch (which * 2 + gated) {
    case 0: return parent_info<float, float, 64, false>(out);
    case 1: return parent_info<float, float, 64, true>(out);
    case 2: return parent_info<__nv_bfloat16, float, 64, false>(out);
    case 3: return parent_info<__nv_bfloat16, float, 64, true>(out);
    case 4: return parent_info<double, double, 32, false>(out);
    default: return parent_info<double, double, 32, true>(out);
  }
}
"""
# (m, stored order, solved order, k, L dtype, X dtype, mask or None)
CASES = (
    (1, N, N, 16, BF16, F32, None),
    (1, N, N, 16, F32, F32, None),
    (1, 512, 512, 16, F32, F32, None),
    (1, 2048, 2048, 16, F64, F64, None),
    (4, 1000, 1000, 21, F32, F32, None),
    (16, N, N, 16, BF16, F32, [1] * 8 + [0] * 8),
    (16, N, N, 16, BF16, F32, [1] * 16),
    (16, N, N, 16, BF16, F32, None),
    (16, 1024, 512, 16, F32, F32, [1, 0] * 8),
    (8, 2048, 2048, 16, F64, F64, [0, 1, 1, 0, 1, 0, 0, 1]),
)


def build_parent(old_dir: pathlib.Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "trsm_parent.cu"
    src.write_text((old_dir / "trsm_block.cu").read_text() + SHIM)
    lib = OUT / "libtrsm_parent.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    (OUT / "trsm_parent.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def ptxas_registers(log: str) -> dict:
    """{mangled kernel: registers} from an ``-Xptxas -v`` log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = int(m.group(1))
            cur = None
    return out


def info(lib, which: int, gated: bool) -> dict:
    fn = lib.repro_trsm_parent_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 5)()
    build.check(fn(which, int(gated), ctypes.addressof(out)), "parent info")
    return dict(zip(("registers", "ctas_per_sm", "threads", "shared_bytes",
                     "local_bytes"), out))


def parent_solve(lib, L, B, valid):
    """The old kernel's X: its C entries take the new ones' arguments;
    its flags are one per CTA."""
    suffix = trsm_block._ENTRY[L.dtype, B.dtype]
    gated = valid is not None
    fn = getattr(lib, f"repro_trsm_valid_{suffix}" if gated
                 else f"repro_trsm_{suffix}")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, LL, P, LL, LL, P, P, LL, I, I] + [P] * (1 + gated)
    m, n, k = B.shape
    X = torch.empty_like(B)
    R = trsm_block.ROWS[B.dtype]
    flags = torch.zeros(1 + m * -(-k // 16) * -(-n // R), dtype=torch.int32,
                        device=B.device)
    args = [L.data_ptr(), L.stride(0), L.stride(1), B.data_ptr(),
            B.stride(0), B.stride(1), X.data_ptr(), flags.data_ptr(), m, n, k]
    if gated:
        args.append(valid.data_ptr())
    build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                "parent trsm")
    return X


def system(g, dev, m, big, k, ldtype, dtype):
    L = torch.empty((m, big, big), dtype=ldtype, device=dev)
    for z in range(m):
        A = torch.randn((big, big), generator=g, device=dev,
                        dtype=torch.float64).tril_() / big ** 0.5
        A.diagonal().copy_(1 + torch.rand(big, generator=g, device=dev,
                                          dtype=torch.float64))
        L[z] = A.to(ldtype)
        del A
    B = torch.randn((m, big, k), generator=g, device=dev,
                    dtype=torch.float64).to(dtype)
    return L, B


def main() -> int:
    if not torch.cuda.is_available():
        print("b3_parent: needs a CUDA card", file=sys.stderr)
        return 1
    old = build_parent(pathlib.Path(sys.argv[1]))
    libs = build.build_all()
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    regs = {"new": ptxas_registers(
                (build.BUILD_DIR / f"{libs['trsm_chain'].stem}.log")
                .read_text()),
            "parent": ptxas_registers((OUT / "trsm_parent.log").read_text())}
    print(json.dumps(dict(ptxas_registers=regs)), flush=True)
    for (ldt, dt), which in WHICH.items():
        for gated in (False, True):
            print(json.dumps(dict(
                factor=str(ldt), x=str(dt), gated=gated,
                new=trsm_block.kernel_info(ldt, dt, gated),
                parent=info(old, which, gated))), flush=True)
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    all_equal = True
    for m, big, n, k, ldt, dt, mask in CASES:
        L, B = system(g, dev, m, big, k, ldt, dt)
        Lq, Bq = L[:, big - n:, big - n:], B[:, big - n:]
        v = None if mask is None else torch.tensor(mask, dtype=torch.int32,
                                                   device=dev)
        new = trsm_block.trsm_substitution(Lq, Bq, valid=v)
        par = parent_solve(old, Lq, Bq, v)
        torch.cuda.synchronize()
        equal = torch.equal(new, par)
        all_equal &= equal
        reps = 5 if n >= 4096 else 20
        f_new = lambda: trsm_block.trsm_substitution(Lq, Bq, valid=v)  # noqa
        f_par = lambda: parent_solve(old, Lq, Bq, v)  # noqa
        t = [timer.ms(f, reps) for f in (f_par, f_new, f_new, f_par)]
        print(json.dumps(dict(
            shape=[m, n, n], stored=big, k=k, factor=str(ldt), x=str(dt),
            mask=mask, bit_equal=equal, finite=bool(new.isfinite().all()),
            parent_ms=[t[0], t[3]], new_ms=[t[1], t[2]],
            speedup=(t[0] + t[3]) / (t[1] + t[2]))), flush=True)
        del L, B, Lq, Bq, new, par
        torch.cuda.empty_cache()
    print("B3_B6_BIT_EQUAL_TO_PARENT", all_equal)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
