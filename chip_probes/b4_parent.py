#!/usr/bin/env python3
"""Kernel B4 (``csrc/trmm_tri.cu``'s ``trmm_masked_kernel``) against the
version it replaces (``trmm.cu``'s MASK instantiation of
``tri_gemm.cuh``: 8 x 16 tiles 256 deep, a row tile walking the runs of
its kept blocks) on one card, and against copies of itself with one
design choice changed.

    mkdir -p build/parent
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x -C build/parent --strip-components=4
    python3 chip_probes/b4_parent.py build/parent

The old ``trmm.cu`` of that directory (with its ``tri_gemm.cuh``) is
compiled with the flags of ``kernels/build.py`` into a side library
under ``build/b4_parent/``, with a small C entry appended that reports
its kernels' registers and occupancy as ``repro_trmm_masked_info_*``
does for the new ones.  Copies of ``trmm_tri.cu`` are built beside it
with strips always paired (i, T-1-i), never paired (one strip per CTA,
the last first), and ranked on the device by their block row's kept
blocks (one per CTA; the ranking's code lives here, ``BY_MASK``).  The
cases are ``chip_smoke.py`` phase 2's four, a bt = 64 and a bt = 16
case, and the (16, 4096, 4096) x 16 fp32 stack of a structured capacity
bank; the operands are a dense tril(randn) and randn X.  Each case prints one
JSON line: the parent's and the new kernel's error against
``trmm_masked_plain`` (relative to its largest entry), CUDA-event
medians (L2 flushed before each run, as ``chip_smoke.Timer``) timed
parent, new, new, parent and the mean of each pair, then each copy's
time, timed in turns (each copy, then the same in reverse), and whether
every copy gives the shipped kernel's bits (the copies move strips and
loads, not sums).  Registers and CTAs per SM of every kernel come
first.  Exits 1 if a copy's bits differ or an error exceeds 2e-5.
"""

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.core.structure import FactorStructure  # noqa: E402
from repro_torch.kernels import build, trmm  # noqa: E402

OUT = ROOT / "build" / "b4_parent"
SRC = build.CSRC / "trmm_tri.cu"
NEVER_PAIRED = ("constexpr int kPairCtas = 132;",
                "constexpr int kPairCtas = 1 << 30;")
# the by_mask copy's strip order: one strip per CTA, ranked on the device
BY_MASK = r"""
// The strip of rank x, strips ranked by the kept lower blocks of the
// block row their first row lies in (most first), then by index (last
// first).  Every CTA counts the mask's rows in shared memory
// (the ring's, before any copy lands there); a mask of more block rows
// than that holds takes the strips last first.
__device__ __forceinline__ int strip_by_mask(char* smem, int smem_bytes,
                                             const int* mask, int bt, int nb,
                                             int strips, int x) {
  __shared__ int pick;
  if (nb > smem_bytes / (int)sizeof(int)) return strips - 1 - x;
  int* cnt = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int i = e / nb;
    if (e - i * nb <= i && __ldg(mask + e)) atomicAdd(&cnt[i], 1);
  }
  __syncthreads();
  auto first = [&](int i) {
    return min(strips, (i * bt + kStrip - 1) / kStrip);
  };
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    int start = 0;
    for (int i2 = 0; i2 < nb; ++i2)
      if (cnt[i2] > cnt[i] || (cnt[i2] == cnt[i] && i2 > i))
        start += first(i2 + 1) - first(i2);
    const int lo = first(i), hi = first(i + 1);
    if (x >= start && x < start + hi - lo) pick = hi - 1 - (x - start);
  }
  __syncthreads();
  const int s = pick;
  __syncthreads();                // cnt is read; the ring may land
  return s;
}

"""
# name: [(text in the shipped source, its replacement), ...]
VARIANTS = {
    "pairs": [("constexpr int kPairCtas = 132;",
               "constexpr int kPairCtas = 0;")],
    "last_first": [NEVER_PAIRED],
    "by_mask": [NEVER_PAIRED,
                ("// B2's kernel over the kept blocks only",
                 BY_MASK + "// B2's kernel over the kept blocks only"),
                ("  } else {\n    s0 = strips - 1 - blockIdx.x;\n  }",
                 "  } else {\n    s0 = strip_by_mask(smem, Ly::kSmem, mask, "
                 "bt, nb, strips,\n                       blockIdx.x);\n  }")],
}
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float64: "f64"}
# the parent's masked kernels at k <= 16 (8 x 16 tiles), for the entry
SHIM = r"""
namespace {
template <typename T, int BK>
int parent_info(int* out) {
  const void* fn =
      (const void*)repro::tri_gemm_kernel<T, 8, 16, BK, 1, 1, true, false>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 128, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs; out[1] = per_sm; out[2] = 128;
  out[3] = (int)a.sharedSizeBytes; out[4] = (int)a.localSizeBytes;
  return 0;
}
}  // namespace
extern "C" int repro_trmm_parent_info(int which, int* out) {
  switch (which) {
    case 0: return parent_info<float, 256>(out);
    case 1: return parent_info<__nv_bfloat16, 256>(out);
    default: return parent_info<double, 128>(out);
  }
}
"""
KEYS = ("registers", "ctas_per_sm", "threads", "shared_bytes", "local_bytes")


def cases():
    """(batch, n, bt, dtype, structure, bool mask): phase 2's four, then
    bt = 64, bt = 16 and a capacity bank's stack."""
    out = [(1, n, bt, dt, what, bm)
           for n, bt, dt, what, bm in chip_smoke.masked_cases()]
    band = FactorStructure.parse("banded:1024")
    out += [(1, 8192, 64, torch.float32, "banded:1024",
             band.block_mask(8192, 64)),
            (1, 2048, 16, torch.float32, "banded:256",
             FactorStructure.parse("banded:256").block_mask(2048, 16)),
            (16, 4096, 512, torch.float32, "banded:1024",
             band.block_mask(4096, 512))]
    return out


def nvcc(src: pathlib.Path, lib: pathlib.Path, *extra) -> subprocess.Popen:
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", *extra, "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def build_all(old_dir: pathlib.Path) -> tuple:
    """(parent library, {variant: library}, {name: ptxas log}), built
    in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    parent = OUT / "trmm_parent.cu"
    parent.write_text((old_dir / "trmm.cu").read_text() + SHIM)
    procs = {"parent": (OUT / "libtrmm_parent.so",
                        nvcc(parent, OUT / "libtrmm_parent.so", "-I",
                             str(old_dir)))}
    text = SRC.read_text()
    for name, edits in VARIANTS.items():
        src_text = text
        for old, new in edits:
            if src_text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not once in {SRC.name}")
            src_text = src_text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(src_text)
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, nvcc(src, lib))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        (OUT / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs.pop("parent"), libs, logs


def ptxas(log: str, pattern: str) -> dict:
    """{mangled kernel: [registers, spill store bytes]} of the kernels
    whose name matches ``pattern`` in an ``-Xptxas -v`` log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if re.search(pattern, m.group(1)) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out[cur] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = [int(m.group(1))] + out.get(cur, [None, None])[1:]
            cur = None
    return out


def launcher(lib, dtype):
    """The masked entry of one build, with the new entries' arguments
    (the parent's take the same)."""
    fn = getattr(lib, "repro_trmm_masked_" + SUFFIX[dtype])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, P, LL, P, LL, I, I, P, I, P]
    fn.restype = I

    def run(L, X, mask, bt):
        b, n, k = X.shape
        C = torch.empty_like(X)
        build.check(fn(L.data_ptr(), L.stride(0), X.data_ptr(), X.stride(0),
                       C.data_ptr(), b, n, k, mask.data_ptr(), bt,
                       torch.cuda.current_stream().cuda_stream), "b4 probe")
        return C
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("b4_parent: needs a CUDA card", file=sys.stderr)
        return 1
    parent, variants, logs = build_all(pathlib.Path(sys.argv[1]))
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps(dict(
        ptxas_parent=ptxas(logs["parent"], r"tri_gemm_kernel.*Lb1ELb0E"),
        ptxas_variants={name: ptxas(logs[name], "trmm_masked_kernel")
                        for name in VARIANTS})), flush=True)
    info = parent.repro_trmm_parent_info
    info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    for which, dtype in enumerate(SUFFIX):
        vals = (ctypes.c_int * 5)()
        build.check(info(which, ctypes.addressof(vals)), "parent info")
        print(json.dumps(dict(dtype=str(dtype),
                              parent=dict(zip(KEYS, vals)),
                              new=trmm.kernel_info(dtype))), flush=True)
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    ok = True
    for b, n, bt, dtype, what, bm in cases():
        mask = torch.as_tensor(bm.astype(np.int32), device=dev)
        L = torch.randn((b, n, n), generator=g, device=dev,
                        dtype=torch.float64).tril_().to(dtype)
        X = torch.randn((b, n, 16), generator=g, device=dev,
                        dtype=torch.float64).to(dtype)
        want = trmm.trmm_masked_plain(L, X, mask, bt).double()
        scale = want.abs().max().item()
        run_par = launcher(parent, dtype)
        f_new = lambda: trmm.trmm_masked(L, X, mask, bt)  # noqa: E731
        f_par = lambda: run_par(L, X, mask, bt)  # noqa: E731
        new, par = f_new(), f_par()
        err = {name: (c.double() - want).abs().max().item() / scale
               for name, c in (("new", new), ("parent", par))}
        ok &= max(err.values()) <= 2e-5
        runs = {name: (lambda f=launcher(lib, dtype): f(L, X, mask, bt))
                for name, lib in variants.items()}
        same = {name: torch.equal(f(), new) for name, f in runs.items()}
        ok &= all(same.values())
        reps = 20 if b * n >= 8192 else 50
        t = [timer.ms(f, reps) for f in (f_par, f_new, f_new, f_par)]
        seq = list(runs) + list(runs)[::-1]
        to = [timer.ms(runs[name], reps) for name in seq]
        var_ms = {name: [x for s, x in zip(seq, to) if s == name]
                  for name in runs}
        print(json.dumps(dict(
            shape=[b, n, n], k=16, bt=bt, dtype=str(dtype), structure=what,
            kept_blocks=int(bm.sum()), rel_err=err,
            parent_ms=[t[0], t[3]], new_ms=[t[1], t[2]],
            parent_mean=(t[0] + t[3]) / 2, new_mean=(t[1] + t[2]) / 2,
            variant_ms=var_ms,
            variant_mean={k: sum(v) / 2 for k, v in var_ms.items()},
            variants_bit_equal=same)), flush=True)
        del L, X, want, new, par
        torch.cuda.empty_cache()
    print("B4_PROBE_OK", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
