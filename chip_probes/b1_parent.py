#!/usr/bin/env python3
"""Kernels B1 and B5 (``csrc/tri_inv_levels.cu``) against the version
they replace (``tri_inv_block.cu`` with its ``tri_gemm.cuh``: the same
leaf, then each level product on 64 x 64 tiles of 4 x 4 outputs per
thread, staged through registers) on one card: bit for bit, timed in
turns, with each kernel's registers and resident CTAs per SM.

    mkdir -p build/parent
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x -C build/parent --strip-components=4
    python3 chip_probes/b1_parent.py build/parent

The old ``tri_inv_block.cu`` and ``tri_gemm.cuh`` of that directory are
compiled with the flags of ``kernels/build.py`` into a side library
under ``build/b1_parent/``, with a small C entry appended that reports
its kernels' registers and occupancy as ``repro_tri_inv_info_*`` does
for the new ones (its kernels are left as they were).  Both versions are
driven through the same ``tri_inv_block._schedule``.  The cases are
``chip_smoke.py`` phase 2's B1 and B5 shapes (B1 (2, 1024, 1024) fp32
included), an fp64 B1 stack and a bf16 B5 one; blocks tril(randn) + n0
I, as phase 2's.  Each case prints one JSON line: whether the two
inverses are equal bit for bit (their bits compared as integers, so a
zero's sign counts), and CUDA-event medians of both (L2 flushed before
each run, as ``chip_smoke.Timer``), timed parent, new, new, parent.
Exits 1 on any bit that differs.
"""

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.kernels import build, tri_inv_block  # noqa: E402

OUT = ROOT / "build" / "b1_parent"
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
DTYPES = {F32: (0, "float"), BF16: (1, "__nv_bfloat16"), F64: (2, "double")}
# the old source's leaf (which = 0) and 64 x 64 level tile (which = 1)
SHIM = r"""
namespace {
template <typename T, bool G>
int parent_info(int which, int* out) {
  const void* fn =
      which == 0 ? (const void*)tri_inv_leaf_kernel<T, G>
                 : (const void*)repro::tri_gemm_kernel<T, 64, 64, 16, 4, 4,
                                                       false, G>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 256, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs; out[1] = per_sm; out[2] = 256;
  out[3] = (int)a.sharedSizeBytes; out[4] = (int)a.localSizeBytes;
  return 0;
}
}  // namespace
extern "C" int repro_tri_inv_parent_info(int dtype, int gated, int which,
                                         int* out) {
  switch (dtype * 2 + gated) {
    case 0: return parent_info<float, false>(which, out);
    case 1: return parent_info<float, true>(which, out);
    case 2: return parent_info<__nv_bfloat16, false>(which, out);
    case 3: return parent_info<__nv_bfloat16, true>(which, out);
    case 4: return parent_info<double, false>(which, out);
    default: return parent_info<double, true>(which, out);
  }
}
"""
# (m, n0, dtype, mask or None): phase 2's B1 cases, then its B5 cases,
# then fp64 ungated and bf16 gated
CASES = (
    (2, 4096, F32, None),
    (2, 4096, BF16, None),
    (32, 256, F32, None),
    (32, 256, BF16, None),
    (2, 1024, F32, None),
    (2, 4096, F32, [1, 0]),
    (16, 256, F32, [1, 0] * 8),
    (4, 2048, F64, [0, 1, 1, 0]),
    (4, 2048, F64, None),
    (2, 4096, BF16, [0, 1]),
)
BITS = {F32: torch.int32, BF16: torch.int16, F64: torch.int64}


def build_parent(old_dir: pathlib.Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(old_dir / "tri_gemm.cuh", OUT / "tri_gemm.cuh")
    src = OUT / "tri_inv_parent.cu"
    src.write_text((old_dir / "tri_inv_block.cu").read_text() + SHIM)
    lib = OUT / "libtri_inv_parent.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    (OUT / "tri_inv_parent.log").write_text(proc.stdout + proc.stderr)
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


def parent_info(lib, dtype, gated: bool) -> dict:
    fn = lib.repro_tri_inv_parent_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    info = {}
    for which, name in enumerate(("leaf", "level_64x64")):
        out = (ctypes.c_int * 5)()
        build.check(fn(DTYPES[dtype][0], int(gated), which,
                       ctypes.addressof(out)), "parent info")
        info[name] = dict(zip(("registers", "ctas_per_sm", "threads",
                               "shared_bytes", "local_bytes"), out))
    return info


def parent_inv(lib, Ls, valid):
    """The old kernels' inverse, through the same schedule."""
    suffix = ("valid_" if valid is not None else "") \
        + tri_inv_block._SUFFIX[Ls.dtype]
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    gate = [] if valid is None else [valid.data_ptr()]
    leaf_fn = getattr(lib, f"repro_tri_inv_leaf_{suffix}")
    leaf_fn.argtypes = [P, P, LL, I, I] + [P] * (1 + len(gate))
    gemm_fn = getattr(lib, f"repro_tri_gemm_{suffix}")
    gemm_fn.argtypes = [P, LL, LL, LL] * 3 + [I, I, I, I, LL, I, I, I] \
        + [P] * (1 + len(gate))
    stream = torch.cuda.current_stream().cuda_stream

    def leaf(Ls, out, S):
        m, n0, _ = Ls.shape
        build.check(leaf_fn(Ls.data_ptr(), out.data_ptr(), m, n0, S, *gate,
                            stream), "parent leaf")

    def gemm(a, b, c, s, nq, batch, *, tri_a, tri_b, negate):
        args = []
        for t, off, ld, sb, sq in (a, b, c):
            args += [t.data_ptr() + off * t.element_size(), ld, sb, sq]
        build.check(gemm_fn(*args, s, s, s, nq, batch, int(tri_a),
                            int(tri_b), int(negate), *gate, stream),
                    "parent level")

    m, n0, _ = Ls.shape
    out = torch.empty_like(Ls)
    scratch = torch.empty(max(m * n0 * n0 // 4, 1), dtype=Ls.dtype,
                          device=Ls.device)
    tri_inv_block._schedule(Ls, out, scratch, leaf, gemm)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_parent: needs a CUDA card", file=sys.stderr)
        return 1
    old = build_parent(pathlib.Path(sys.argv[1]))
    libs = build.build_all()
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    regs = {"new": ptxas_registers(
                (build.BUILD_DIR / f"{libs['tri_inv_levels'].stem}.log")
                .read_text()),
            "parent": ptxas_registers(
                (OUT / "tri_inv_parent.log").read_text())}
    print(json.dumps(dict(ptxas_registers=regs)), flush=True)
    for dtype in DTYPES:
        for gated in (False, True):
            print(json.dumps(dict(
                dtype=str(dtype), gated=gated,
                new=tri_inv_block.kernel_info(dtype, gated),
                parent=parent_info(old, dtype, gated))), flush=True)
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    all_equal = True
    for m, n0, dtype, mask in CASES:
        Ls = (torch.randn((m, n0, n0), generator=g, device=dev).tril_()
              + n0 * torch.eye(n0, device=dev)).to(dtype)
        v = None if mask is None else torch.tensor(mask, dtype=torch.int32,
                                                   device=dev)
        new = tri_inv_block.tri_inv_blocks(Ls, valid=v)
        par = parent_inv(old, Ls, v)
        torch.cuda.synchronize()
        equal = torch.equal(new.view(BITS[dtype]), par.view(BITS[dtype]))
        all_equal &= equal
        reps = 5 if n0 >= 2048 else 20
        f_new = lambda: tri_inv_block.tri_inv_blocks(Ls, valid=v)  # noqa
        f_par = lambda: parent_inv(old, Ls, v)  # noqa
        t = [timer.ms(f, reps) for f in (f_par, f_new, f_new, f_par)]
        print(json.dumps(dict(
            shape=[m, n0, n0], dtype=str(dtype), mask=mask, bit_equal=equal,
            finite=bool(new.isfinite().all()), parent_ms=[t[0], t[3]],
            new_ms=[t[1], t[2]], speedup=(t[0] + t[3]) / (t[1] + t[2]))),
            flush=True)
        del Ls, new, par
        torch.cuda.empty_cache()
    print("B1_B5_BIT_EQUAL_TO_PARENT", all_equal)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
