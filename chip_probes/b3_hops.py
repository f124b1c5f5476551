#!/usr/bin/env python3
"""Where a hop of the substitution chain (``csrc/trsm_chain.cu``, B3
and B6) goes, on one card.

    python3 chip_probes/b3_hops.py

Compiles two copies of ``trsm_chain.cu`` with the flags of
``kernels/build.py`` under ``build/b3_hops/``: a plain one, and a
traced one in which one thread of each CTA writes stamps, by ticket,
into a buffer the probe hands it (``%globaltimer`` ns, or the SM's
clock64 where said): 0 the ticket; 1 the hand-off warp sees the last
sub-block of block b - 1; 13 it has that unit's X in shared memory; 14
the compute warps have it; 2 they start the diagonal block; 3-6 they
have solved sub-block q; 7-10 it is published; 11, 12 clock64 at 2 and
at the last sub-block; 16-39 clock64 at each row set's start, after its
chain and after its fold; 40 block b - 2 folded; 41 the folds start; 42
block b / 2 folded; 43 its X loaded; 44-49 clock64 around tile b / 2
(the hand-off warp's fill of its slot, the staging, the wait for its
unit, its fold); 15 the SM.  For one system and for the (16, 8192,
8192) x 16 stack with 8 valid (bf16 factor) it prints the medians over
the valid chains' hops of each step (flag, load, substitute, publish,
hop, the X load and fold inside load, cycles per row and per row set),
the same over the chains' last 32 blocks with how far each CTA was
from its turn (slack, lead, folds per tile), the share of diagonal
blocks sharing an SM with another; CUDA-event medians (L2 flushed
before each run) of both copies, and of the plain copy launched on the
flags a solve left set (the ticket counter reset: no CTA waits, so the
launch times the folds alone), with that launch's tile b / 2 phases.
Both copies must give the shipped kernel's bits.  The traced copy runs
5-10% slower.
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
from repro_torch.kernels import build, trsm_block  # noqa: E402

SRC = build.CSRC / "trsm_chain.cu"
OUT = ROOT / "build" / "b3_hops"
N = chip_smoke.N
STAMP = ("{ long long _t; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
         ": \"=l\"(_t)); g_trace[(long long)t * W + (I)] = _t; }")
CLOCK = ("{ long long _c = clock64(); g_trace[(long long)t * W + (I)] = _c;"
         " }")
TRACE = [
    ("namespace {\n", "namespace {\n__device__ long long* g_trace;\n"
     "constexpr int W = 64;\n"),
    ("    const int j0 = RS * tt;\n",
     "    const int j0 = RS * tt;\n    if (threadIdx.x == 0) "
     + CLOCK.replace("(I)", "(16 + 3 * tt)") + "\n"),
    ("    TX xb[RS], l[RS][RS];\n",
     "    if (threadIdx.x == 0) " + CLOCK.replace("(I)", "(17 + 3 * tt)")
     + "\n    TX xb[RS], l[RS][RS];\n"),
    ("        acc[i2] = fma_rn(l[i][i2], xb[i], acc[i2]);\n    }\n",
     "        acc[i2] = fma_rn(l[i][i2], xb[i], acc[i2]);\n    }\n"
     "    if (threadIdx.x == 0) " + CLOCK.replace("(I)", "(18 + 3 * tt)")
     + "\n"),
    ("  const int t = s_ticket;\n",
     "  const int t = s_ticket;\n  if (threadIdx.x == 0) { "
     + STAMP.replace("(I)", "0") + " unsigned _s; asm(\"mov.u32 %0, "
     "%%smid;\" : \"=r\"(_s)); g_trace[(long long)t * W + 15] = _s; }\n"),
    ("        // the unit's loads are in flight while its slot is freed\n",
     "        if (bp == b - 1 && q + got == NQ && lane == 0) "
     + STAMP.replace("(I)", "1") + "\n        if (bp == b / 2 && lane == 0) "
     + CLOCK.replace("(I)", "44") + "\n"
     "        // the unit's loads are in flight while its slot is freed\n"),
    ("  if (b == 0) bar_sync(kBarCompute, NC);  // Ys and Bs are complete\n",
     "  if (b == 0) bar_sync(kBarCompute, NC);  // Ys and Bs are complete\n"
     "  if (threadIdx.x == 0) { " + STAMP.replace("(I)", "2")
     + CLOCK.replace("(I)", "11") + " }\n"),
    ("    if (bp + 1 < b) load_tile((bp + 1) * R);\n",
     "    if (bp + 1 < b) load_tile((bp + 1) * R);\n"
     "    if (bp == b - 1 && threadIdx.x == 0) " + STAMP.replace("(I)", "40")
     + "\n    if (bp == b / 2 + 1 && threadIdx.x == 0) "
     + STAMP.replace("(I)", "42") + "\n"),
    ("  if (b > 0) load_tile(0);\n",
     "  if (b > 0) load_tile(0);\n  if (threadIdx.x == 0) "
     + STAMP.replace("(I)", "41") + "\n"),
    ("        __syncwarp();\n        bar_arrive(kBarFull + slot, NT);\n",
     "        __syncwarp();\n        if (bp == b / 2 && lane == 0) "
     + CLOCK.replace("(I)", "45") + "\n        bar_arrive(kBarFull + slot,"
     " NT);\n"),
    ("    const bool last = bp == b - 1;\n",
     "    const bool last = bp == b - 1;\n    if (bp == b / 2 && threadIdx.x"
     " == 0) " + CLOCK.replace("(I)", "48") + "\n"),
    ("    if (bp + 1 < b) load_tile((bp + 1) * R);\n",
     "    if (bp == b / 2 && threadIdx.x == 0) " + CLOCK.replace("(I)", "49")
     + "\n    if (bp + 1 < b) load_tile((bp + 1) * R);\n"),
    ("      const int unit = s_unit[slot], q0 = unit & 0xff, got = unit >> 8;"
     "\n",
     "      const int unit = s_unit[slot], q0 = unit & 0xff, got = unit >> 8;"
     "\n      if (bp == b / 2 && q0 == 0 && threadIdx.x == 0) "
     + CLOCK.replace("(I)", "46") + "\n"),
    ("      bar_arrive(kBarEmpty + slot, NT);\n",
     "      if (bp == b / 2 && threadIdx.x == 0) " + CLOCK.replace("(I)", "47")
     + "\n      bar_arrive(kBarEmpty + slot, NT);\n"),
    ("        if (lane == 0) s_unit[slot] = q | (got << 8);\n",
     "        if (bp == b / 2 && q + got == NQ && lane == 0) "
     + STAMP.replace("(I)", "43") + "\n"
     "        if (bp == b - 1 && q + got == NQ && lane == 0) "
     + STAMP.replace("(I)", "13") + "\n"
     "        if (lane == 0) s_unit[slot] = q | (got << 8);\n"),
    ("      const int unit = s_unit[slot], q0 = unit & 0xff, got = unit >> 8;"
     "\n",
     "      const int unit = s_unit[slot], q0 = unit & 0xff, got = unit >> 8;"
     "\n      if (bp == b - 1 && q0 + got == NQ && threadIdx.x == 0) "
     + STAMP.replace("(I)", "14") + "\n"),
    ("      bar_arrive(kBarWritten + (j0 + RS) / S - 1, NT);\n",
     "      { bar_arrive(kBarWritten + (j0 + RS) / S - 1, NT); if (threadIdx.x"
     " == 0) { " + STAMP.replace("(I)", "(2 + (j0 + RS) / S)")
     + CLOCK.replace("(I)", "12") + " } }\n"),
    ("      if (lane == 0) store_release(ready + b * NQ + q, 1);\n",
     "      if (lane == 0) store_release(ready + b * NQ + q, 1);\n"
     "      if (lane == 0) " + STAMP.replace("(I)", "(7 + q)") + "\n"),
]
TAIL = """
extern "C" int trace_set(void* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof p);
}
"""
CASES = ((1, torch.bfloat16, None), (16, torch.bfloat16, [1] * 8 + [0] * 8))


def patched(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build_copies() -> dict:
    """{"traced": lib, "plain": lib}, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    text, procs = SRC.read_text(), []
    for tag, body in (("traced", patched(text, TRACE) + TAIL),
                      ("plain", text)):
        src = OUT / f"{tag}.cu"
        src.write_text(body)
        lib = OUT / f"lib{tag}.so"
        procs.append((tag, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, lib, proc in procs:
        log, _ = proc.communicate()
        (OUT / f"{tag}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed:\n{log}")
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def solve(lib, L, B, valid, flags=None, X=None):
    suffix = trsm_block._ENTRY[L.dtype, B.dtype]
    gated = valid is not None
    fn = getattr(lib, f"repro_trsm_valid_{suffix}" if gated
                 else f"repro_trsm_{suffix}")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, LL, LL, P, LL, LL, P, P, LL, I, I] + [P] * (1 + gated)
    m, n, k = B.shape
    R = trsm_block.ROWS[B.dtype]
    X = torch.empty_like(B) if X is None else X
    if flags is None:
        flags = torch.zeros(1 + m * -(-k // 16) * -(-n // R)
                            * (R // trsm_block.SUB_ROWS), dtype=torch.int32,
                            device=B.device)
    args = [L.data_ptr(), L.stride(0), L.stride(1), B.data_ptr(),
            B.stride(0), B.stride(1), X.data_ptr(), flags.data_ptr(), m, n, k]
    if gated:
        args.append(valid.data_ptr())
    build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "trsm")
    return X, flags


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] / 1e3 if xs else None


def breakdown(tr, m, nb, nq, valid) -> dict:
    """Medians (us) over the hops of the valid chains; tr is (ctas, 16),
    by ticket, tickets block-major over m chains (k = 16); nq sub-blocks
    per row block."""
    stored, published = 2 + nq, 6 + nq
    seg = {"flag": [], "load": [], "substitute": [], "publish": [],
           "hop": [], "lead": [], "row_cycles": [], "sm_ghz": [],
           "x_load": [], "to_compute": [], "last_fold": []}
    for z in range(m):
        if valid is not None and not valid[z]:
            continue
        rows = [tr[b * m + z] for b in range(nb)]
        for b in range(1, nb):
            p, c = rows[b - 1], rows[b]
            seg["flag"].append(c[1] - p[published])
            seg["load"].append(c[2] - c[1])
            seg["substitute"].append(c[stored] - c[2])
            seg["publish"].append(c[published] - c[stored])
            seg["hop"].append(c[published] - p[published])
            seg["lead"].append(p[published] - c[0])  # ticket ahead of use
            seg["row_cycles"].append((c[12] - c[11]) * 1e3 / (nq * 16))
            seg["sm_ghz"].append((c[12] - c[11]) * 1e3
                                 / max(c[stored] - c[2], 1))
            for tt in range(8):
                top, mid, end = c[16 + 3 * tt:19 + 3 * tt]
                seg.setdefault(f"set{tt}_chain_cyc", []).append(
                    (mid - top) * 1e3)
                seg.setdefault(f"set{tt}_rest_cyc", []).append(
                    (end - mid) * 1e3)
            seg["x_load"].append(c[13] - c[1])
            seg["to_compute"].append(c[14] - c[13])
            seg["last_fold"].append(c[2] - c[14])
    tail = {k: [] for k in ("flag", "load", "substitute", "slack",
                            "catch_up_per_tile", "lead", "first_half_per_tile",
                            "hand_off_ahead")}
    for z in range(m):
        if valid is not None and not valid[z]:
            continue
        for b in range(nb - 32, nb):   # the last 32 blocks of the chain
            p, c = tr[(b - 1) * m + z], tr[b * m + z]
            tail["flag"].append(c[1] - p[published])
            tail["load"].append(c[2] - c[1])
            tail["substitute"].append(c[stored] - c[2])
            # block b - 1 staged (b - 2 folded) before b - 1 is out?
            tail["slack"].append(p[published] - c[40])
            tail["catch_up_per_tile"].append((c[40] - c[41]) / (b - 1))
            tail["lead"].append(p[published] - c[0])
            # folding tiles 0 .. b / 2, out before the CTA started
            tail["first_half_per_tile"].append((c[42] - c[41]) / (b // 2 + 1))
            # the hand-off warp had tile b / 2 loaded this long before the
            # compute warps were done with it
            tail["hand_off_ahead"].append(c[42] - c[43])
    out = {k: median(v) for k, v in seg.items()}
    out["tail"] = {k: median(v) for k, v in tail.items()}
    hops = seg["hop"]
    out["hop_mean"] = sum(hops) / max(len(hops), 1) / 1e3
    for lo, hi in ((1, 32), (32, 96), (96, nb)):   # by the chain's stretch
        out[f"hop_b{lo}_{hi}"] = median([h for i, h in enumerate(hops)
                                         if lo <= i % (nb - 1) + 1 < hi])
    t0 = min(row[0] for row in tr)
    out["first_publication"] = median(
        [tr[z][published] - t0 for z in range(m)
         if valid is None or valid[z]])
    # the diagonal blocks that overlap another CTA's on the same SM
    spans = [(row[15], row[2], row[stored]) for row in tr if row[stored]]
    by_sm = {}
    for sm, a, e in spans:
        by_sm.setdefault(sm, []).append((a, e))
    shared = [sum(a2 < e and a < e2 for a2, e2 in by_sm[sm]) > 1
              for sm, a, e in spans]
    out["diag_blocks_sharing_an_sm"] = sum(shared) / max(len(shared), 1)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("b3_hops: needs a CUDA card", file=sys.stderr)
        return 1
    libs = build_copies()
    traced, plain = libs["traced"], libs["plain"]
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    ok = True
    for m, ldt, mask in CASES:
        L = torch.empty((m, N, N), dtype=ldt, device=dev)
        for z in range(m):
            A = torch.randn((N, N), generator=g, device=dev,
                            dtype=torch.float64).tril_() / N ** 0.5
            A.diagonal().copy_(1 + torch.rand(N, generator=g, device=dev,
                                              dtype=torch.float64))
            L[z] = A.to(ldt)
            del A
        B = torch.randn((m, N, 16), generator=g, device=dev)
        v = None if mask is None else torch.tensor(mask, dtype=torch.int32,
                                                   device=dev)
        want = trsm_block.trsm_substitution(L, B, valid=v)
        nb = N // trsm_block.ROWS[torch.float32]
        buf = torch.zeros((m * nb, 64), dtype=torch.int64, device=dev)
        build.check(traced.trace_set(ctypes.c_void_p(buf.data_ptr())),
                    "trace_set")
        got = solve(traced, L, B, v)[0]
        torch.cuda.synchronize()
        same = torch.equal(got, want) and torch.equal(
            solve(plain, L, B, v)[0], want)
        ok &= same
        tr = buf.tolist()
        sms = len({row[15] for row in tr})
        t_traced = timer.ms(lambda: solve(traced, L, B, v), 5)
        t_plain = timer.ms(lambda: solve(plain, L, B, v), 5)
        # every flag left set by a solve, the ticket counter reset: no
        # CTA waits, so the launch times the folds alone
        X, done = solve(plain, L, B, v)

        def again():
            done[0] = 0
            solve(plain, L, B, v, done, X)
        t_fold = timer.ms(again, 5)
        buf.zero_()
        done[0] = 0
        solve(traced, L, B, v, done, X)
        torch.cuda.synchronize()
        ph = {"hand_off_fill": (44, 45), "stage": (48, 49),
              "wait_unit": (49, 46), "fold": (46, 47)}
        rows_ = [r for r in buf.tolist() if r[46]]
        phases = {k: median([(r[y] - r[x]) * 1e3 for r in rows_])
                  for k, (x, y) in ph.items()}
        print(json.dumps(dict(
            m=m, mask=mask, bit_equal_shipped=same,
            hop_us_median=breakdown(tr, m, nb, 4, mask), sms_used=sms,
            traced_ms=t_traced, untraced_ms=t_plain,
            flags_set_ms=t_fold, flags_set_tile_cycles=phases)),
            flush=True)
        del L, B, want
        torch.cuda.empty_cache()
    print("B3_HOPS_BIT_EQUAL", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
