#!/usr/bin/env python3
"""Where kernels B1 and B5 (``csrc/tri_inv_levels.cu``) spend their time,
and what the level product's design choices are worth, on one card.

    python3 chip_probes/b1_levels.py

Compiles copies of ``tri_inv_levels.cu`` with one constant changed each
(tiles never or always paired along the triangle, a 16 x 8 fp32 thread
tile, a ring of 3 or 5 k-steps, twice the CTA count below which a level
takes a smaller tile), prints each copy's fp32 level kernels' registers
and spills from ``-Xptxas -v``, and at the phase-2 shapes below holds
each copy bit for bit against the shipped kernels (the copies move
loads, tiles and order, not sums) and times it with CUDA events (median,
L2 flushed before each run, as ``chip_smoke.Timer``), and again with
the host's launches queued ahead of the card (``gpu_ms``).  For every
build it also prints each launch's time (events around every launch of
``tri_inv_block._schedule``, median of 20 runs; a short launch's time
includes the host's launch latency).  Exits 1 if a copy differs.  The
copies are built under ``build/b1_levels/``.
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
from repro_torch.kernels import build, tri_inv_block  # noqa: E402

SRC = build.CSRC / "tri_inv_levels.cu"
OUT = ROOT / "build" / "b1_levels"
F32, F64 = torch.float32, torch.float64
# name: [(text in the shipped source, its replacement), ...]
VARIANTS = {
    "never_paired": [("constexpr int kPairCtas = 256;",
                      "constexpr int kPairCtas = 1 << 30;")],
    "always_paired": [("constexpr int kPairCtas = 256;",
                       "constexpr int kPairCtas = 0;")],
    "fp32_16x8": [("Tile<float, 128, 128, 8, 8, 2>",
                   "Tile<float, 128, 128, 16, 8, 2>")],
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "stages5": [("constexpr int kStages = 4;", "constexpr int kStages = 5;")],
    "min_ctas_264": [("constexpr int kMinCtas = 132;",
                      "constexpr int kMinCtas = 264;")],
}
# (m, n0, dtype, mask or None)
CASES = ((2, 4096, F32, None), (2, 4096, F32, [1, 0]),
         (2, 1024, F32, None), (32, 256, F32, None),
         (4, 2048, F64, [0, 1, 1, 0]))


def variants() -> dict:
    """{name: loaded library} of the edited copies, built in parallel."""
    text = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {SRC.name}")
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(src)
        lib = OUT / f"lib{name}.so"
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(lib), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        print(name, "rc", proc.returncode, json.dumps(fp32_levels(log)),
              flush=True)
        if proc.returncode == 0:
            libs[name] = ctypes.CDLL(str(lib))
        else:
            print(log[-3000:], flush=True)
    return libs


def fp32_levels(log: str) -> dict:
    """{fp32 level tile: (registers, spill store bytes, spill load
    bytes)} of one ``-Xptxas -v`` log, the ungated instantiations."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            m2 = re.search(r"tri_level_kernelIfNS_4TileIfLi(\d+)ELi(\d+)ELi"
                           r"(\d+)ELi(\d+)ELi(\d+)EEELb0", m.group(1))
            cur = "x".join(m2.groups()) if m2 else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out[cur] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = [int(m.group(1))] + out.get(cur, [])
            cur = None
    return out


def launchers(lib, dtype, valid, stream, events=None):
    """The leaf and level launchers of one build of the source; with
    ``events`` (a list), each launch is bracketed by CUDA events."""
    suffix = ("valid_" if valid is not None else "") \
        + tri_inv_block._SUFFIX[dtype]
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    gate = [] if valid is None else [valid.data_ptr()]
    leaf_fn = getattr(lib, f"repro_tri_inv_leaf_{suffix}")
    leaf_fn.argtypes = [P, P, LL, I, I] + [P] * (1 + len(gate))
    level_fn = getattr(lib, f"repro_tri_inv_level_{suffix}")
    level_fn.argtypes = [P, LL, LL, LL] * 3 + [I, I, LL, I, I, I] \
        + [P] * (1 + len(gate))

    def timed(what, fn):
        if events is None:
            return fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((what, s, e))

    def leaf(Ls, out, S):
        m, n0, _ = Ls.shape
        timed("leaf", lambda: build.check(leaf_fn(
            Ls.data_ptr(), out.data_ptr(), m, n0, S, *gate, stream), "leaf"))

    def gemm(a, b, c, s, nq, batch, *, tri_a, tri_b, negate):
        args = []
        for t, off, ld, sb, sq in (a, b, c):
            args += [t.data_ptr() + off * t.element_size(), ld, sb, sq]
        timed(f"s={s} {'tri_a' if tri_a else 'tri_b'}",
              lambda: build.check(level_fn(*args, s, nq, batch, int(tri_a),
                                           int(tri_b), int(negate), *gate,
                                           stream), "level"))

    return leaf, gemm


def invert(lib, Ls, valid, events=None):
    m, n0, _ = Ls.shape
    out = torch.empty_like(Ls)
    scratch = torch.empty(max(m * n0 * n0 // 4, 1), dtype=Ls.dtype,
                          device=Ls.device)
    tri_inv_block._schedule(Ls, out, scratch, *launchers(
        lib, Ls.dtype, valid, torch.cuda.current_stream().cuda_stream,
        events))
    return out


def gpu_ms(timer, fn, reps: int) -> float:
    """Median event time of fn with the host ahead of the card: a spin
    kernel of ~2 ms runs first, so every launch of fn is queued before
    the card reaches the start event (no host latency in the time)."""
    fn()
    pairs = []
    for _ in range(reps):
        timer.flush_buf.zero_()
        torch.cuda._sleep(4_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print("card:", chip_smoke.card_line(), flush=True)
    paths = build.build_all()
    shipped = ctypes.CDLL(str(paths["tri_inv_levels"]))
    print("shipped", json.dumps(fp32_levels(
        (build.BUILD_DIR / f"{paths['tri_inv_levels'].stem}.log")
        .read_text())), flush=True)
    libs = {"shipped": shipped, **variants()}
    dev = torch.device("cuda")
    timer = chip_smoke.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    ok = True
    for m, n0, dtype, mask in CASES:
        Ls = (torch.randn((m, n0, n0), generator=g, device=dev).tril_()
              + n0 * torch.eye(n0, device=dev)).to(dtype)
        v = None if mask is None else torch.tensor(mask, dtype=torch.int32,
                                                   device=dev)
        want = tri_inv_block.tri_inv_blocks(Ls, valid=v)
        reps = 5 if n0 >= 2048 else 20
        row, gpu = {}, {}
        for name, lib in libs.items():
            got = invert(lib, Ls, v)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(name, "differs from the shipped kernels", flush=True)
                ok = False
                continue
            row[name] = timer.ms(lambda: invert(lib, Ls, v), reps)  # noqa
            gpu[name] = gpu_ms(timer, lambda: invert(lib, Ls, v), reps)  # noqa
        per = {}
        for name, lib in libs.items():
            runs = {}
            for _ in range(20):
                events = []
                invert(lib, Ls, v, events)
                torch.cuda.synchronize()
                for what, s, e in events:
                    runs.setdefault(what, []).append(s.elapsed_time(e))
            per[name] = {k: round(float(np.median(x)), 4)
                         for k, x in runs.items()}
        print(json.dumps(dict(shape=[m, n0, n0], dtype=str(dtype), mask=mask,
                              ms=row, gpu_ms=gpu)), flush=True)
        for name, launches in per.items():
            print(json.dumps(dict(variant=name, per_launch_ms=launches)),
                  flush=True)
        del Ls, want
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
