#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and a checkout of this repository (it imports the
port from ``src/``); imports nothing of JAX or of the JAX package.
Phases, in order; any failed check raises, so the exit code is not 0:

1. Card: the name and power limit as nvidia-smi reports them.
2. Kernels: builds ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, all started together), runs each kernel
   at the main paths' shapes on inputs where every level, tile and row
   block shows (tril(randn) + n0 I to invert, a dense tril(randn) to
   multiply, tril(randn) / sqrt(n) with a diagonal in [1, 2) to solve),
   holds it against its plain PyTorch version and prints one JSON line
   per case: errors (an inverse's strictly lower part also against its
   own scale; for the substitution, how far leaving out the
   off-diagonal part or one row block's contribution would move X, in
   tolerances; its path case is the bf16 factor with fp32 X that
   bf16_refine solves with, and an fp32 case of the same shape
   follows), the kernel's, the plain version's and one PyTorch
   library call's time (CUDA events, median over runs, L2 flushed
   before each run), and the least time the card could take (bytes over
   3.35 TB/s or flops over the dtype's peak, the larger).  The
   inversion's cases (B1, B5) also carry each of its kernels' registers
   per thread and resident CTAs per SM (``tri_inv_block.kernel_info``);
   B1 also runs at (2, 1024, 1024), the fleet's bucket-2048 admission at
   n0 = 1024.  trmm (B2,
   ``trmm_phase``) also runs over the (16, 4096, 4096) and (8, 4096,
   4096) x 16 bf16 stacks of the churn bank and the fleet's bucket, and
   every B2 case checks that two launches give the same bits and that
   NaN above the diagonal changes none.  The
   block-masked trmm (B4) runs at the structured residual's shape and
   three more (``masked_phase``), each also with NaN planted in its
   skipped blocks, launched twice, and under a mask keeping every lower
   block held bit for bit against B2; its records carry the kernel's
   registers and CTAs per SM (``trmm.kernel_info``).  The ordered
   product (``gemm_phase``; ``trmm.gemm``, no TPU kernel) is timed
   beside torch.matmul at a width-1 capacity bank's residual and
   trailing update.  The validity-gated substitution (B6, ``valid_phase``)
   runs at a capacity bank's rec base case (16, 8192, 8192) x 16 with
   half its mask zero, on strided quadrant views and in fp64, each also
   with NaN planted in its invalid systems and with an all-ones mask
   held bit for bit against B3; the substitution's records (B3, B6) also
   carry the kernel's registers per thread and resident CTAs per SM
   (``trsm_block.kernel_info``).  The validity-gated inversion (B5,
   ``valid_inv_phase``) runs at a padded admission's phase 1 into the
   order-8192 bucket, (2, 4096, 4096) fp32 with the identity tail's
   block flagged, and at (16, 256, 256) fp32 and (4, 2048, 2048) fp64,
   each also with NaN in its flagged blocks and with an all-ones mask
   held bit for bit against B1.
3. The slice at full size: a factor of order n = 8192 (the Kronecker
   factor of an 8192-wide layer, the hidden width of 70B-class models),
   L = tril(randn) + n I from seed 0, served through
   ``api.Solver.from_factor`` and ``api.SolveServer(panel_k=16)``: 64
   requests of widths 1..16 per configuration.  It-Inv ("inv", the
   main path of kernels B1 and B2): bf16_refine at the default
   n0 = 4096, fp32, bf16_refine at n0 = 256.  The recursive baseline
   ("rec", the main path of kernel B3): bf16_refine and fp32 at the
   default n0 (= n at p = 1: one base case), bf16_refine at n0 = 512.
   Every request's relative residual ||L X - B|| / ||B|| is computed in
   fp64 on the card and held to the bound the reference asserts for
   the preset (tests/test_api_solver.py: 1e-5 for fp32 and
   bf16_refine).  The launch counters are set to 0 before each
   configuration and read after it: for "inv" tri_inv_blocks once and
   trmm exactly m * (refine passes + 1) times per solve, for "rec"
   trsm_substitution exactly n / n0 * (refine passes + 1) times per
   solve and no other kernel (trmm_masked included).
4. Steady state: after warmup, ``solve`` on a placed RHS under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), with no
   program built and a cache hit, for both main paths.
5. The other entry points: one-shot ``api.trsm`` with "inv" (n0 =
   4096 and the planned n0), "rec" and "auto" on the same factor,
   relres checked, each launching exactly the kernels of the plan it
   resolves, and the plans that ``Solver.from_factor(method="auto")`` and
   ``SolveSpec.auto`` resolve under the H100 cost model.
6. Where the time goes: 10 steady-state solves of each configuration
   under torch.profiler — device time by kernel and the device's busy
   share of the host-clock window.
7. Structured factors (``structured_phase``), bf16_refine on the same
   factor: "inv" with banded:1024 at n0 = 512 (the main path of B4),
   with the 8x8 block-sparse mask at n0 = 1024, and with banded:1024 at
   the H100 planner's n0 (printed with the planner's choices); "rec"
   with banded:1024 at n0 = 512.  Served and counted as in phase 3,
   with B4 once per refinement pass and the relres against the masked
   operator; then the NaN-poisoned factor, the dense program where the
   mask keeps every block, the steady state, and profiler windows beside
   the dense program at the same n0.
8. Live-mutable capacity banks (``churn_phase``), "inv" then "rec",
   one after the other (the first bank is freed before the second):
   C = 16 slots of order 8192, bf16_refine, warmed up empty, half
   filled, churned on the reference CLI's trsm-churn schedule, with a
   replace_run and a padded admission; relres after every wave against
   each slot's current factor, dead lanes exactly zero, no build, no
   host sync around a replace, exact launches (a rec bank's base cases
   on B6 only), ms per wave, per update and per admission, and a
   profiler window of 10 steady waves.
9. The mixed-order fleet (``fleet_phase``): the reference CLI's
   trsm-fleet configuration at n = 8192 (two tenants, orders 8192, 4096
   and 2048, 2 factors per order each, bf16_refine), planned under the
   H100 preset (the plan is printed, with whether it is the expected
   8192 bucket holding 8192 and 4096 beside a 2048 bucket), admitted
   (the order-4096 factors padded, phase 1 on B5) and served through a
   fleet-mode SolveServer on the CLI's schedule: 192 requests in 24
   waves, a replace after each, a tenant-c burst reclaiming the coldest
   slot every third; a placed replace and its waves under sync-debug
   mode "error"; 10 profiled waves; one live migration onto the plan at
   dispatch_s = 1e-4 (one bucket of capacity 12, rebuilt, every
   resident re-admitted) and 4 more waves.  relres per request <= 1e-5,
   padded tails zero, a stale handle refused, no build but the rebuilt
   bucket's, a padded slot's Dt equal to B1's, B5 once per padded
   phase-1 run; ms per fleet wave, device ms per wave, ms per padded
   and unpadded admission, per replace, for the migration, the fleet's
   stats table, and the host time of one bucket-wave dispatch beside
   the planner's nominal 50 us.
10. The card line, the kernels' JSON summary, then the last line
   ``{"ok": true, "device": {...}}``.  Each kernel's launches are those
   of its main path's run: B1 and B2 the inv configuration at the
   default n0, B3 the rec one, B4 the first structured one, B6 the rec
   churn phase, B5 the fleet phase.
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,            # IEEE fp32, CUDA cores
              torch.bfloat16: 989e12,          # bf16 tensor cores, dense
              torch.float64: 34e12}            # IEEE fp64, CUDA cores
N = 8192
PANEL_K = 16
REQUESTS = 64
RELRES_BOUND = {"fp32": 1e-5, "bf16_refine": 1e-5}
# inv: (precision, n0); the first is the main path of B1 and B2
INV_CONFIGS = (("bf16_refine", None), ("fp32", None), ("bf16_refine", 256))
# rec: the first is the main path of B3
REC_CONFIGS = (("bf16_refine", None), ("fp32", None), ("bf16_refine", 512))
# structured, bf16_refine: (method, structure, n0); the first is the main
# path of B4, None the planner's n0
STRUCTURED_CONFIGS = (("inv", "banded:1024", 512),
                      ("inv", "block-sparse", 1024),
                      ("inv", "banded:1024", None),
                      ("rec", "banded:1024", 512))
# churn: a capacity bank of the reference CLI's default --bank 16 (one
# Kronecker factor per layer of a 16-layer slice), its trsm-churn
# schedule (--requests 256 --updates 32), bf16_refine
CHURN_CAPACITY = 16
CHURN_REQUESTS = 256
CHURN_UPDATES = 32
CHURN_RELRES = 1e-5
SYNC_GUARD_WAVE = 10        # this wave, the replace after it, the next
# fleet: the reference CLI's trsm-fleet configuration (two tenants, orders
# [n, n/2, n/4], 2 factors per order each; --requests and --updates as
# the churn's, scaled to 24 waves), bf16_refine, and the plan the H100
# preset gives it (bucket n, member orders, capacity, method, n0)
FLEET_PER_ORDER = 4
FLEET_REQUESTS = 192
FLEET_WAVES = 24
FLEET_AFTER_WAVES = 4
FLEET_RELRES = 1e-5
FLEET_MIGRATE_DISPATCH_S = 1e-4
FLEET_EXPECTED_PLAN = [[N, [N, N // 2], 8, "inv", N // 2],
                       [N // 4, [N // 4], 4, "inv", N // 8]]


class SmokeFailure(RuntimeError):
    pass


def named(structure) -> str:
    """A structure as the CLI spells it."""
    if structure.kind == "banded":
        return f"banded:{structure.bandwidth}"
    return f"block-sparse {len(structure.mask)}x{len(structure.mask)}"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a call, each run after an L2 flush."""

    def __init__(self, device):
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8,
                                     device=device)          # > 50 MB L2

    def ms(self, fn, reps: int, warm: int = 2) -> float:
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def errors(got, want) -> tuple:
    diff = (got.double() - want.double()).abs().max().item()
    return diff, diff / max(want.double().abs().max().item(), 1e-300)


def lower_rel_error(got, want) -> float:
    """max |tril(got - want, -1)| over max |tril(want, -1)|: an
    inverse's strictly lower entries are ~1/n0^2 against ~1/n0 on its
    diagonal, so an error relative to the whole matrix cannot see them."""
    diff = torch.tril(got.double() - want.double(), -1).abs().max().item()
    return diff / max(torch.tril(want.double(), -1).abs().max().item(),
                      1e-300)


def kernel_phase(device, timer):
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel: the main-path case's record}.

    The inputs are chosen so that every level and every tile shows in
    the comparison: tri_inv_blocks inverts tril(randn) + n0 I (the
    reference kernel tests' input), whose strictly lower part is held
    against its own scale; trmm multiplies a dense tril(randn), so each
    of the L tiles left of the diagonal adds as much to C as the
    diagonal tile does.  Neither kernel's work depends on the data."""
    from repro_torch.kernels import tri_inv_block, trmm
    g = torch.Generator(device=device).manual_seed(1)
    records = {}
    # tri_inv_blocks: n0 = 4096 (bf16_refine and fp32 admissions invert
    # in fp32), n0 = 256, and bf16 operands at both; n0 = 1024, the fleet's
    # bucket-2048 admission
    for m, n0, dtype in ((2, 4096, torch.float32), (2, 4096, torch.bfloat16),
                         (32, 256, torch.float32),
                         (32, 256, torch.bfloat16),
                         (2, 1024, torch.float32)):
        Ls = (torch.randn((m, n0, n0), generator=g, device=device).tril_()
              + n0 * torch.eye(n0, device=device)).to(dtype)
        got = tri_inv_block.tri_inv_blocks(Ls)
        want = tri_inv_block.tri_inv_blocks_plain(Ls)
        abs_err, rel_err = errors(got, want)
        low_err = lower_rel_error(got, want)
        eye = torch.eye(n0, device=device, dtype=torch.float64)
        ident = (torch.tril(Ls).double() @ got.double() - eye).abs().max()
        # bf16: one rounding flip of t or N21 is 2^-8 of an entry; fp32:
        # reordered fp32 sums over n0/2 terms stay near 1e-6
        tol, ident_tol = (2e-2, 5e-2) if dtype == torch.bfloat16 \
            else (1e-4, 1e-4)
        check(rel_err <= tol, f"tri_inv_blocks {tuple(Ls.shape)} {dtype}: "
                              f"max_rel_err {rel_err} > {tol}")
        check(low_err <= tol, f"tri_inv_blocks {tuple(Ls.shape)} {dtype}: "
                              f"strictly lower part off by {low_err} of "
                              f"its max > {tol}")
        check(ident.item() <= ident_tol,
              f"tri_inv_blocks {tuple(Ls.shape)} {dtype}: |L Linv - I| "
              f"{ident.item()} > {ident_tol}")
        reps = 5 if n0 >= 4096 else 20
        k_ms = timer.ms(lambda: tri_inv_block.tri_inv_blocks(Ls), reps)
        p_ms = timer.ms(lambda: tri_inv_block.tri_inv_blocks_plain(Ls), reps)
        lib_ms = None          # solve_triangular has no bf16 CUDA kernel
        if dtype == torch.float32:
            I = torch.eye(n0, device=device, dtype=dtype).expand(m, n0, n0)
            lib_ms = timer.ms(lambda: torch.linalg.solve_triangular(
                Ls, I, upper=False), reps)
        tri = m * n0 * (n0 + 1) // 2
        b_ms, b_by = bound(2 * tri * Ls.element_size(), m * n0**3 / 3,
                           dtype)
        rec = dict(kernel="tri_inv_blocks", data="tril(randn) + n0 I",
                   shape=list(Ls.shape),
                   dtype=str(dtype).removeprefix("torch."),
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   lower_rel_err=low_err, tol=tol,
                   identity_err=ident.item(), kernel_ms=k_ms, plain_ms=p_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   kernel_info=tri_inv_block.kernel_info(dtype))
        print(json.dumps(rec), flush=True)
        if (m, n0, dtype) == (2, 4096, torch.float32):
            records["tri_inv_blocks"] = rec
    records["trmm"] = trmm_phase(device, timer, g)
    records["trsm_substitution"] = substitution_phase(device, timer, g)
    records["trmm_masked"] = masked_phase(device, timer, g)
    gemm_phase(device, timer, g)
    records["trsm_substitution_valid"] = valid_phase(device, timer, g)
    records["tri_inv_blocks_valid"] = valid_inv_phase(device, timer, g)
    return records


def trmm_phase(device, timer, g):
    """trmm (B2) against its plain version: the solve step X_i = Dt_i @
    B_i at the sweep's shapes, (1, 4096, 4096) x 16 in bf16 (the main
    path's case, whose record this returns) and fp32 and (1, 256, 256) x
    16 in bf16, then over the stacks the banks multiply, (16, 4096,
    4096) x 16 (the C = 16 churn bank) and (8, 4096, 4096) x 16 (the
    fleet's C = 8 bucket), bf16.  Dt is a dense tril(randn), so each of
    the L tiles left of the diagonal adds as much to C as the diagonal
    tile does.  Each case also checks that a second launch gives the
    same bits and that NaN planted strictly above Dt's diagonal changes
    no bit of C.  The library call is torch.matmul on the same (full)
    operands; the bound counts the triangles and X read once and C
    written once, and the triangles' flops."""
    from repro_torch.kernels import trmm
    main = None
    for b, n0, dtype in ((1, 4096, torch.bfloat16), (1, 4096, torch.float32),
                         (1, 256, torch.bfloat16), (16, 4096, torch.bfloat16),
                         (8, 4096, torch.bfloat16)):
        Dt = torch.randn((b, n0, n0), generator=g,
                         device=device).tril_().to(dtype)
        X = torch.randn((b, n0, PANEL_K), generator=g, device=device,
                        dtype=torch.float32).to(dtype)
        got, want = trmm.trmm(Dt, X), trmm.trmm_plain(Dt, X)
        abs_err, rel_err = errors(got, want)
        what = f"trmm {tuple(Dt.shape)} @ {tuple(X.shape)} {dtype}"
        # bf16: exact products, fp32 sums, one output rounding (2^-8)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        check(rel_err <= tol, f"{what}: max_rel_err {rel_err} > {tol}")
        twice_equal = torch.equal(trmm.trmm(Dt, X), got)
        check(twice_equal, f"{what}: two launches differ")
        upper = torch.ones((n0, n0), dtype=torch.bool,
                           device=device).triu_(1)
        poisoned = Dt.masked_fill(upper, float("nan"))
        poisoned_equal = torch.equal(trmm.trmm(poisoned, X), got)
        check(poisoned_equal, f"{what}: NaN above the diagonal reached C")
        del poisoned, upper, want
        reps = 20 if b > 1 else 50
        k_ms = timer.ms(lambda: trmm.trmm(Dt, X), reps)
        p_ms = timer.ms(lambda: trmm.trmm_plain(Dt, X), reps)
        lib_ms = timer.ms(lambda: torch.matmul(Dt, X), reps)
        nbytes = b * (n0 * (n0 + 1) // 2 + 2 * n0 * PANEL_K) \
            * Dt.element_size()
        b_ms, b_by = bound(nbytes, b * n0 * (n0 + 1) * PANEL_K, dtype)
        rec = dict(kernel="trmm", data="tril(randn) @ randn",
                   shape=[list(Dt.shape), list(X.shape)],
                   dtype=str(dtype).removeprefix("torch."),
                   max_abs_err=abs_err, max_rel_err=rel_err, tol=tol,
                   two_launches_bit_equal=twice_equal,
                   nan_above_diagonal_bit_equal=poisoned_equal,
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        print(json.dumps(rec), flush=True)
        if main is None:
            main = rec
        del Dt, X, got
    torch.cuda.empty_cache()
    return main


def valid_inv_phase(device, timer, g):
    """tri_inv_blocks(valid=) (B5) against its plain version: a padded
    admission's phase 1 into the order-8192 bucket, (2, 4096, 4096) fp32
    with block 1 (the identity tail) flagged 0, as bf16_refine inverts
    it (the main path's case, whose record this returns); (16, 256, 256)
    fp32 with half the mask zero; (4, 2048, 2048) fp64 with 2 valid.
    Blocks are tril(randn) + n0 I, as B1's.  Each case also checks that
    the flagged blocks come out exactly zero, that NaN planted in every
    flagged block's L changes no bit, and that an all-ones mask gives
    B1's output bit for bit, and times B1 on the same stack.  The library
    call is solve_triangular(L, I) on the valid blocks only
    (index_select'ed outside the timed region); the bound counts the
    valid blocks' triangles read once and the whole output written, and
    the valid blocks' n0^3 / 3 flops."""
    from repro_torch.kernels import tri_inv_block
    main = None
    for m, n0, dtype, mask in ((2, 4096, torch.float32, [1, 0]),
                               (16, 256, torch.float32, [1, 0] * 8),
                               (4, 2048, torch.float64, [0, 1, 1, 0])):
        v = torch.tensor(mask, dtype=torch.int32, device=device)
        live = v.bool()
        Ls = (torch.randn((m, n0, n0), generator=g, device=device,
                          dtype=torch.float64).tril_()
              + n0 * torch.eye(n0, device=device,
                               dtype=torch.float64)).to(dtype)
        got = tri_inv_block.tri_inv_blocks(Ls, valid=v)
        want = tri_inv_block.tri_inv_blocks_plain(Ls, valid=v)
        abs_err, rel_err = errors(got, want)
        low_err = lower_rel_error(got[live], want[live])
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        what = (f"tri_inv_blocks(valid=) {tuple(Ls.shape)} {dtype}, "
                f"{int(live.sum())} of {m} valid")
        check(rel_err <= tol, f"{what}: max_rel_err {rel_err} > {tol}")
        check(low_err <= tol, f"{what}: strictly lower part off by "
                              f"{low_err} of its max > {tol}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(not got[~live].any(), f"{what}: a flagged block is not zero")
        Lp = Ls.clone()
        Lp[~live] = float("nan")
        poisoned_equal = torch.equal(
            tri_inv_block.tri_inv_blocks(Lp, valid=v), got)
        check(poisoned_equal, f"{what}: NaN in a flagged block reached the "
                              f"output")
        del Lp
        all_ones_equal = torch.equal(
            tri_inv_block.tri_inv_blocks(Ls, valid=torch.ones_like(v)),
            tri_inv_block.tri_inv_blocks(Ls))
        check(all_ones_equal, f"{what}: an all-ones mask is not B1")
        reps = 5 if n0 >= 2048 else 20
        k_ms = timer.ms(lambda: tri_inv_block.tri_inv_blocks(Ls, valid=v),
                        reps)
        b1_ms = timer.ms(lambda: tri_inv_block.tri_inv_blocks(Ls), reps)
        p_ms = timer.ms(lambda: tri_inv_block.tri_inv_blocks_plain(
            Ls, valid=v), reps)
        idx = torch.nonzero(live).flatten()
        L_lib = Ls.index_select(0, idx)
        I = torch.eye(n0, device=device, dtype=dtype).expand_as(L_lib)
        lib_ms = timer.ms(lambda: torch.linalg.solve_triangular(
            L_lib, I, upper=False), reps)
        del L_lib, I
        nv = int(live.sum())
        nbytes = (nv * n0 * (n0 + 1) // 2 + m * n0 * n0) * Ls.element_size()
        b_ms, b_by = bound(nbytes, nv * n0**3 / 3, dtype)
        rec = dict(kernel="tri_inv_blocks_valid", data="tril(randn) + n0 I",
                   shape=list(Ls.shape), mask=mask, valid_blocks=nv,
                   dtype=str(dtype).removeprefix("torch."),
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   lower_rel_err=low_err, tol=tol,
                   poisoned_bit_equal=poisoned_equal,
                   all_ones_equal_b1=all_ones_equal,
                   kernel_ms=k_ms, b1_unmasked_ms=b1_ms, plain_ms=p_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   kernel_info=tri_inv_block.kernel_info(dtype, gated=True))
        print(json.dumps(rec), flush=True)
        if main is None:
            main = rec
        del Ls, got, want
    torch.cuda.empty_cache()
    return main


def substitution_phase(device, timer, g):
    """trsm_substitution against its plain version: the rec path's whole
    solve (1, 8192, 8192) x 16, first with the bf16 factor and fp32 X
    of bf16_refine (the main path's entry, whose record this returns),
    then in fp32; the base case (1, 512, 512) x 16 in fp32, an fp64
    case, and a batched one with ragged n and k.  The systems are
    tril(randn) / sqrt(n) with a diagonal in [1, 2), rounded to the
    factor's dtype, so the off-diagonal part moves X as much as the
    diagonal does; each case prints how far leaving it out, or leaving
    out one row block's contribution (fp64 library solve of the altered
    factor), would move X, in tolerances."""
    from repro_torch.kernels import trsm_block
    main = None
    for m, n, k, ldtype, dtype in (
            (1, N, PANEL_K, torch.bfloat16, torch.float32),
            (1, N, PANEL_K, torch.float32, torch.float32),
            (1, 512, PANEL_K, torch.float32, torch.float32),
            (1, 2048, PANEL_K, torch.float64, torch.float64),
            (4, 1000, 21, torch.float32, torch.float32)):
        L = torch.randn((m, n, n), generator=g, device=device,
                        dtype=torch.float64).tril_() / n ** 0.5
        L.diagonal(dim1=-2, dim2=-1).copy_(
            1 + torch.rand((m, n), generator=g, device=device,
                           dtype=torch.float64))
        L = L.to(ldtype).double()
        B = torch.randn((m, n, k), generator=g, device=device,
                        dtype=torch.float64)
        R = trsm_block.ROWS[dtype]
        b0 = (n // R - 1) // 2 * R             # a row block mid-chain
        L_drop = L.clone()
        L_drop[:, b0 + R:, b0:b0 + R] = 0
        X_drop = torch.linalg.solve_triangular(L_drop, B, upper=False)
        L, B = L.to(ldtype), B.to(dtype)
        got = trsm_block.trsm_substitution(L, B)
        want = trsm_block.trsm_substitution_plain(L, B)
        abs_err, rel_err = errors(got, want)
        # fp32: sequential FMA dots against cuBLAS's order, carried into
        # later rows (a bf16 factor is widened exactly, so the same);
        # fp64 the same at its own epsilon
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        what = f"trsm_substitution {tuple(L.shape)} {ldtype} x {k} {dtype}"
        check(rel_err <= tol, f"{what}: max_rel_err {rel_err} > {tol}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite X")
        scale = want.double().abs().max().item()
        diag_only = B.double() / L.double().diagonal(
            dim1=-2, dim2=-1)[..., None]
        off_diag_ratio = (diag_only - want.double()).abs().max().item() \
            / (tol * scale)
        drop_ratio = (X_drop - want.double()).abs().max().item() \
            / (tol * scale)
        check(min(off_diag_ratio, drop_ratio) > 10,
              f"{what}: the comparison cannot see a missing block "
              f"({off_diag_ratio}, {drop_ratio})")
        big = n >= 4096
        k_ms = timer.ms(lambda: trsm_block.trsm_substitution(L, B),
                        5 if big else 20)
        p_ms = timer.ms(lambda: trsm_block.trsm_substitution_plain(L, B),
                        2 if big else 3, warm=0)
        # solve_triangular takes one dtype for both operands, and no bf16
        # on CUDA: for a bf16 factor there is no one library call, so it
        # is timed on an fp32 copy of the factor, apart
        L_lib = L if ldtype == dtype else L.to(dtype)
        lib_ms = timer.ms(lambda: torch.linalg.solve_triangular(
            L_lib, B, upper=False), 5 if big else 20)
        nbytes = m * n * (n + 1) // 2 * L.element_size() \
            + 2 * m * n * k * B.element_size()
        b_ms, b_by = bound(nbytes, m * n * n * k, dtype)
        rec = dict(kernel="trsm_substitution",
                   data="tril(randn) / sqrt(n), diagonal in [1, 2)",
                   shape=[list(L.shape), list(B.shape)],
                   dtype=str(dtype).removeprefix("torch."),
                   factor_dtype=str(ldtype).removeprefix("torch."),
                   max_abs_err=abs_err, max_rel_err=rel_err, tol=tol,
                   off_diagonal_in_tols=off_diag_ratio,
                   one_row_block_in_tols=drop_ratio,
                   kernel_ms=k_ms, plain_ms=p_ms,
                   library_ms=lib_ms if ldtype == dtype else None,
                   library_ms_fp32_factor=None if ldtype == dtype
                   else lib_ms,
                   bound_ms=b_ms, bound_by=b_by,
                   rows_per_ms=n / k_ms,
                   **trsm_block.kernel_info(ldtype, dtype))
        print(json.dumps(rec), flush=True)
        if main is None:
            main = rec
    return main


def masked_cases():
    """B4's phase-2 cases: (n, bt, dtype, structure, (n/bt, n/bt) bool
    mask).  The structured residual's shape (1, 8192, 8192) x 16 fp32
    with the banded:1024 mask at bt = 512 (the main path's case), the
    8x8 block-sparse mask at bt = 1024, an fp64 case (the fp64_refine
    residual) at n = 2048 with banded:256 at bt = 256, and a seeded
    random mask at bt = 32."""
    from repro_torch.core.structure import FactorStructure
    rng = np.random.default_rng(2)
    rand = np.tril(rng.random((16, 16)) < 0.3) | np.eye(16, dtype=bool)
    return (
        (N, 512, torch.float32, "banded:1024",
         FactorStructure.parse("banded:1024").block_mask(N, 512)),
        (N, 1024, torch.float32, "block-sparse",
         FactorStructure.parse("block-sparse").block_mask(N, 1024)),
        (2048, 256, torch.float64, "banded:256",
         FactorStructure.parse("banded", n=2048).block_mask(2048, 256)),
        (512, 32, torch.float32, "random 16x16", rand))


def masked_phase(device, timer, g):
    """trmm_masked (B4) against its plain version at ``masked_cases``
    (the first is the main path's case, whose record this returns).
    The factor is a dense tril(randn) masked by the kernel; each case
    checks that NaN planted in the skipped blocks and above the
    diagonal changes no bit of C, that two launches give the same bits
    and that a mask keeping every lower block gives B2's (``trmm.trmm``)
    bits, and prints how far leaving out one more kept block would move
    C, in tolerances, and the kernel's registers and CTAs per SM.  The
    library time is torch.matmul on the dense masked factor, what an
    unstructured residual costs; the bound counts the kept blocks
    (diagonal blocks as triangles), X and C."""
    from repro_torch.kernels import trmm
    main = None
    info = {}
    for n, bt, dtype, what, bm in masked_cases():
        mask = torch.as_tensor(bm.astype(np.int32), device=device)
        L = torch.randn((1, n, n), generator=g, device=device,
                        dtype=torch.float64).tril_().to(dtype)
        X = torch.randn((1, n, PANEL_K), generator=g, device=device,
                        dtype=torch.float64).to(dtype)
        elem = mask.bool().repeat_interleave(bt, 0) \
            .repeat_interleave(bt, 1)
        got = trmm.trmm_masked(L, X, mask, bt)
        want = trmm.trmm_masked_plain(L, X, mask, bt)
        abs_err, rel_err = errors(got, want)
        tol = 2e-5                   # fp32 / fp64 sums in another order
        case = f"trmm_masked {n} bt={bt} {what} {dtype}"
        check(rel_err <= tol, f"{case}: max_rel_err {rel_err} > {tol}")
        poisoned = torch.where(elem & torch.ones_like(elem).tril(), L,
                               torch.full_like(L, float("nan")))
        same = torch.equal(trmm.trmm_masked(poisoned, X, mask, bt), got)
        check(same, f"{case}: NaN in a skipped block reached C")
        del poisoned
        twice = torch.equal(trmm.trmm_masked(L, X, mask, bt), got)
        check(twice, f"{case}: two launches differ")
        lower = torch.ones_like(mask).tril_()
        as_b2 = torch.equal(trmm.trmm_masked(L, X, lower, bt),
                            trmm.trmm(L, X))
        check(as_b2, f"{case}: an all-lower mask does not give B2's bits")
        # leave out one more kept block: the last off-diagonal one
        ii, jj = np.nonzero(np.tril(bm, -1))
        drop = bm.copy()
        drop[ii[-1], jj[-1]] = False
        dropped = trmm.trmm_masked_plain(
            L, X, torch.as_tensor(drop.astype(np.int32), device=device), bt)
        scale = want.double().abs().max().item()
        drop_tols = (dropped.double() - want.double()).abs().max().item() \
            / (tol * scale)
        check(drop_tols > 10, f"{case}: the comparison cannot see a "
                              f"missing block ({drop_tols})")
        big = n >= 4096
        k_ms = timer.ms(lambda: trmm.trmm_masked(L, X, mask, bt), 50)
        p_ms = timer.ms(lambda: trmm.trmm_masked_plain(L, X, mask, bt),
                        5 if big else 20)
        Lm = torch.where(elem, L, torch.zeros_like(L))
        lib_ms = timer.ms(lambda: torch.matmul(Lm, X), 50)
        blocks = int(bm.sum())
        diag = bm.shape[0]
        elems = (blocks - diag) * bt * bt + diag * bt * (bt + 1) // 2
        nbytes = elems * L.element_size() \
            + 2 * n * PANEL_K * X.element_size()
        b_ms, b_by = bound(nbytes, 2 * elems * PANEL_K, dtype)
        if dtype not in info:
            info[dtype] = trmm.kernel_info(dtype)
        path = "gated" if bt % (128 // L.element_size()) else "16-byte"
        rec = dict(kernel="trmm_masked", data="tril(randn), block mask",
                   structure=what, shape=[list(L.shape), list(X.shape)],
                   bt=bt, kept_blocks=blocks,
                   lower_blocks=diag * (diag + 1) // 2,
                   dtype=str(dtype).removeprefix("torch."),
                   max_abs_err=abs_err, max_rel_err=rel_err, tol=tol,
                   poisoned_bit_equal=same, two_launches_bit_equal=twice,
                   all_lower_mask_is_b2=as_b2,
                   one_kept_block_in_tols=drop_tols,
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, path=path,
                   kernel_info=info[dtype][path])
        print(json.dumps(rec), flush=True)
        if main is None:
            main = rec
        del L, X, Lm, elem, got, want, dropped
    torch.cuda.empty_cache()
    return main


def gemm_phase(device, timer, g):
    """The ordered product ``trmm.gemm`` (``SolveSpec.fixed_order``: a
    width-1 capacity bank's updates and residuals; no TPU kernel) at a
    width-1 bank's shapes: the residual tril(L) @ X at (1, 8192, 8192) x
    16 fp32 (``lower=True``) and one trailing update, the (4096, 4096)
    block column L[4096:, :4096] of an order-8192 factor (row stride
    8192) @ (4096, 16).  Held against torch.matmul in fp64; timed beside
    one torch.matmul (cuBLAS) on the same operands; the bound counts A
    (its triangle for the residual), X and C once and the flops."""
    from repro_torch.kernels import trmm
    F = torch.randn((N, N), generator=g, device=device).tril_()
    for what, A, lower in (("residual", F[None], True),
                           ("trailing update", F[None, N // 2:, :N // 2],
                            False)):
        m, kk = A.shape[1:]
        X = torch.randn((1, kk, PANEL_K), generator=g, device=device)
        got = trmm.gemm(A, X, lower=lower)
        want = torch.matmul(A.double(), X.double())
        abs_err, rel_err = errors(got, want)
        tol = 2e-5
        check(rel_err <= tol, f"gemm {what}: max_rel_err {rel_err} > {tol}")
        k_ms = timer.ms(lambda: trmm.gemm(A, X, lower=lower), 50)
        lib_ms = timer.ms(lambda: torch.matmul(A, X), 50)
        elems = m * (m + 1) // 2 if lower else m * kk
        b_ms, b_by = bound(4 * (elems + (kk + m) * PANEL_K),
                           2 * elems * PANEL_K, torch.float32)
        print(json.dumps(dict(
            kernel="gemm", what=what, tpu_kernel=None,
            shape=[list(A.shape), list(X.shape)], a_strides=list(A.stride()),
            lower=lower, dtype="float32", max_abs_err=abs_err,
            max_rel_err=rel_err, tol=tol, kernel_ms=k_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)), flush=True)
        del X, got, want
    del F
    torch.cuda.empty_cache()


def valid_phase(device, timer, g):
    """trsm_substitution(valid=) (B6) against its plain version: a
    capacity bank's whole rec base case (16, 8192, 8192) x 16 with the
    bf16 factor and fp32 X of bf16_refine and the first half of the mask
    zero, as the churn bank at half occupancy has it (the main path's
    case, whose record this returns); (16, 512, 512) x 16 fp32 on strided
    quadrant views of a (16, 1024, 1024) stack; (8, 2048, 2048) x 16 in
    fp64.  Systems as in ``substitution_phase``.  Each case also checks
    that NaN planted in every invalid system's L (its diagonal zeroed)
    and B changes no bit of the valid outputs and leaves the invalid ones
    exact zeros, that an all-ones mask gives B3's X bit for bit, and
    times B3 on the same stack.  The library call is solve_triangular on
    the valid systems only (index_select'ed outside the timed region; an
    fp32 copy for a bf16 factor, marked so); the bound counts the valid
    systems' triangles and B, and all of X."""
    from repro_torch.kernels import trsm_block
    main = None
    for m, big, n, k, ldtype, dtype, mask in (
            (16, N, N, PANEL_K, torch.bfloat16, torch.float32, [1] * 8 +
             [0] * 8),
            (16, 1024, 512, PANEL_K, torch.float32, torch.float32,
             [1, 0] * 8),
            (8, 2048, 2048, PANEL_K, torch.float64, torch.float64,
             [0, 1, 1, 0, 1, 0, 0, 1])):
        v = torch.tensor(mask, dtype=torch.int32, device=device)
        live = v.bool()
        L = torch.empty((m, big, big), dtype=ldtype, device=device)
        for z in range(m):            # one system at a time: fp64 scratch
            A = torch.randn((big, big), generator=g, device=device,
                            dtype=torch.float64).tril_() / big ** 0.5
            A.diagonal().copy_(1 + torch.rand(big, generator=g,
                                              device=device,
                                              dtype=torch.float64))
            L[z] = A.to(ldtype)
            del A
        B = torch.randn((m, big, k), generator=g, device=device,
                        dtype=torch.float64).to(dtype)
        Lq, Bq = L[:, big - n:, big - n:], B[:, big - n:]  # views if big > n
        got = trsm_block.trsm_substitution(Lq, Bq, valid=v)
        want = trsm_block.trsm_substitution_plain(Lq, Bq, valid=v)
        abs_err, rel_err = errors(got, want)
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        what = (f"trsm_substitution(valid=) {tuple(Lq.shape)} {ldtype} x {k}"
                f" {dtype}, {int(live.sum())} of {m} valid")
        check(rel_err <= tol, f"{what}: max_rel_err {rel_err} > {tol}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite X")
        check(not got[~live].any(), f"{what}: an invalid system's X is "
                                    f"not zero")
        Lp = Lq.clone()
        Lp[~live] = float("nan")
        Lp.diagonal(dim1=-2, dim2=-1)[~live] = 0
        Bp = torch.where(live[:, None, None], Bq,
                         torch.full_like(Bq, float("nan")))
        poisoned = trsm_block.trsm_substitution(Lp, Bp, valid=v)
        poisoned_equal = torch.equal(poisoned, got)
        check(poisoned_equal, f"{what}: NaN in an invalid system reached X")
        del Lp, Bp, poisoned
        ones = torch.ones_like(v)
        all_ones_equal = torch.equal(
            trsm_block.trsm_substitution(Lq, Bq, valid=ones),
            trsm_block.trsm_substitution(Lq, Bq))
        check(all_ones_equal, f"{what}: an all-ones mask is not B3")
        k_ms = timer.ms(lambda: trsm_block.trsm_substitution(Lq, Bq,
                                                             valid=v), 5)
        b3_ms = timer.ms(lambda: trsm_block.trsm_substitution(Lq, Bq), 5)
        p_ms = timer.ms(lambda: trsm_block.trsm_substitution_plain(
            Lq, Bq, valid=v), 2 if n >= 4096 else 3, warm=0)
        idx = torch.nonzero(live).flatten()
        L_lib = Lq.index_select(0, idx).to(dtype)
        B_lib = Bq.index_select(0, idx)
        lib_ms = timer.ms(lambda: torch.linalg.solve_triangular(
            L_lib, B_lib, upper=False), 5)
        del L_lib, B_lib
        nv = int(live.sum())
        nbytes = nv * (n * (n + 1) // 2 * Lq.element_size()
                       + n * k * Bq.element_size()) \
            + m * n * k * got.element_size()
        b_ms, b_by = bound(nbytes, nv * n * n * k, dtype)
        rec = dict(kernel="trsm_substitution_valid",
                   data="tril(randn) / sqrt(n), diagonal in [1, 2)",
                   shape=[list(Lq.shape), list(Bq.shape)],
                   strided=big > n, mask=mask, valid_systems=nv,
                   dtype=str(dtype).removeprefix("torch."),
                   factor_dtype=str(ldtype).removeprefix("torch."),
                   max_abs_err=abs_err, max_rel_err=rel_err, tol=tol,
                   poisoned_bit_equal=poisoned_equal,
                   all_ones_equal_b3=all_ones_equal,
                   kernel_ms=k_ms, b3_unmasked_ms=b3_ms, plain_ms=p_ms,
                   library_ms=lib_ms if ldtype == dtype else None,
                   library_ms_fp32_factor=None if ldtype == dtype
                   else lib_ms,
                   bound_ms=b_ms, bound_by=b_by,
                   **trsm_block.kernel_info(ldtype, dtype, gated=True))
        print(json.dumps(rec), flush=True)
        if main is None:
            main = rec
        del L, B, Lq, Bq, got, want
    torch.cuda.empty_cache()
    return main


def counters():
    """kernel -> (wrapper, counter attribute): each wrapper adds one to
    its counter where it launches its kernel; B6 and B5 are the gated
    launches of the substitution and inversion wrappers, counted
    apart."""
    from repro_torch.kernels import tri_inv_block, trmm, trsm_block
    return {"tri_inv_blocks": (tri_inv_block.tri_inv_blocks, "launches"),
            "trmm": (trmm.trmm, "launches"),
            "trsm_substitution": (trsm_block.trsm_substitution, "launches"),
            "trmm_masked": (trmm.trmm_masked, "launches"),
            "trsm_substitution_valid": (trsm_block.trsm_substitution,
                                        "valid_launches"),
            "tri_inv_blocks_valid": (tri_inv_block.tri_inv_blocks,
                                     "valid_launches")}


def read_counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def serve(api, L, L64, method, precision, n0, seed, structure=None):
    """One configuration of the slice: admission, warmup, 64 requests.
    With a ``structure`` the residuals are against the masked operator
    (admission enforces the structure).  Returns (solver, launches,
    stats)."""
    from repro_torch.core import session
    from repro_torch.core.structure import apply_block_mask
    device = L.device
    widths = np.random.default_rng(seed).integers(1, PANEL_K + 1, REQUESTS)
    g = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    solver = api.Solver.from_factor(L, api.make_trsm_mesh(1, 1),
                                    method=method, n0=n0,
                                    precision=precision, structure=structure)
    server = api.SolveServer(solver, panel_k=PANEL_K).warmup()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reqs = [torch.randn((N, int(w)), generator=g, device=device)
            for w in widths]
    for b in reqs:
        server.submit(b)
    outs = server.drain()[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counts()
    check(len(outs) == REQUESTS and server.requests_served == REQUESTS,
          f"{precision}: served {server.requests_served} of {REQUESTS}")
    spec = solver.spec_for(PANEL_K)
    if structure is not None:
        L64 = apply_block_mask(L64, structure, spec.n0)
    X = torch.cat(outs, dim=1).double()
    B = torch.cat(reqs, dim=1).double()
    check(bool(torch.isfinite(X).all()), f"{precision}: non-finite X")
    R = L64 @ X - B
    relres = (torch.linalg.norm(R, dim=0).reshape(-1)
              / torch.linalg.norm(B, dim=0).reshape(-1))
    # per request: ||R_j||_F / ||B_j||_F over the request's columns
    worst, off = 0.0, 0
    for w in widths:
        r = torch.linalg.norm(R[:, off:off + w]) \
            / torch.linalg.norm(B[:, off:off + w])
        worst = max(worst, r.item())
        off += int(w)
    bound_ = RELRES_BOUND[precision]
    config = f"{method} {precision} n={N} n0={spec.n0}" + (
        f" {named(structure)}" if structure is not None else "")
    check(worst < bound_, f"{config}: worst request relres {worst} >= "
                          f"{bound_}")
    solves = server.panels_solved + 1                       # + warmup
    per_solve = N // spec.n0 * (solver.policy.refine_steps + 1)
    # B4 forms each refinement residual when the structure leaves out a
    # block at n0; otherwise the program is the dense one
    masked = solver.policy.refine_steps * solves \
        if session.structured_info(structure, N, spec.n0) else 0
    # inv: B1 once at admission, B2 per sweep step; rec: B3 per base case
    want = {"inv": {"tri_inv_blocks": 1, "trmm": per_solve * solves,
                    "trsm_substitution": 0, "trmm_masked": masked,
                    "trsm_substitution_valid": 0,
                    "tri_inv_blocks_valid": 0},
            "rec": {"tri_inv_blocks": 0, "trmm": 0,
                    "trsm_substitution": per_solve * solves,
                    "trmm_masked": masked,
                    "trsm_substitution_valid": 0,
                    "tri_inv_blocks_valid": 0}}[method]
    check(launches == want, f"{config}: launches {launches}, want {want} "
                            f"({per_solve} per solve x {solves} solves)")
    stats = dict(config=config,
                 requests=server.requests_served,
                 columns=int(widths.sum()),
                 panels=server.panels_solved,
                 admit_warmup_s=t1 - t0, serve_s=t2 - t1,
                 ms_per_panel=(t2 - t1) / server.panels_solved * 1e3,
                 worst_relres=worst, relres_bound=bound_,
                 median_column_relres=relres.median().item(),
                 launches=launches, kernel_launches_per_solve=per_solve,
                 build_counts={str(spec.policy.name) + f" k={PANEL_K}":
                               session.BUILD_COUNTS[spec]})
    print(json.dumps(stats), flush=True)
    return solver, launches, stats


def steady_state(api, solver, L64, seed):
    """solve on a placed RHS: no host sync, no build, a cache hit."""
    from repro_torch.core import session
    g = torch.Generator(device=L64.device).manual_seed(seed)
    Bp = solver.place_rhs(torch.randn((N, PANEL_K), generator=g,
                                      device=L64.device))
    spec = solver.spec_for(PANEL_K)
    torch.cuda.synchronize()
    builds, hits = session.BUILD_COUNTS[spec], solver.cache.stats()["hits"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        X = solver.solve(Bp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(session.BUILD_COUNTS[spec] == builds == 1,
          f"steady state built a program ({builds} -> "
          f"{session.BUILD_COUNTS[spec]})")
    check(solver.cache.stats()["hits"] == hits + 1, "no cache hit")
    relres = (torch.linalg.norm(L64 @ X[0].double() - Bp[0].double())
              / torch.linalg.norm(Bp[0].double())).item()
    check(relres < RELRES_BOUND[solver.policy.name],
          f"steady-state relres {relres}")
    print(json.dumps(dict(steady_state="ok", method=solver.method,
                          sync_debug_mode="error", builds=builds,
                          relres=relres)), flush=True)


def other_entry_points(api, L, L64, seed):
    """One-shot trsm with each method on the path's factor, and the plans
    "auto" resolves under the H100 model."""
    from repro_torch.core import tuning
    g = torch.Generator(device=L.device).manual_seed(seed)
    B = torch.randn((N, PANEL_K), generator=g, device=L.device)
    grid = api.make_trsm_mesh(1, 1)
    for method, n0 in (("inv", N // 2), ("inv", None), ("rec", None),
                       ("auto", None)):
        before = read_counts()
        t0 = time.perf_counter()
        X = api.trsm(L, B, grid, method=method, n0=n0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        relres = (torch.linalg.norm(L64 @ X.double() - B.double())
                  / torch.linalg.norm(B.double())).item()
        check(relres < RELRES_BOUND["fp32"],
              f"one-shot trsm {method}: relres {relres}")
        resolved, r_n0 = api.resolve_plan(grid, N, PANEL_K, method=method,
                                          n0=n0)
        launches = {name: n - before[name]
                    for name, n in read_counts().items()}
        # the resolved plan's kernels, and only those: B1 once and B2 per
        # sweep step for "inv", B3 per base case for "rec"
        want = {"inv": {"tri_inv_blocks": 1, "trmm": N // r_n0,
                        "trsm_substitution": 0, "trmm_masked": 0,
                        "trsm_substitution_valid": 0,
                    "tri_inv_blocks_valid": 0},
                "rec": {"tri_inv_blocks": 0, "trmm": 0,
                        "trsm_substitution": N // r_n0,
                        "trmm_masked": 0,
                        "trsm_substitution_valid": 0,
                    "tri_inv_blocks_valid": 0}}[resolved]
        check(launches == want, f"one-shot trsm {method} ({resolved}, "
                                f"n0={r_n0}): launches {launches}, want "
                                f"{want}")
        print(json.dumps(dict(
            one_shot=method, resolved=[resolved, r_n0], relres=relres,
            first_call_s=wall, launches=launches)), flush=True)
    machine = tuning.default_machine()
    solver = api.Solver.from_factor(L, grid, method="auto", k_hint=PANEL_K)
    print(json.dumps(dict(
        machine=machine.__dict__,
        solver_from_factor_auto=dict(method=solver.method, n0=solver.n0,
                                     k_hint=PANEL_K),
        solve_spec_auto=dict(
            (f, getattr(api.SolveSpec.auto(N, PANEL_K, grid=grid), f))
            for f in ("method", "n0")),
        solve_spec_auto_banked=dict(
            (f, getattr(api.SolveSpec.auto(N, PANEL_K, grid=grid,
                                           bank_width=1), f))
            for f in ("method", "n0")))), flush=True)


def profile_calls(run, label: str, calls: int = 10,
                  unit: str = "solve") -> dict:
    """Where the time of ``calls`` calls of ``run`` (each one ``unit``)
    goes: device time by kernel and the device's busy share of the
    host-clock window, from torch.profiler (CUPTI), and the
    ``torch.matmul`` calls per call.  A
    profiler that sees no device time is reported, not failed: it
    measures, it does not check the port.  Returns the printed record."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(us for us, _, _ in rows) / 1e3
    matmuls = sum(e.count for e in prof.key_averages()
                  if e.key == "aten::matmul")
    rec = {"profile": label, f"{unit}s": calls,
           f"wall_ms_per_{unit}": wall * 1e3 / calls,
           f"device_ms_per_{unit}": device_ms / calls,
           "device_busy_share": device_ms / (wall * 1e3) if rows else None,
           f"matmuls_per_{unit}": matmuls / calls,
           "top": [[key[:60], us / 1e3 / calls, count / calls]
                   for us, key, count in rows[:8]]}
    print(json.dumps(rec), flush=True)
    return rec


def profile_window(solver, seed, solves: int = 10):
    """10 steady-state solves of a configuration under the profiler
    (``profile_calls``)."""
    g = torch.Generator(device=solver.grid.device).manual_seed(seed)
    Bp = solver.place_rhs(torch.randn((N, PANEL_K), generator=g,
                                      device=solver.grid.device))
    spec = solver.spec_for(PANEL_K)
    label = (f"{solver.method} {solver.policy.name} n={N} n0={spec.n0} "
             f"k={PANEL_K}" + (f" {named(spec.structure)}"
                               if spec.structure else ""))
    return profile_calls(lambda i: solver.solve(Bp), label, solves)


def structured_phase(api, L, L64, seed):
    """The structured configurations (STRUCTURED_CONFIGS) through
    ``Solver.from_factor(..., structure=)``, served as phase 3 serves the
    dense ones (relres against the masked operator, exact launch
    counts: B4 once per refinement pass).  Then, per configuration: the
    factor with NaN planted in its dropped blocks (and above the block
    diagonal) gives the same X bit for bit; where the mask at n0 keeps
    every block, X equals the dense program's bit for bit; the steady
    state under sync-debug mode "error"; and a profiler window beside
    the dense program at the same n0, with the update GEMMs counted
    (update_cols x passes per "inv" solve).  Returns the launches of
    the first configuration, B4's main path."""
    from repro_torch.core import session, tuning
    from repro_torch.core.structure import analyze, apply_block_mask
    grid = api.make_trsm_mesh(1, 1)
    machine = tuning.default_machine()
    plans = {}
    for text in ("banded:1024", "block-sparse"):
        st = api.FactorStructure.parse(text, n=N)
        n0 = tuning.serving_n0(N, grid, structure=st)
        _, _, times = tuning.choose_serving_method(N, PANEL_K, grid,
                                                   structure=st)
        plans[text] = dict(
            serving_n0=n0, kept_blocks=st.nnz_blocks(N, n0),
            lower_blocks=(N // n0) * (N // n0 + 1) // 2,
            served_auto=list(api.resolve_plan(grid, N, PANEL_K,
                                              method="auto", hoisted=True,
                                              structure=st)),
            modeled_s=times)
    print(json.dumps(dict(h100_structured_plans=plans,
                          machine=machine.__dict__)), flush=True)
    dense = {}                    # (method, n0) -> dense solver
    main_launches = None
    for i, (method, text, n0) in enumerate(STRUCTURED_CONFIGS):
        st = api.FactorStructure.parse(text, n=N)
        solver, launches, stats = serve(api, L, L64, method, "bf16_refine",
                                        n0, seed=60 + i, structure=st)
        if main_launches is None:
            main_launches = launches
        spec = solver.spec_for(PANEL_K)
        n0 = spec.n0
        info = analyze(st, N, n0)
        full = session.structured_info(st, N, n0) is None
        spans = [list(sp) if sp else None for sp in info.spans]
        # columns whose span holds blocks the mask leaves out
        holes = [j for j, sp in enumerate(info.spans) if sp and not all(
            info.mask[r][j] for r in range(*sp))]
        if text == "block-sparse":
            check(0 in holes, f"{text}: column 0's span {spans[0]} has no "
                              f"left-out block inside it")
        g = torch.Generator(device=L.device).manual_seed(70 + i)
        Bp = solver.place_rhs(torch.randn((N, PANEL_K), generator=g,
                                          device=L.device))
        X = solver.solve(Bp)
        key = (method, n0)
        if key not in dense:
            dense[key] = api.Solver.from_factor(
                L, grid, method=method, n0=n0, precision="bf16_refine")
        if full:
            check(torch.equal(dense[key].solve(Bp), X),
                  f"{text} at n0={n0} keeps every block but differs from "
                  f"the dense program")
            poisoned_equal = None              # no block is dropped
        else:
            elem = torch.as_tensor(info.mask_array(), device=L.device) \
                .repeat_interleave(n0, 0).repeat_interleave(n0, 1)
            Lp = torch.where(elem, L, torch.full_like(L, float("nan")))
            Xp = api.Solver.from_factor(Lp, grid, method=method, n0=n0,
                                        precision="bf16_refine",
                                        structure=st).solve(Bp)
            del Lp
            poisoned_equal = torch.equal(Xp, X)
            check(poisoned_equal, f"{text} n0={n0}: NaN in a dropped block "
                                  f"changed X")
        steady_state(api, solver, apply_block_mask(L64, st, n0),
                     seed=80 + i)
        prof = profile_window(solver, seed=90 + i)
        dprof = profile_window(dense[key], seed=90 + i)
        passes = solver.policy.refine_steps + 1
        if method == "inv" and not full:
            want = info.update_cols * passes
            check(prof["matmuls_per_solve"] == want,
                  f"{text} n0={n0}: {prof['matmuls_per_solve']} update "
                  f"GEMMs per solve, want {want}")
        print(json.dumps(dict(
            structured=stats["config"], full_mask=full,
            kept_blocks=int(info.mask_array().sum()),
            lower_blocks=info.m * (info.m + 1) // 2,
            update_cols=info.update_cols, spans=spans,
            spans_with_left_out_blocks=holes,
            poisoned_bit_equal=poisoned_equal,
            ms_per_panel=stats["ms_per_panel"],
            worst_relres=stats["worst_relres"],
            device_ms_per_solve=prof["device_ms_per_solve"],
            dense_device_ms_per_solve=dprof["device_ms_per_solve"],
            update_gemms_per_solve=prof["matmuls_per_solve"],
            dense_matmuls_per_solve=dprof["matmuls_per_solve"])),
            flush=True)
        del solver
    return main_launches


def factor_maker(device, seed):
    """fresh(n) -> a new L = tril(randn) + n I (fp32) on ``device``, from
    one seeded generator; also returns the generator."""
    g = torch.Generator(device=device).manual_seed(seed)

    def fresh(n=N):
        L = torch.randn((n, n), generator=g, device=device).tril_()
        L.diagonal().add_(n)
        return L

    return fresh, g


def request_relres(L, xs, bs) -> list:
    """||L X_j - B_j|| / ||B_j|| per request, in fp64 on the card."""
    X = torch.cat(xs, dim=1).double()
    B = torch.cat(bs, dim=1).double()
    R = L.double() @ X - B
    out, off = [], 0
    for b in bs:
        w = b.shape[1]
        out.append((torch.linalg.norm(R[:, off:off + w])
                    / torch.linalg.norm(B[:, off:off + w])).item())
        off += w
    return out


def churn_phase(api, method, seed):
    """A capacity bank of C = 16 slots of order n = 8192, bf16_refine,
    live-mutated while it serves (CHURN_*): built through
    ``Solver.from_spec(SolveSpec.auto(..., bank_width=16), capacity=16)``
    and warmed up EMPTY (every lane of the warmup, and of a solve of
    random panels on the empty bank, exactly zero: a "rec" bank gates
    its empty lanes off on B6); 8 admissions (half occupancy); the
    schedule of the reference CLI's ``serve_trsm_churn`` (256 requests of
    widths 1..16, an in-place replace after every 8, every third update
    an evict and a re-admit that must reuse the victim's slot); one
    ``replace_run`` of 4 contiguous slots in one updater call; a padded
    admission (``pad_to=8192`` of an order-4096 factor) whose leading
    block must equal, bit for bit, an unpadded order-4096 bank's solve
    at the same n0 and bank width.  After every wave each request's
    relres against its slot's factor at the time is held to 1e-5, every
    dead lane of the wave is exactly zero; the wave before and after the
    replace with a ``place_factor``'d factor, and the replace itself, run
    under sync-debug mode "error"; no program or updater is built from
    the first wave to the last; the launches are exact (rec: B6 per base
    case, never B3; inv: B1 per updater call but the padded admission's,
    which is B5's, B2 per sweep step, no B6).
    Then 10 steady waves under the profiler.  Returns (launches,
    stats)."""
    from repro_torch.core import session
    grid = api.make_trsm_mesh(1, 1)
    C = CHURN_CAPACITY
    fresh, g = factor_maker(grid.device, seed)
    rng = np.random.default_rng(seed)
    what = f"churn {method} bf16_refine n={N} C={C}"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    spec = api.SolveSpec.auto(N, PANEL_K, grid=grid, method=method,
                              precision="bf16_refine", bank_width=C)
    solver = api.Solver.from_spec(spec, capacity=C)
    bank = solver.bank
    waves = []                     # every X the solver returns, in order
    solve = solver.solve

    def capture(B, **kw):
        X = solve(B, **kw)
        waves.append(X)
        return X

    solver.solve = capture
    server = api.SolveServer(solver, PANEL_K).warmup()        # EMPTY
    torch.cuda.synchronize()
    empty_warmup_s = time.perf_counter() - t0
    solver.solve(torch.randn((C, N, PANEL_K), generator=g,
                             device=grid.device))
    for X in waves:
        check(bool(torch.isfinite(X).all()) and not X.any(),
              f"{what}: the empty bank's lanes are not exact zeros")
    empty = read_counts()
    want_empty = {"rec": empty["trsm_substitution_valid"] > 0
                  and empty["trsm_substitution"] == 0,
                  "inv": empty["trmm"] > 0 and empty["tri_inv_blocks"] == 0}
    check(want_empty[method], f"{what}: empty-bank launches {empty}")
    current = {}                   # slot -> its resident factor (fp32)
    admit_ms = []
    for _ in range(C // 2):
        L = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        slot = solver.admit_factor(L)
        torch.cuda.synchronize()
        admit_ms.append((time.perf_counter() - t) * 1e3)
        current[slot] = L
    check(bank.live_slots() == tuple(range(C // 2)),
          f"{what}: admissions filled {bank.live_slots()}")
    key, uspec = solver.spec_for(PANEL_K), bank.update_spec()
    builds0 = (session.BUILD_COUNTS[key], session.BUILD_COUNTS[uspec])
    host = torch.Generator().manual_seed(seed + 1)   # made on the host,
    Lh = torch.randn((N, N), generator=host).tril_()  # placed ahead
    Lh.diagonal().add_(N)
    placed = bank.place_factor(Lh)
    del Lh

    checks = dict(requests=0, worst=0.0, dead_lanes=0, waves=0)
    pending = []

    def settle():
        """Check every recorded wave: relres per request against the
        slot's factor at the time, dead lanes exactly zero."""
        while pending:
            outs, reqs, factors, xs, live = pending.pop(0)
            check(set(outs) == set(live), f"{what}: drained slots "
                                          f"{sorted(outs)} != live {live}")
            for X in xs:
                checks["waves"] += 1
                for s_ in range(C):
                    if s_ not in live:
                        check(not X[s_].any(), f"{what}: dead lane {s_} "
                                               f"is not zero")
                        checks["dead_lanes"] += 1
            by_slot = {}
            for slot, b in reqs:
                by_slot.setdefault(slot, []).append(b)
            for slot, bs in by_slot.items():
                check(len(outs[slot]) == len(bs), f"{what}: slot {slot} "
                                                  f"lost a request")
                for r in request_relres(factors[slot], outs[slot], bs):
                    check(r <= CHURN_RELRES, f"{what}: slot {slot} relres "
                                             f"{r} > {CHURN_RELRES}")
                    checks["worst"] = max(checks["worst"], r)
                    checks["requests"] += 1

    def wave(reqs, guarded=False):
        n_before = len(waves)
        t = time.perf_counter()
        for slot, b in reqs:
            server.submit(b, slot)
        outs = server.drain()
        ms = None
        if not guarded:
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        pending.append((outs, reqs, dict(current), waves[n_before:],
                        bank.live_slots()))
        return ms

    widths = rng.integers(1, PANEL_K + 1, CHURN_REQUESTS)
    per_wave = CHURN_REQUESTS // CHURN_UPDATES
    replaced = evicted = 0
    wave_ms, replace_ms, readmit_ms = [], [], []
    guard_s = None
    reqs = []
    for i, w in enumerate(widths):
        live = bank.live_slots()
        reqs.append((int(live[i % len(live)]),
                     torch.randn((N, int(w)), generator=g,
                                 device=grid.device)))
        if (i + 1) % per_wave:
            continue
        index = (i + 1) // per_wave - 1
        guarded = index in (SYNC_GUARD_WAVE, SYNC_GUARD_WAVE + 1)
        live = bank.live_slots()
        target = int(live[replaced % len(live)])
        if index == SYNC_GUARD_WAVE:
            torch.cuda.synchronize()
            tg = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ms = wave(reqs, guarded)
            if index == SYNC_GUARD_WAVE:
                solver.replace_factor(target, placed)
        except BaseException:
            torch.cuda.set_sync_debug_mode(0)
            raise
        if index != SYNC_GUARD_WAVE:
            torch.cuda.set_sync_debug_mode(0)
        reqs = []
        if ms is not None:
            wave_ms.append(ms)
        if index == SYNC_GUARD_WAVE + 1:
            torch.cuda.synchronize()
            guard_s = time.perf_counter() - tg
        if index == SYNC_GUARD_WAVE:
            current[target] = placed
            replaced += 1
            check(replaced % 3 != 0, f"{what}: the guarded update is an "
                                     f"evict")
            continue
        L = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        solver.replace_factor(target, L)
        torch.cuda.synchronize()
        replace_ms.append((time.perf_counter() - t) * 1e3)
        current[target] = L
        replaced += 1
        if replaced % 3 == 0:
            victim = int(live[evicted % len(live)])
            L = fresh()
            torch.cuda.synchronize()
            t = time.perf_counter()
            solver.evict_factor(victim)
            slot = solver.admit_factor(L)
            torch.cuda.synchronize()
            readmit_ms.append((time.perf_counter() - t) * 1e3)
            check(slot == victim, f"{what}: re-admitted into {slot}, not "
                                  f"the victim's slot {victim}")
            current[slot] = L
            evicted += 1
        settle()
    check(not server.pending() and server.requests_served
          == CHURN_REQUESTS, f"{what}: served {server.requests_served}")
    builds = (session.BUILD_COUNTS[key], session.BUILD_COUNTS[uspec])
    check(builds == builds0, f"{what}: BUILD_COUNTS moved during the churn "
                             f"{builds0} -> {builds}")

    # one replace_run of 4 contiguous live slots, one updater call
    first = 0
    check(all(bank.is_live(s_) for s_ in range(first, first + 4)),
          f"{what}: slots 0..3 are not all live")
    Ls = torch.stack([fresh() for _ in range(4)])
    calls = bank.updates_dispatched
    torch.cuda.synchronize()
    t = time.perf_counter()
    bank.replace_run(first, Ls)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t) * 1e3
    check(bank.updates_dispatched == calls + 1,
          f"{what}: replace_run took {bank.updates_dispatched - calls} "
          f"updater calls")
    for j in range(4):
        current[first + j] = Ls[j]
    del Ls
    wave([(s_, torch.randn((N, PANEL_K), generator=g, device=grid.device))
          for s_ in bank.live_slots()])
    settle()

    # padded admission: an order-4096 factor into the order-8192 bank
    d = N // 2
    T = fresh(d)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pslot = bank.admit(T, pad_to=N)
    torch.cuda.synchronize()
    pad_ms = (time.perf_counter() - t) * 1e3
    padded = torch.zeros((N, N), device=grid.device)
    padded[:d, :d] = T
    padded.diagonal()[d:] = 1
    current[pslot] = padded
    bp = torch.zeros((N, PANEL_K), device=grid.device)
    bp[:d] = torch.randn((d, PANEL_K), generator=g, device=grid.device)
    n_before = len(waves)
    reqs = [(s_, bp if s_ == pslot else torch.randn(
        (N, PANEL_K), generator=g, device=grid.device))
        for s_ in bank.live_slots()]
    wave(reqs)
    Xp = waves[n_before][pslot]
    settle()
    launches = read_counts()
    solves = len(waves)
    passes = solver.policy.refine_steps + 1
    per_solve = N // key.n0 * passes
    want = {"rec": {"tri_inv_blocks": 0, "trmm": 0, "trsm_substitution": 0,
                    "trmm_masked": 0,
                    "trsm_substitution_valid": per_solve * solves,
                    "tri_inv_blocks_valid": 0},
            "inv": {"tri_inv_blocks": bank.updates_dispatched - 1,
                    "trmm": per_solve * solves, "trsm_substitution": 0,
                    "trmm_masked": 0, "trsm_substitution_valid": 0,
                    "tri_inv_blocks_valid": 1}}[method]
    check(launches == want, f"{what}: launches {launches}, want {want} "
                            f"({per_solve} per solve x {solves} solves)")
    check(not Xp[d:].any(), f"{what}: the padded tail is not zero")
    small = api.Solver.from_spec(api.SolveSpec.auto(
        d, PANEL_K, grid=grid, method=method, precision="bf16_refine",
        n0=key.n0 if method == "inv" else None, bank_width=C), capacity=C)
    small.admit_factor(T)
    Bs = torch.zeros((C, d, PANEL_K), device=grid.device)
    Bs[0] = bp[:d]
    Xs = small.solve(Bs)[0]
    padded_equal = torch.equal(Xp[:d], Xs)
    check(padded_equal, f"{what}: the padded leading block differs from the "
                        f"unpadded order-{d} solve at n0 = "
                        f"{small.spec_for(PANEL_K).n0}")
    one = api.Solver.from_factor(T, grid, method=method,
                                 n0=small.spec_for(PANEL_K).n0,
                                 precision="bf16_refine")
    width1_equal = torch.equal(Xp[:d], one.solve(bp[:d]))
    del small, one, Bs, Xs, padded, T

    # 10 steady waves under the profiler: one 16-column panel per slot
    live = bank.live_slots()
    panels = [[(s_, torch.randn((N, PANEL_K), generator=g,
                                device=grid.device)) for s_ in live]
              for _ in range(12)]

    def run(i):
        for slot, b in panels[i]:
            server.submit(b, slot)
        server.drain()

    prof = profile_calls(run, f"{what} n0={key.n0} occupancy {len(live)}",
                         10, unit="wave")
    stats = dict(
        churn=what, n0=key.n0, capacity=C, occupancy=bank.size,
        requests_served=server.requests_served, waves=checks["waves"],
        checked_requests=checks["requests"],
        dead_lanes_checked=checks["dead_lanes"],
        worst_relres=checks["worst"], relres_bound=CHURN_RELRES,
        empty_warmup_s=empty_warmup_s, admit_ms=admit_ms,
        ms_per_wave_median=float(np.median(wave_ms)),
        ms_per_wave_mean=float(np.mean(wave_ms)),
        replace_ms_median=float(np.median(replace_ms)),
        evict_readmit_ms_median=float(np.median(readmit_ms)),
        replace_run_4_ms=run_ms, padded_admit_ms=pad_ms,
        replaces=replaced, evict_readmits=evicted,
        updater_calls=bank.updates_dispatched,
        sync_guarded_window_s=guard_s, builds=dict(
            solve=builds[0], update=builds[1]),
        padded_bit_equal=padded_equal,
        padded_width1_bit_equal=width1_equal,
        launches=launches,
        device_ms_per_wave=prof["device_ms_per_wave"],
        device_busy_share=prof["device_busy_share"])
    print(json.dumps(stats), flush=True)
    del solver.solve
    return launches, stats


def fleet_phase(api, seed):
    """The mixed-order fleet (FLEET_*): the reference CLI's trsm-fleet
    configuration at n = 8192 — two tenants, orders [n, n/2, n/4] with
    2 factors per order each (manifest {8192: 4, 4096: 4, 2048: 4}),
    bf16_refine, panel_k = 16 — planned by ``api.plan_fleet`` under the
    H100 preset and served through ``api.SolverFleet`` and a fleet-mode
    ``api.SolveServer``.  Warmed up empty, 12 admissions (the order-4096
    ones padded into the 8192 bucket, phase 1 on B5), then the CLI's
    schedule: 192 requests of widths 1..16 in 24 waves, after each wave
    an in-place ``replace``, every third update a tenant-c burst admit
    that cycles through the orders and reclaims the coldest slot across
    tenants; one replace with a ``place_factor``'d factor and the waves
    around it under sync-debug mode "error".  Then 10 steady waves under
    the profiler, one ``apply_plan`` onto the plan for the live manifest
    at dispatch_s = 1e-4 (2048 merges too: the 8192 bucket is rebuilt at
    capacity 12 and every resident re-admitted, the smaller orders
    padded on B5), and 4 more waves.  Checks: every request's relres in
    fp64 against the factor its handle held when served <= 1e-5; every
    padded lane's tail exactly zero; a stale handle refused; no program
    or updater built from the first wave to the last but the rebuilt
    bucket's (built inside the migration and its warmup); a padded
    slot's Dt equal to B1 on its padded stack; B5 launched once per
    padded phase-1 run and B1 once per unpadded one; B2 six times per
    bucket solve; no other kernel.  Returns (launches, stats)."""
    from repro_torch.core import inv_trsm, session
    from repro_torch.kernels import tri_inv_block, trmm
    grid = api.make_trsm_mesh(1, 1)
    dev = grid.device
    orders = [N, N // 2, N // 4]
    fresh, g = factor_maker(dev, seed)
    rng = np.random.default_rng(seed)
    what = f"fleet bf16_refine n={N}"
    plan = api.plan_fleet({d: FLEET_PER_ORDER for d in orders}, grid,
                          k=PANEL_K, precision="bf16_refine")
    got_plan = [[b.n, list(b.orders), b.capacity, b.method, b.n0]
                for b in plan.buckets]
    print(plan.table(), flush=True)
    print(json.dumps(dict(fleet_plan=got_plan, dispatch_s=plan.dispatch_s,
                          as_expected=got_plan == FLEET_EXPECTED_PLAN)),
          flush=True)
    torch.cuda.synchronize()
    reset_counts()
    gemm0 = trmm.gemm.launches
    phase1 = {"padded": 0, "unpadded": 0}
    waves = []                # (bucket n, X, {slot: order}) per solve
    solves = [0]

    def watch(key, solver):
        """Record every solve of a bucket's solver: its X and which
        order each live slot holds."""
        solve = solver.solve

        def capture(B, **kw):
            X = solve(B, **kw)
            b = fleet.bucket(key)
            waves.append((key[0], X, {h.slot: h.order
                                      for h in b.handles.values()}))
            solves[0] += 1
            return X

        solver.solve = capture

    fleet = api.SolverFleet(grid, plan)
    for key in fleet.buckets:
        watch(key, fleet.solver(key))
    t0 = time.perf_counter()
    server = api.SolveServer(fleet, PANEL_K).warmup()          # EMPTY
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def kind(h):
        return "padded" if h.order < h.bucket[0] else "unpadded"

    handles, current = {}, {}           # (tenant, tag) -> handle, factor
    admit_ms = {"padded": [], "unpadded": []}
    for tenant in ("tenant-a", "tenant-b"):
        for d in orders:
            for j in range(FLEET_PER_ORDER // 2):
                tag = f"layer{orders.index(d)}-{j}"
                L = fresh(d)
                h, ms = timed(lambda: fleet.admit(L, tenant=tenant, tag=tag))
                handles[(tenant, tag)] = h
                current[(tenant, tag)] = L
                admit_ms[kind(h)].append(ms)
                phase1[kind(h)] += 1
    check(sorted(fleet.manifest().items())
          == sorted((d, FLEET_PER_ORDER) for d in orders),
          f"{what}: manifest {fleet.manifest()}")

    checks = dict(requests=0, worst=0.0, padded_tails=0, waves=0)
    pending = []

    def settle():
        """relres per request against the factor its handle held when
        served; every padded lane's tail rows exactly zero."""
        while pending:
            outs, reqs, first = pending.pop(0)
            for n_b, X, slots in waves[first:]:
                checks["waves"] += 1
                for slot, d in slots.items():
                    if d < n_b:
                        check(not X[slot, d:].any(), f"{what}: bucket "
                              f"{n_b} slot {slot} (order {d}) has a "
                              f"nonzero padded tail")
                        checks["padded_tails"] += 1
            by_key = {}
            for key, b, L in reqs:
                by_key.setdefault(key, ([], L))[0].append(b)
            for key, (bs, L) in by_key.items():
                xs = outs.get(key, [])
                check(len(xs) == len(bs), f"{what}: {key} got {len(xs)} "
                                          f"of {len(bs)} solutions")
                for x, b in zip(xs, bs):
                    check(tuple(x.shape) == tuple(b.shape),
                          f"{what}: {key} solution {tuple(x.shape)}")
                for r in request_relres(L, xs, bs):
                    check(r <= FLEET_RELRES, f"{what}: {key} relres {r} > "
                                             f"{FLEET_RELRES}")
                    checks["worst"] = max(checks["worst"], r)
                    checks["requests"] += 1

    def wave(reqs, timed_wave=True):
        first = len(waves)
        torch.cuda.synchronize() if timed_wave else None
        t = time.perf_counter()
        for key, b, _ in reqs:
            server.submit(b, tenant=key[0], tag=key[1])
        outs = server.drain()
        ms = None
        if timed_wave:
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        pending.append((outs, reqs, first))
        return ms

    builds0 = sum(session.BUILD_COUNTS.values())
    widths = rng.integers(1, PANEL_K + 1, FLEET_REQUESTS)
    per_wave = FLEET_REQUESTS // FLEET_WAVES
    keys = list(handles)
    replaced = reclaimed = 0
    wave_ms, replace_ms = [], {"padded": [], "unpadded": []}
    burst_ms = {"padded": [], "unpadded": []}
    guard = None              # the guarded wave's index, once chosen
    stale_refused = False
    reqs = []
    for i, w in enumerate(widths):
        key = keys[i % len(keys)]
        h = handles[key]
        reqs.append((key, torch.randn((h.order, int(w)), generator=g,
                                      device=dev), current[key]))
        if (i + 1) % per_wave:
            continue
        index = (i + 1) // per_wave - 1
        tkey = keys[replaced % len(keys)]
        target = handles[tkey]
        if guard is None and index >= SYNC_GUARD_WAVE \
                and kind(target) == "padded" and (replaced + 1) % 3:
            guard = index
            host = torch.Generator().manual_seed(seed + 1)
            Lh = torch.randn((target.order, target.order),
                             generator=host).tril_()
            Lh.diagonal().add_(target.order)
            placed = fleet.place_factor(Lh)
            del Lh
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ms = wave(reqs, timed_wave=guard is None or index > guard + 1)
            if index == guard:
                fleet.replace(target, placed)
            if guard is not None and index == guard + 1:
                torch.cuda.set_sync_debug_mode(0)
        except BaseException:
            torch.cuda.set_sync_debug_mode(0)
            raise
        reqs = []
        if ms is not None:
            wave_ms.append(ms)
        if index == guard:
            current[tkey] = placed
        else:
            L = fresh(target.order)
            _, ms = timed(lambda: fleet.replace(target, L))
            replace_ms[kind(target)].append(ms)
            current[tkey] = L
        phase1[kind(target)] += 1
        replaced += 1
        if replaced % 3 == 0:
            check(index != guard, f"{what}: the guarded update is a burst")
            d = orders[reclaimed % len(orders)]
            L = fresh(d)
            before = set(map(id, fleet.handles()))
            hot, ms = timed(lambda: fleet.admit(
                L, tenant="tenant-c", tag=f"burst{reclaimed}"))
            burst_ms[kind(hot)].append(ms)
            phase1[kind(hot)] += 1
            reclaimed += 1
            live = set(map(id, fleet.handles()))
            victims = [(kt, hh) for kt, hh in handles.items()
                       if id(hh) in before and id(hh) not in live]
            check(len(victims) == 1, f"{what}: burst {reclaimed} reclaimed "
                                     f"{len(victims)} slots")
            vkey, victim = victims[0]
            if not stale_refused:
                try:
                    fleet.replace(victim, current[vkey])
                except KeyError as e:
                    stale_refused = "stale handle" in str(e)
                check(stale_refused, f"{what}: a stale handle was served")
            del handles[vkey]
            handles[("tenant-c", hot.tag)] = hot
            current[("tenant-c", hot.tag)] = L
            keys = list(handles)
        if index != guard:            # settling reads values back
            settle()
    check(guard is not None, f"{what}: no wave was guarded")
    check(not server.pending() and server.requests_served == FLEET_REQUESTS,
          f"{what}: served {server.requests_served}")
    builds = sum(session.BUILD_COUNTS.values())
    check(builds == builds0, f"{what}: {builds - builds0} program(s) built "
                             f"during the waves")
    stats_table = fleet.format_stats()
    print(stats_table, flush=True)

    # 10 steady waves under the profiler: one 16-column request per
    # live handle, both buckets drained per wave
    panels = [[(key, torch.randn((h.order, PANEL_K), generator=g,
                                 device=dev)) for key, h in handles.items()]
              for _ in range(12)]

    def run(i):
        for key, b in panels[i]:
            server.submit(b, tenant=key[0], tag=key[1])
        server.drain()

    n_before = len(waves)
    prof = profile_calls(run, f"{what} {len(fleet.buckets)} buckets", 10,
                         unit="wave")
    del panels
    # host time of one bucket-wave dispatch: a bucket solve's enqueue
    dispatch_ms = {}
    for key in fleet.buckets:
        solver = fleet.solver(key)
        Bp = solver.place_rhs(torch.zeros((solver.width, key[0], PANEL_K),
                                          device=dev))
        torch.cuda.synchronize()
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            solver.solve(Bp)
            ts.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        dispatch_ms[key[0]] = float(np.median(ts))
    del waves[n_before:]

    # live migration onto the plan for the live manifest at 1e-4
    new_plan = api.plan_fleet(fleet.manifest(), grid, k=PANEL_K,
                              precision="bf16_refine",
                              dispatch_s=FLEET_MIGRATE_DISPATCH_S)
    print(new_plan.table(), flush=True)
    moved_to = {}
    res, migrate_ms = timed(lambda: fleet.apply_plan(
        new_plan, on_move=lambda o, n: moved_to.__setitem__(id(o), n)))
    for key, h in list(handles.items()):
        if id(h) in moved_to:
            handles[key] = moved_to[id(h)]
            phase1[kind(handles[key])] += 1
    check(len(fleet.buckets) == 1 and fleet.buckets[0][0] == N
          and [k[0] for k in res["rebuilt"]] == [N]
          and [k[0] for k in res["closed"]] == [N // 4]
          and len(res["moved"]) == 2 * len(orders) * FLEET_PER_ORDER // 2,
          f"{what}: migration {dict((k, len(v)) for k, v in res.items())} "
          f"onto {new_plan.table()}")
    check(fleet.plan.buckets[0].capacity == 3 * FLEET_PER_ORDER,
          f"{what}: merged capacity {fleet.plan.buckets[0].capacity}")
    watch(fleet.buckets[0], fleet.solver(fleet.buckets[0]))
    b_mig = sum(session.BUILD_COUNTS.values())
    _, mig_warmup_ms = timed(lambda: fleet.warmup(PANEL_K))
    built_in_migration = sum(session.BUILD_COUNTS.values()) - builds
    for _ in range(FLEET_AFTER_WAVES):
        reqs = []
        for j in range(per_wave):
            key = keys[j % len(keys)]
            h = handles[key]
            w = int(rng.integers(1, PANEL_K + 1))
            reqs.append((key, torch.randn((h.order, w), generator=g,
                                          device=dev), current[key]))
        wave_ms.append(wave(reqs))
        settle()
    # the rebuilt bucket's updaters (one per order) and its program
    check(built_in_migration == len(orders) + 1,
          f"{what}: {built_in_migration} builds in the migration")
    check(sum(session.BUILD_COUNTS.values()) == b_mig + 1,
          f"{what}: a program was built after the migration's warmup")
    launches = read_counts()
    want = {"tri_inv_blocks": phase1["unpadded"],
            "tri_inv_blocks_valid": phase1["padded"],
            "trmm": N // (N // 2) * 3 * solves[0],
            "trsm_substitution": 0, "trmm_masked": 0,
            "trsm_substitution_valid": 0}
    check(launches == want, f"{what}: launches {launches}, want {want}")
    check(trmm.gemm.launches == gemm0, f"{what}: a bucket of width >= "
                                       f"{2} took the ordered products")

    # a padded slot's Dt against B1 on its padded stack: one order-4096
    # and one order-2048 slot of the merged bucket
    b = fleet.bucket(fleet.buckets[0])
    L_lo, Dt = b.bank.stacks()[:2]
    dt_equal = {}
    for d in orders[1:]:
        slot = next(h.slot for h in b.handles.values() if h.order == d)
        want_dt = inv_trsm.invert_diag_blocks(
            L_lo[slot:slot + 1], n0=b.bank.n0,
            block_inv=tri_inv_block.tri_inv_blocks,
            accum_dtype=torch.float32)
        dt_equal[d] = torch.equal(Dt[slot:slot + 1], want_dt)
        check(dt_equal[d], f"{what}: the padded order-{d} slot's Dt is not "
                           f"B1's on its padded stack")
    stats = dict(
        fleet=what, plan=got_plan, plan_as_expected=got_plan
        == FLEET_EXPECTED_PLAN, requests_served=server.requests_served,
        checked_requests=checks["requests"], waves=checks["waves"],
        padded_tails_checked=checks["padded_tails"],
        worst_relres=checks["worst"], relres_bound=FLEET_RELRES,
        empty_warmup_s=warmup_s,
        admit_ms_padded=admit_ms["padded"],
        admit_ms_unpadded=admit_ms["unpadded"],
        ms_per_fleet_wave_median=float(np.median(wave_ms)),
        ms_per_fleet_wave_mean=float(np.mean(wave_ms)),
        replace_ms_padded_median=float(np.median(replace_ms["padded"])),
        replace_ms_unpadded_median=float(np.median(replace_ms["unpadded"])),
        burst_admit_ms=burst_ms, replaces=replaced, reclaims=fleet.reclaims,
        stale_handle_refused=stale_refused, sync_guarded_wave=guard,
        migration_ms=migrate_ms, migration_warmup_ms=mig_warmup_ms,
        moved=len(res["moved"]), built_in_migration=built_in_migration,
        phase1_runs=phase1, padded_dt_equal_b1=dt_equal,
        host_dispatch_ms_per_bucket_wave=dispatch_ms,
        nominal_dispatch_ms=plan.dispatch_s * 1e3, launches=launches,
        device_ms_per_wave=prof["device_ms_per_wave"],
        device_busy_share=prof["device_busy_share"])
    print(json.dumps(stats), flush=True)
    return launches, stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no {SRC}/repro_torch; run it from a checkout "
              f"of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch import api
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()                                        # phase 1
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(json.dumps(dict(build_s=time.perf_counter() - t0,
                          libraries=sorted(p.name for p in libs.values()))),
          flush=True)
    device = api.make_trsm_mesh(1, 1).device
    g = torch.Generator(device=device).manual_seed(0)
    L = torch.randn((N, N), generator=g, device=device).tril_()
    L.diagonal().add_(N)
    L64 = L.double()

    records = kernel_phase(device, Timer(device))             # phase 2

    solvers, main_launches = [], {}
    for method, configs in (("inv", INV_CONFIGS), ("rec", REC_CONFIGS)):
        for i, (precision, n0) in enumerate(configs):        # phase 3
            solver, launches, _ = serve(api, L, L64, method, precision,
                                        n0, seed=10 + len(solvers))
            solvers.append(solver)
            if i == 0:                         # the method's main path
                main_launches[method] = launches
                steady_state(api, solver, L64,
                             seed=30 + len(solvers))         # phase 4
    check(solvers[0].n0 == N // 2, f"default inv n0 {solvers[0].n0}")
    check(solvers[len(INV_CONFIGS)].spec_for(PANEL_K).n0 == N,
          "default rec n0 is not n")

    other_entry_points(api, L, L64, seed=40)                  # phase 5
    for i, solver in enumerate(solvers):                      # phase 6
        profile_window(solver, seed=50 + i)
    main_launches["structured"] = structured_phase(api, L, L64,  # phase 7
                                                   seed=60)
    del L, L64, solvers
    gc.collect()
    torch.cuda.empty_cache()
    for i, method in enumerate(("inv", "rec")):               # phase 8
        main_launches[f"churn {method}"], _ = churn_phase(api, method,
                                                          seed=100 + i)
        gc.collect()                  # the bank goes before the next one
        torch.cuda.empty_cache()
    main_launches["fleet"], _ = fleet_phase(api, seed=120)    # phase 9
    gc.collect()
    torch.cuda.empty_cache()

    kernels = []
    for name, method, source, replaces in (
            ("tri_inv_blocks", "inv", "src/repro_torch/kernels/csrc/"
             "tri_inv_levels.cu", "src/repro/kernels/tri_inv_block.py:63"),
            ("trmm", "inv", "src/repro_torch/kernels/csrc/trmm_tri.cu",
             "src/repro/kernels/trmm.py:32"),
            ("trsm_substitution", "rec",
             "src/repro_torch/kernels/csrc/trsm_chain.cu",
             "src/repro/kernels/trsm_block.py:26"),
            ("trmm_masked", "structured",
             "src/repro_torch/kernels/csrc/trmm_tri.cu",
             "src/repro/kernels/trmm.py:50"),
            ("trsm_substitution_valid", "churn rec",
             "src/repro_torch/kernels/csrc/trsm_chain.cu",
             "src/repro/kernels/trsm_block.py:44"),
            ("tri_inv_blocks_valid", "fleet",
             "src/repro_torch/kernels/csrc/tri_inv_levels.cu",
             "src/repro/kernels/tri_inv_block.py:67")):
        rec = records[name]
        launches = main_launches[method][name]
        check(launches > 0, f"{name} never launched on the {method} main "
                            f"path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=rec["max_abs_err"],
                            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
                            bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"],
                            library_ms=rec["library_ms"]))
    print(json.dumps(dict(elapsed_s=time.perf_counter() - t_start)))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
