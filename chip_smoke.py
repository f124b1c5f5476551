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
10. The open-loop tier (``traffic_phase``): the reference CLI's
   trsm-traffic configuration at n = 8192 (4 factors, inv at n0 = 4096,
   bf16_refine, panel_k = 16, requests of 4 columns, queue depth 128,
   SLO 50 ms) through ``api.AsyncSolveServer`` and its background
   drain loop, after priming every wave composition: the closed-loop
   capacity (s per full wave), the saturation sweep of
   benchmarks/bench_serve_latency.py (2 s a point) and its 5 s run at
   0.8x saturation (>= 95% goodput), 512 requests at 2x saturation with depth-only and with SLO
   admission (``api.AdmissionController``), the steady state (submit
   and ``step()`` by hand under sync-debug mode "error", and whether the
   event wait itself trips it), and ``--autoscale`` (orders {8192: 2,
   4096: 2} under the H100 preset, ``api.Autoscaler`` attached, 2x
   saturation; the plans and every replan).  One JSON line per run:
   offered rate, goodput, p50/p99/max latency against the SLO,
   violations, depth and deadline sheds, stranded, waves, device ms per
   wave and busy share (a torch.profiler window over the run).  Every
   served request's relres <= 1e-5 in fp64 against its factor, padded
   tails zero, every future done in 120 s, submitted = served +
   stranded, no build after priming but an opened or rebuilt bucket's,
   trmm = 6 x waves in the plain runs, phase 1 once per moved factor.
11. The factor producers and K-FAC (``producers_phase``,
   ``kfac_phase``), every factor a real one: at n = 8192 fp32, the
   Cholesky factor of a damped Gram matrix A = G G^T / 2n + 1e-2 I (G
   (n, 2n) from randn) by selective inversion, its residual in fp64
   within 10x of ``torch.linalg.cholesky``'s and its upper triangle
   zero; its cyclic output admitted into an inv bank (n0 = 4096,
   bf16_refine) and 64 requests of widths 1..16 served at relres <=
   1e-5; LU without pivoting of randn + n I (residual within 10x of
   ``lu_factor``'s, which pivots: not the same function); L^-1 at
   s0 = n (one B1 launch) and s0 = n/8 (phase B's levels), within 10x
   of ``solve_triangular(L, I)``'s residual; each timed beside its
   library call.  Then KFAC-CA at qwen3-1.7b's widths on 2 units (the
   reference's ``params["units"]`` tree, random weights, seeded
   gradients, whiten): 3 steps, ``factor_banks_from_state`` (banks
   {1024: 4, 2048: 18, 6144: 6}), every damped factor held to
   ||L L^T - (M + lam I)|| / ||M + lam I|| in fp64 within 10x of
   ``torch.linalg.cholesky``'s on the same matrix, one wave per bank
   with every slot within 1e-5 (the fp32 preset's bound) of its damped
   factor, a 4th step whose update of ``wq`` and ``down`` is held to an
   fp64 ``eigh`` reference, (A + lam I)^{-1/2} G on the same EMA
   state, within 5e-3 (the reference's own whiten test,
   ``tests/test_substrate.py``), ``refresh_banks``
   (the first call builds each bank's run updater; a warm refresh
   builds nothing, no serving program is rebuilt), the new factors
   held to their matrices as before, the waves again
   against them, a ``replace_run`` of 2 and of 4 slots
   against as many single replaces, and the fleet (``fleet=True`` on
   the state before the 4th step, one refresh through it to the 4th
   step's and one wave, padded tails zero).  B1, B2
   and B5 launches per sub-phase; a kernel the sub-phase needs that
   launched 0 times fails it.  The last stack of each shape that the
   first step, the banking, the first refresh and the fleet's banking
   hand to B1 (or B5) is kept and held against the plain version
   afterwards, as phase 2 holds them.
12. The distributed algorithms (``distributed_phase``) at n = 8192,
   k = 64 on the (2, 2), (2, 1) and (1, 4) grids: one spawn of p ranks
   per grid, gloo, every rank on cuda:0 (NCCL refuses two ranks on one
   GPU, so the collectives are staged through host memory while every
   kernel runs on the card; the NCCL path is not exercised).  Each rank
   makes L = tril(randn) + n I and B = randn from one numpy seed and
   runs, through the entry points a user calls: ``core.trsm`` "inv" at
   n0 = n/8 (all-to-all phase 1) in fp64 and fp32, at n0 = n/2
   (cooperative doubling), with the all-gather phase 1, and "rec" at its
   default n0; on (2, 2) also upper and transposed solves,
   ``mm3d.matmul`` (8192 x 8192 @ 8192 x 64, fp64) and
   ``tri_inv.invert`` (fp32).  Per case: relres <= 1e-11 (fp64) and
   1e-5 (fp32), the reference's bounds; X against the p = 1 solve of
   the same inputs on the card; the product within 1e-12 of
   ``torch.matmul``, its traced S and W ``cost_model.mm_cost``'s; the
   inverse's residual within 10x the library's and against the p = 1
   inverse; B1, B2 and B3 launched in every rank on their paths; every
   rank's cost trace the same.  Printed per case: host-staged seconds
   and staged bytes per rank, launches, the cost trace, and for the
   first "inv" and the "rec" case on (2, 2) each rank's device ms of
   kernels and of staging copies (profiler); B1, B2 and B3 against
   their plain versions on the inputs each case handed them, in every
   rank; the phase's seconds.
13. The front door at p > 1 (``front_rank``), in phase 12's ranks after
   its cases, at n = 8192, k = 16, n0 = 1024: on (2, 2)
   ``Solver.from_factor`` "inv" in bf16_refine, fp32 and fp64_refine
   and "rec" in bf16_refine, a C = 4 "inv" capacity bank's lifecycle
   (two admits, a padded admission, replace, a ``replace_run`` of 2,
   evict, re-admit), lower and upper C = 2 padded banks and a "rec"
   C = 4 bank with 2 live slots; on (2, 1) and (1, 4) the lower padded
   and the dead-lane banks.  Per case, counted from 0 around the calls
   a user makes: every request's relres in fp64 against the factor its
   slot held (1e-5 for fp32 and bf16_refine, 1e-11 for fp64_refine),
   its X against the p = 1 solve of the same factor, preset and B,
   dead lanes and padded tails exactly zero, each padded slot's leading
   block bit-equal to an unpadded p > 1 bank's, the solve program built
   once over 3 steady solves and the slot turnover, the cost trace and
   every X the same in every rank, B1, B2, B3, B5 and B6 launched where
   the case runs them and held against their plain versions on the
   inputs they were handed.  Printed per case: host-staged ms and
   staged bytes per solve, launches per rank, each kernel's ms at the
   case's inputs (rank 0 with the card to itself); the phase's seconds.
14. The card line, the kernels' JSON summary, then the last line
   ``{"ok": true, "device": {...}}``.  Each kernel's launches are those
   of its main path's run: B1 and B2 the inv configuration at the
   default n0, B3 the rec one, B4 the first structured one, B6 the rec
   churn phase, B5 the fleet phase; ``launches_distributed`` adds its
   launches in phases 12-13, summed over ranks, grids and cases, and
   is above 0 for every kernel but B4 (structure at p > 1 is the next
   slice).
"""

import collections
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
# traffic: the reference CLI's trsm-traffic configuration lifted to n:
# min(--bank 16, 4) factors, inv at the default n0, bf16_refine,
# --panel-k 16 with requests of panel_k // 4 columns (16 requests fill a
# wave), --queue-depth 128, --slo-ms 50, --requests 512 per run; the
# saturation sweep of benchmarks/bench_serve_latency.py (from 0.25x the
# closed-loop capacity, x1.5 a step, at most 8 points of 2 s each, the
# last rate with >= 95% goodput) and its 5 s acceptance run at 0.8x
# saturation: goodput counts the run's last completions, so a
# 512-request run at 2000 requests/s (0.26 s) loses 7% of it to a 20 ms
# tail whatever the load
TRAFFIC_FACTORS = 4
TRAFFIC_WIDTH = PANEL_K // 4
TRAFFIC_DEPTH = 128
TRAFFIC_SLO_MS = 50.0
TRAFFIC_REQUESTS = 512
TRAFFIC_RELRES = 1e-5
TRAFFIC_CAPACITY_WAVES = 20
TRAFFIC_SWEEP = (0.25, 1.5, 8)
TRAFFIC_SWEEP_S = 2.0
TRAFFIC_ACCEPT_S = 5.0
TRAFFIC_GOODPUT = 0.95
# factor producers (phase 11 a): A = G G^T / 2n + FACTOR_SHIFT I with G
# (n, 2n) from randn, a damped Gram matrix; its Cholesky factor banked
# ("inv", n0 = n/2, bf16_refine) and served at the preset's bound
FACTOR_SHIFT = 1e-2
FACTOR_RELRES = 1e-5
# K-FAC (phase 11 b): qwen3-1.7b's widths (src/repro/configs/qwen3_1_7b.py)
# at 2 of its 28 units, the reference's kfac_ca defaults (whiten,
# max_dim 8192, update_freq 1), 3 steps before banking
QWEN = dict(d_model=2048, n_heads=16, n_kv=8, head_dim=128, d_ff=6144)
KFAC_UNITS = 2
KFAC_STEPS = 3
KFAC_ORDERS = {1024: 4, 2048: 18, 6144: 6}
KFAC_DAMPING = 1e-3                 # kfac_ca's and the banking's default
# the whiten update against an fp64 eigh reference: the bound of the
# reference's own test of it (tests/test_substrate.py)
KFAC_WHITEN_TOL = 5e-3
KFAC_WHITEN_PARAMS = (("attn", "wq"), ("mlp", "down"))
# distributed (phase 12): the paper's grids, one gloo rank per process,
# every rank on cuda:0; k = 64 right-hand sides (p | k for rec); the
# reference's relres bounds (tests/test_api_solver.py), X against the
# p = 1 solve of the same inputs, the product against torch.matmul
DIST_GRIDS = ((2, 2), (2, 1), (1, 4))
DIST_K = 64
DIST_SEED = 160
DIST_RELRES = {"float64": 1e-11, "float32": 1e-5}
DIST_AGREE = {"float64": 1e-10, "float32": 1e-4}
DIST_MM3D_TOL = 1e-12
# phase 13: the front door over the same ranks (Solver, FactorBank,
# capacity banks, every preset) at n = 8192, one panel of k = 16
FRONT_K = 16
FRONT_N0 = N // 8           # m = 8: p | m on every grid, all-to-all phase 1
FRONT_C = 4
FRONT_STEADY = 3
FRONT_SEED = 170
FRONT_RELRES = {"fp32": 1e-5, "bf16_refine": 1e-5,
                "fp64_refine": 1e-11}         # tests/test_api_solver.py
FRONT_AGREE = {"fp32": 1e-4, "bf16_refine": 1e-4, "fp64_refine": 1e-10}


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
                  unit: str = "solve", warm: int = 2,
                  cpu: bool = True) -> dict:
    """Where the time of ``calls`` calls of ``run`` (each one ``unit``,
    after ``warm`` unprofiled ones) goes: device time by kernel and the
    device's busy share of the host-clock window, from torch.profiler
    (CUPTI), and the ``torch.matmul`` calls per call (None with
    ``cpu=False``, which traces the device alone: a call of tens of
    thousands of operators is otherwise slowed, and its trace summed,
    for minutes).  A profiler that sees no device time is reported, not
    failed: it measures, it does not check the port.  Returns the
    printed record."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warm):
        run(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu else [])) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, averages = [], prof.key_averages()
    for e in averages:
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(us for us, _, _ in rows) / 1e3
    matmuls = sum(e.count for e in averages
                  if e.key == "aten::matmul") if cpu else None
    rec = {"profile": label, f"{unit}s": calls,
           f"wall_ms_per_{unit}": wall * 1e3 / calls,
           f"device_ms_per_{unit}": device_ms / calls,
           "device_busy_share": device_ms / (wall * 1e3) if rows else None,
           f"matmuls_per_{unit}": matmuls / calls if cpu else None,
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


def traffic_offer(server, submit, rate, rng, label, count):
    """One open-loop Poisson run of ``count`` requests at ``rate``
    against the server's background drain loop, under a torch.profiler
    window (CUDA activity only: the drain thread's kernels are in it).
    Latency is completion minus SCHEDULED arrival (a submit that falls
    behind still pays for it).  Every future must be done within 120 s.
    Returns the run's record and its served requests
    [(request index, future)]."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    gaps = rng.exponential(1.0 / rate, size=count)
    st0 = server.stats()
    gc.collect()
    torch.cuda.synchronize()
    reset_counts()
    futs, served = [], []
    depth_shed = deadline_shed = stranded = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gc.disable()
        try:
            with server:                       # the background drain loop
                t0 = time.monotonic()
                sched = t0 + np.cumsum(gaps)
                for i, t_i in enumerate(sched):
                    delay = t_i - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    try:
                        futs.append((t_i, i, submit(i)))
                    except api.Overloaded:
                        depth_shed += 1        # raised at submit
                for t_i, i, f in futs:
                    try:
                        f.result(timeout=120)
                        served.append((t_i, i, f))
                    except api.DeadlineUnmeetable:
                        deadline_shed += 1     # through the future
                    except api.StrandedRequestError:
                        stranded += 1
                    except TimeoutError as e:
                        raise SmokeFailure(f"traffic {label}: request {i} "
                                           f"not done in 120 s") from e
                elapsed = time.monotonic() - t0
        finally:
            gc.enable()
        torch.cuda.synchronize()
    launches = read_counts()
    st = server.stats()
    d = {k: st[k] - st0[k] for k in ("submitted", "served", "shed",
                                     "stranded", "waves")}
    check(d["submitted"] + d["shed"] == count
          and d["shed"] == depth_shed + deadline_shed
          and d["submitted"] == d["served"] + d["stranded"]
          and d["served"] == len(served) and d["stranded"] == stranded
          and st["pending"] == 0 and st["inflight"] == 0,
          f"traffic {label}: counts {d} against {len(served)} served, "
          f"{depth_shed} + {deadline_shed} shed, {stranded} stranded")
    lat = np.asarray([f.completed - t_i for t_i, _, f in served])
    rows = sorted(((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    device_us = sum(us for us, _, _ in rows)
    waves = max(d["waves"], 1)
    pct = (lambda q: float(np.percentile(lat, q)) * 1e3) if len(lat) \
        else (lambda q: None)
    rec = dict(traffic_run=label, requests=count,
               offered_rps=rate, arrivals_rps=count / (sched[-1] - t0),
               goodput_rps=len(served) / elapsed,
               goodput_ratio=len(served) / elapsed / rate,
               served=len(served), elapsed_s=elapsed,
               p50_ms=pct(50), p99_ms=pct(99),
               max_ms=float(lat.max()) * 1e3 if len(lat) else None,
               slo_ms=TRAFFIC_SLO_MS,
               violations=int((lat * 1e3 > TRAFFIC_SLO_MS).sum()),
               depth_shed=depth_shed, deadline_shed=deadline_shed,
               stranded=stranded, waves=d["waves"],
               device_ms_per_wave=device_us / 1e3 / waves,
               device_busy_share=device_us / 1e3 / (elapsed * 1e3)
               if device_us else None,
               top=[[key[:60], us / 1e3 / waves, count / waves]
                    for us, key, count in rows[:6]],
               launches=launches)
    return rec, served


def traffic_phase(api, seed):
    """The open-loop tier (TRAFFIC_*): the reference CLI's trsm-traffic
    configuration at n = 8192 — 4 factors L = tril(randn) + n I, "inv"
    at the default n0 = 4096, bf16_refine, panel_k = 16, requests of 4
    columns from a device pool, queue depth 128, SLO 50 ms — served
    through ``api.AsyncSolveServer`` after priming every wave
    composition.  Runs: the closed-loop capacity (s per full wave), the
    saturation sweep (2 s a point) and the 5 s acceptance run at 0.8x
    saturation (best of two, >= 95% goodput), 512 requests at 2x
    saturation with depth-only and with SLO admission
    (``api.AdmissionController``), the steady state (placed RHS, one
    priming wave, then submit, ``step()`` by hand at max_inflight = 2
    and the event waits under sync-debug mode "error", no build), and
    ``--autoscale``: orders {8192: 2, 4096: 2} planned under the H100
    preset, ``api.Autoscaler`` attached, 512 requests at 2x saturation,
    the plans and every replan printed.  Checks: every served request's
    relres in fp64 against its factor <= 1e-5; padded tails exactly
    zero; every future done within its timeout; submitted = served +
    stranded and offered = submitted + shed; no build after priming but
    an opened or rebuilt bucket's; trmm = 6 x waves in the plain runs
    and no other kernel; phase 1 once per moved factor in a migration
    (B5 where it is padded).  Returns (launches of the acceptance run,
    stats)."""
    from repro_torch.core import session
    grid = api.make_trsm_mesh(1, 1)
    dev = grid.device
    fresh, g = factor_maker(dev, seed)
    rng = np.random.default_rng(0)
    M, w = TRAFFIC_FACTORS, TRAFFIC_WIDTH
    per_wave = M * (PANEL_K // w)
    what = f"traffic bf16_refine n={N}"

    def relres_check(label, served, factor_of, pool_of):
        """relres per served request, batched per factor in fp64; the
        padded tail of a merged bucket's lane exactly zero."""
        by = {}
        tails = 0
        for _, i, f in served:
            X = f.result(timeout=0)
            by.setdefault(factor_of(i), []).append((X, pool_of(i)))
            n_b = f.factor[0][0] if isinstance(f.factor, tuple) else N
            if f.order < n_b:
                tail = X.as_strided((n_b - f.order, X.shape[1]), X.stride(),
                                    X.storage_offset()
                                    + f.order * X.stride(0))
                check(not tail.any(), f"{what} {label}: request {i}'s "
                                      f"padded tail is not zero")
                tails += 1
        worst = 0.0
        for key, xs in by.items():
            L = factors[key]
            for r in request_relres(L, [x for x, _ in xs],
                                    [b for _, b in xs]):
                check(r <= TRAFFIC_RELRES, f"{what} {label}: {key} relres "
                                           f"{r} > {TRAFFIC_RELRES}")
                worst = max(worst, r)
        return worst, tails

    # ------------------------- the plain bank -------------------------
    factors = {j: fresh() for j in range(M)}
    solver = api.Solver.from_factors(torch.stack(list(factors.values())),
                                     grid, method="inv",
                                     precision="bf16_refine")
    check(solver.n0 == N // 2, f"{what}: n0 {solver.n0}")
    server = api.AsyncSolveServer(solver, PANEL_K,
                                  queue_depth=TRAFFIC_DEPTH,
                                  slo_ms=TRAFFIC_SLO_MS).warmup()
    pool = [torch.randn((N, w), generator=g, device=dev) for _ in range(32)]

    def sub(i):
        return server.submit(pool[i % 32], factor=i % M)

    def prime(srv, submit):
        """Every wave composition before the clock starts (the CLI's
        priming): lazy first builds belong to startup.  Returns the
        served requests [(None, request index, future)]."""
        futs = []
        for count in range(1, per_wave + 1):
            for i in range(count):
                futs.append((None, i, submit(i)))
            while srv.pending() or srv._inflight:
                srv.step()
            srv.flush()
        return futs

    relres_check("priming", prime(server, sub), lambda i: i % M,
                 lambda i: pool[i % 32])
    server.reset_service_ewma()
    builds0 = sum(session.BUILD_COUNTS.values())

    # 1. closed-loop capacity: one full wave at a time, drained
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAFFIC_CAPACITY_WAVES):
        for i in range(per_wave):
            sub(i)
        while server.pending() or server._inflight:
            server.step()
    torch.cuda.synchronize()
    s_per_wave = (time.perf_counter() - t0) / TRAFFIC_CAPACITY_WAVES
    capacity = per_wave / s_per_wave
    print(json.dumps(dict(traffic_capacity=what, s_per_full_wave=s_per_wave,
                          requests_per_wave=per_wave,
                          capacity_rps=capacity)), flush=True)

    def plain_run(label, rate, seconds=None):
        count = TRAFFIC_REQUESTS if seconds is None \
            else max(int(rate * seconds), 1)
        rec, served = traffic_offer(server, sub, rate, rng, label, count)
        want = dict.fromkeys(counters(), 0)
        want["trmm"] = 6 * rec["waves"]
        check(rec["launches"] == want, f"{what} {label}: launches "
                                       f"{rec['launches']}, want {want}")
        check(sum(session.BUILD_COUNTS.values()) == builds0,
              f"{what} {label}: a program was built after priming")
        rec["worst_relres"], _ = relres_check(
            label, served, lambda i: i % M, lambda i: pool[i % 32])
        print(json.dumps(rec), flush=True)
        return rec

    # 2. the saturation sweep, then the acceptance run at 0.8x
    start, step, points = TRAFFIC_SWEEP
    rate, saturation = capacity * start, None
    for k in range(points):
        rec = plain_run(f"sweep {k}", rate, TRAFFIC_SWEEP_S)
        if rec["goodput_ratio"] < TRAFFIC_GOODPUT:
            break
        saturation = rate
        rate *= step
    if saturation is None:             # even the floor lost goodput: as
        saturation = capacity * start  # the bench, report it and let the
                                       # acceptance run judge
    print(json.dumps(dict(traffic_saturation_rps=saturation,
                          capacity_rps=capacity)), flush=True)
    for attempt in range(2):                 # best of two, as the bench
        accept = plain_run(f"accept 0.8x #{attempt}", 0.8 * saturation,
                           TRAFFIC_ACCEPT_S)
        if accept["goodput_ratio"] >= TRAFFIC_GOODPUT:
            break
    check(accept["goodput_ratio"] >= TRAFFIC_GOODPUT,
          f"{what}: goodput {accept['goodput_ratio']:.3f} at 0.8x "
          f"saturation")

    # 3. overload: 2x saturation, depth-only, then SLO admission
    over_depth = plain_run("overload 2x depth", 2 * saturation)
    ctrl = api.AdmissionController(slo_ms=TRAFFIC_SLO_MS)
    server.reset_service_ewma()
    server.set_admission(ctrl)
    over_slo = plain_run("overload 2x slo", 2 * saturation)
    check(ctrl.shed == over_slo["deadline_shed"],
          f"{what}: the controller shed {ctrl.shed}, the futures "
          f"{over_slo['deadline_shed']}")
    server.set_admission(None)

    # the steady state; first, on its own: does an event wait trip
    # sync-debug "error"?
    probe = torch.cuda.Event()
    probe.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        probe.synchronize()
        event_trips = False
    except RuntimeError:
        event_trips = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steady = api.AsyncSolveServer(solver, PANEL_K, max_inflight=2,
                                  queue_depth=TRAFFIC_DEPTH)
    steady.submit(pool[0], factor=0)                    # priming wave
    while steady.pending() or steady._inflight:
        steady.step()
    spec = solver.spec_for(PANEL_K)
    builds = session.BUILD_COUNTS[spec]
    torch.cuda.synchronize()
    futs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2 * per_wave):
            futs.append((i, steady.submit(pool[i % 32], factor=i % M)))
        while steady.pending():
            steady.step()
        steady.flush()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(session.BUILD_COUNTS[spec] == builds == 1,
          f"{what}: the steady state built a program")
    worst_steady, _ = relres_check(
        "steady", [(None, i, f) for i, f in futs], lambda i: i % M,
        lambda i: pool[i % 32])
    print(json.dumps(dict(traffic_steady_state="ok",
                          sync_debug_mode="error",
                          event_synchronize_trips_error_mode=event_trips,
                          guarded="submit, pack, dispatch and finalize",
                          waves=steady.waves, builds=builds,
                          worst_relres=worst_steady)), flush=True)
    del server, steady, solver, futs
    gc.collect()
    torch.cuda.empty_cache()

    # 4. --autoscale: a two-order fleet with the Autoscaler attached
    orders = [N, N, N // 2, N // 2]
    factors = {f"f{j}": fresh(d) for j, d in enumerate(orders)}
    manifest = {N: 2, N // 2: 2}
    plan = api.plan_fleet(manifest, grid, k=PANEL_K,
                          precision="bf16_refine")
    print(plan.table(), flush=True)
    before = [[b.n, list(b.orders), b.capacity, b.method, b.n0]
              for b in plan.buckets]
    fleet = api.SolverFleet(grid, plan)
    for tag, L in factors.items():
        fleet.admit(L, tenant="traffic", tag=tag)
    fserver = api.AsyncSolveServer(fleet, PANEL_K,
                                   queue_depth=TRAFFIC_DEPTH,
                                   slo_ms=TRAFFIC_SLO_MS).warmup()
    scaler = api.Autoscaler(fserver)
    pools = {d: [torch.randn((d, w), generator=g, device=dev)
                 for _ in range(32)] for d in set(orders)}
    tags = list(factors)

    def fsub(i):
        tag = tags[i % len(tags)]
        return fserver.submit(pools[orders[i % 4]][i % 32],
                              tenant="traffic", tag=tag)

    torch.cuda.synchronize()
    reset_counts()
    _, primed_tails = relres_check(
        "autoscale priming", prime(fserver, fsub), lambda i: tags[i % 4],
        lambda i: pools[orders[i % 4]][i % 32])
    priming_launches = read_counts()
    fserver.reset_service_ewma()
    replans0 = len(scaler.replans)
    moved0 = sum(r["moved"] for r in scaler.replans)
    check(priming_launches["tri_inv_blocks"]
          + priming_launches["tri_inv_blocks_valid"] == moved0,
          f"{what} autoscale priming: phase 1 {priming_launches} for "
          f"{moved0} moved factors")
    primed = [[b.n, list(b.orders), b.capacity, b.method, b.n0]
              for b in fleet.plan.buckets]
    built_before = collections.Counter(session.BUILD_COUNTS)
    rec, served = traffic_offer(fserver, fsub, 2 * saturation, rng,
                                "autoscale 2x", TRAFFIC_REQUESTS)
    replans = scaler.replans[replans0:]
    allowed = {k[0] for r in replans for k in r["opened"] + r["rebuilt"]}
    built = {key: c - built_before[key]
             for key, c in session.BUILD_COUNTS.items()
             if c != built_before[key]}
    check(all(key.n in allowed for key in built),
          f"{what} autoscale: built {list(built)} outside the opened or "
          f"rebuilt buckets {sorted(allowed)}")
    moved = sum(r["moved"] for r in replans)
    phase1 = rec["launches"]["tri_inv_blocks"] \
        + rec["launches"]["tri_inv_blocks_valid"]
    check(phase1 == moved, f"{what} autoscale: {phase1} phase-1 launches "
                           f"for {moved} moved factors")
    rec["worst_relres"], rec["padded_tails_checked"] = relres_check(
        "autoscale", served, lambda i: tags[i % 4],
        lambda i: pools[orders[i % 4]][i % 32])
    after = [[b.n, list(b.orders), b.capacity, b.method, b.n0]
             for b in fleet.plan.buckets]
    print(fleet.plan.table(), flush=True)

    def spelled(rs):
        return [dict(r, opened=[k[0] for k in r["opened"]],
                     closed=[k[0] for k in r["closed"]],
                     rebuilt=[k[0] for k in r["rebuilt"]]) for r in rs]
    rec.update(plan_before=before, plan_after_priming=primed,
               plan_after=after, replans=spelled(replans),
               replans_during_priming=spelled(scaler.replans[:replans0]),
               priming_launches=priming_launches,
               priming_padded_tails_checked=primed_tails,
               nominal_dispatch_ms=plan.dispatch_s * 1e3,
               built_in_run={f"{type(k).__name__} n={k.n}": c
                             for k, c in built.items()},
               autoscaler=scaler.stats())
    print(json.dumps(rec, default=str), flush=True)
    stats = dict(traffic=what, capacity_rps=capacity,
                 s_per_full_wave=s_per_wave, saturation_rps=saturation,
                 accept=accept, overload_depth=over_depth,
                 overload_slo=over_slo, autoscale=rec,
                 event_synchronize_trips_error_mode=event_trips)
    del fserver, fleet, factors
    gc.collect()
    torch.cuda.empty_cache()
    return accept["launches"], stats


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``reps`` calls, each ended by a
    synchronize (the producers are Python-driven: their time is the
    host's and the device's together)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def counted(fn):
    """(fn's result, the kernel launches it made, its host-clock ms to a
    synchronize): the counts set to 0 just before, read just after."""
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), (time.perf_counter() - t) * 1e3


def need(launches: dict, kernels, what: str) -> None:
    for k in kernels:
        check(launches[k] > 0, f"{what}: {k} launched 0 times")


def fro_rel(R, A) -> float:
    return (torch.linalg.norm(R) / torch.linalg.norm(A)).item()


class B1Inputs:
    """Keeps the last stack of each (sub-phase, shape, dtype, gated) that
    reaches B1's wrapper through the kernel hook while it is entered, and
    passes every call through unchanged (the counts stay the wrapper's).
    ``check`` then holds B1 (B5 for a gated stack) against its plain
    version on each kept stack, as ``kernel_phase`` does."""

    def __init__(self):
        self.stacks = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.b1 = ops, ops.tri_inv_blocks

        def keep(Ls, valid=None):
            key = (self.where, tuple(Ls.shape),
                   str(Ls.dtype).removeprefix("torch."), valid is not None)
            self.stacks[key] = (Ls.clone(),
                                None if valid is None else valid.clone())
            return self.b1(Ls, valid)
        ops.tri_inv_blocks = keep
        return self

    def __exit__(self, *exc):
        self.ops.tri_inv_blocks = self.b1

    def __call__(self, where: str):
        self.where = where
        return self

    def check(self) -> list:
        from repro_torch.kernels import tri_inv_block
        out = []
        for (where, shape, dtype, gated), (Ls, v) in self.stacks.items():
            got = tri_inv_block.tri_inv_blocks(Ls, v)
            want = tri_inv_block.tri_inv_blocks_plain(Ls, v)
            abs_err, rel_err = errors(got, want)
            low_err = lower_rel_error(got, want)
            tol = 2e-2 if Ls.dtype == torch.bfloat16 else 1e-4
            what = f"B1 on kfac {where}'s {shape} {dtype} stack"
            check(rel_err <= tol, f"{what}: max_rel_err {rel_err} > {tol}")
            check(low_err <= tol, f"{what}: strictly lower part off by "
                                  f"{low_err} of its max > {tol}")
            out.append(dict(where=where, shape=list(shape), dtype=dtype,
                            gated=gated, max_abs_err=abs_err,
                            max_rel_err=rel_err, lower_rel_err=low_err,
                            tol=tol))
        self.stacks.clear()
        return out


def producers_phase(api, grid, seed):
    """Phase 11 (a): the factor producers at n = 8192, fp32.  Returns
    (launches by sub-phase, the record)."""
    from repro_torch.core import cholesky, lu, tri_inv
    device = grid.device
    g = torch.Generator(device=device).manual_seed(seed)
    G = torch.randn((N, 2 * N), generator=g, device=device)
    A = G @ G.T / (2 * N)
    A.diagonal().add_(FACTOR_SHIFT)
    del G
    rec, launches = {"n": N, "dtype": "float32"}, {}
    t0 = time.perf_counter()
    marks = rec["marks_s"] = {}

    def mark(what):
        torch.cuda.synchronize()
        marks[what] = time.perf_counter() - t0

    # Cholesky by selective inversion, the default n0 (n/8)
    L, launches["cholesky"], _ = counted(
        lambda: cholesky.cholesky(A, grid))
    need(launches["cholesky"], ["tri_inv_blocks"], "cholesky")
    A64, L64 = A.double(), L.double()
    res = fro_rel(L64 @ L64.T - A64, A64)
    Llib = torch.linalg.cholesky(A)
    res_lib = fro_rel(Llib.double() @ Llib.double().T - A64, A64)
    del Llib
    check(res <= 10 * res_lib, f"cholesky: ||LL^T - A|| / ||A|| {res} > "
                               f"10x the library's {res_lib}")
    check(torch.triu(L, 1).count_nonzero().item() == 0,
          "cholesky: L has entries above the diagonal")
    rec["cholesky"] = dict(
        ms=host_ms(lambda: cholesky.cholesky(A, grid), 3),
        library_ms=host_ms(lambda: torch.linalg.cholesky(A), 3),
        library="torch.linalg.cholesky", rel_residual=res,
        library_rel_residual=res_lib)
    rec["cholesky"]["profile"] = profile_calls(
        lambda i: cholesky.cholesky(A, grid), f"cholesky n={N}", 2,
        unit="call")
    mark("cholesky")

    # the cyclic output into a bank, 64 requests through SolveServer
    def serve_cyclic():
        bank = api.FactorBank(grid, N, method="inv", n0=N // 2,
                              precision="bf16_refine")
        bank.admit_cyclic(cholesky.cholesky_cyclic(A, grid))
        server = api.SolveServer(api.Solver.from_bank(bank),
                                 panel_k=PANEL_K).warmup()
        widths = np.random.default_rng(seed).integers(1, PANEL_K + 1,
                                                      REQUESTS)
        bs = [torch.randn((N, int(w)), generator=g, device=device)
              for w in widths]
        for b in bs:
            server.submit(b)
        return server, bs, server.drain()[0]

    (server, bs, xs), launches["bank"], ms = counted(serve_cyclic)
    need(launches["bank"], ["tri_inv_blocks", "trmm"], "cholesky bank")
    check(server.requests_served == REQUESTS,
          f"cholesky bank: served {server.requests_served}")
    worst = max(request_relres(L64, xs, bs))
    check(worst <= FACTOR_RELRES, f"cholesky bank: worst request relres "
                                  f"{worst} > {FACTOR_RELRES}")
    rec["bank"] = dict(config=f"inv bf16_refine n0={N // 2}, admit_cyclic",
                       requests=REQUESTS, panels=server.panels_solved,
                       ms=ms, worst_relres=worst, relres_bound=FACTOR_RELRES)
    del server, bs, xs, A64, A
    mark("bank")

    # LU without pivoting
    A2 = torch.randn((N, N), generator=g, device=device)
    A2.diagonal().add_(N)
    (L2, U2), launches["lu"], _ = counted(lambda: lu.lu(A2, grid))
    need(launches["lu"], ["tri_inv_blocks"], "lu")
    A2_64 = A2.double()
    res = fro_rel(L2.double() @ U2.double() - A2_64, A2_64)
    LUp, piv = torch.linalg.lu_factor(A2)
    P, Ll, Ul = torch.lu_unpack(LUp, piv)
    res_lib = fro_rel(P.double() @ (Ll.double() @ Ul.double()) - A2_64,
                      A2_64)
    del LUp, P, Ll, Ul
    check(res <= 10 * res_lib, f"lu: ||LU - A|| / ||A|| {res} > 10x the "
                               f"library's {res_lib}")
    check(bool((torch.diagonal(L2) == 1).all()), "lu: L's diagonal is not 1")
    check(torch.triu(L2, 1).count_nonzero().item() == 0
          and torch.tril(U2, -1).count_nonzero().item() == 0,
          "lu: L or U is not triangular")
    rec["lu"] = dict(ms=host_ms(lambda: lu.lu(A2, grid), 1),
                     library_ms=host_ms(lambda: torch.linalg.lu_factor(A2),
                                        3),
                     library="torch.linalg.lu_factor (pivots: not the "
                             "same function)",
                     rel_residual=res, library_rel_residual=res_lib)
    del L2, U2, A2, A2_64
    mark("lu")

    # the inversion: one B1 launch at s0 = n, then phase B's levels
    eye = torch.eye(N, device=device)
    Xlib = torch.linalg.solve_triangular(L, eye, upper=False)
    res_lib = fro_rel(Xlib.double() @ L64 - eye.double(), eye.double())
    del Xlib
    rec["invert"] = {}
    for s0 in (None, N // 8):
        Li, launches[f"invert s0={s0}"], _ = counted(
            lambda: tri_inv.invert(L, grid, s0=s0))
        need(launches[f"invert s0={s0}"], ["tri_inv_blocks"], "invert")
        res = fro_rel(Li.double() @ L64 - eye.double(), eye.double())
        check(res <= 10 * res_lib, f"invert s0={s0}: ||L^-1 L - I|| {res} "
                                   f"> 10x the library's {res_lib}")
        rec["invert"][f"s0={s0 or N}"] = dict(
            ms=host_ms(lambda: tri_inv.invert(L, grid, s0=s0), 3),
            rel_residual=res)
        del Li
    rec["invert"]["library_ms"] = host_ms(
        lambda: torch.linalg.solve_triangular(L, eye, upper=False), 3)
    rec["invert"]["library"] = "torch.linalg.solve_triangular(L, I)"
    rec["invert"]["library_rel_residual"] = res_lib
    mark("invert")
    rec["launches"] = launches
    print(json.dumps({"factor_producers": rec}), flush=True)
    del L, L64, eye
    return launches, rec


def qwen_units(device, g) -> dict:
    """``params["units"]`` of qwen3-1.7b as the reference's
    ``models/lm.py`` builds it (``layers.init_attn``, ``init_mlp``,
    the rmsnorms), stacked over KFAC_UNITS units, random from ``g``."""
    u, d, hd = KFAC_UNITS, QWEN["d_model"], QWEN["head_dim"]
    hq, hkv, f = QWEN["n_heads"] * hd, QWEN["n_kv"] * hd, QWEN["d_ff"]

    def dense(m, n):
        return torch.randn((u, m, n), generator=g, device=device) * m ** -0.5

    def norm(m):
        return torch.ones((u, m), device=device)

    return {"units": {"b0": {
        "ln1": norm(d), "ln2": norm(d),
        "attn": {"wq": dense(d, hq), "wk": dense(d, hkv),
                 "wv": dense(d, hkv), "wo": dense(hq, d),
                 "qn": norm(hd), "kn": norm(hd)},
        "mlp": {"gate": dense(d, f), "up": dense(d, f),
                "down": dense(f, d)}}}}


def kfac_phase(api, grid, seed):
    """Phase 11 (b): KFAC-CA at qwen3-1.7b's full widths, two units.
    Returns (launches by sub-phase, the record)."""
    import importlib

    from repro_torch.core import session
    from repro_torch.optim.tree import tree_map
    kfac = importlib.import_module("repro_torch.optim.kfac_ca")
    device = grid.device
    g = torch.Generator(device=device).manual_seed(seed)
    params = qwen_units(device, g)
    opt = kfac.kfac_ca()
    state = opt.init(params)
    rec, launches = {"units": KFAC_UNITS, "widths": QWEN}, {}
    t0 = time.perf_counter()
    marks = rec["marks_s"] = {}

    def mark(what):
        torch.cuda.synchronize()
        marks[what] = time.perf_counter() - t0

    def grads():
        return tree_map(lambda p: torch.randn(p.shape, generator=g,
                                              device=device), params)

    def step(gr=None):
        nonlocal params, state
        gr = grads() if gr is None else gr
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, _ = opt.update(gr, state, params)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    # the last step runs under the profiler (the device alone: its
    # ~86k operators would take the host trace minutes), so its host time
    # is not in step_ms; the first keeps B1's inputs (a clone a launch)
    b1_inputs = B1Inputs()
    def whiten_check(before, gr):
        """The step's update of each KFAC_WHITEN_PARAMS tensor, both
        units, against (A + lam I)^{-1/2} G in fp64 from eigh, on the
        smaller side, A the EMA the step left in ``state``.  The grafting
        scales the update by one number for the stacked tensor, so the
        directions are compared: ||u/||u|| - r/||r|| ||."""
        out = {}
        for group, name in KFAC_WHITEN_PARAMS:
            old = before["units"]["b0"][group][name].double()
            new = params["units"]["b0"][group][name].double()
            G = gr["units"]["b0"][group][name].double()
            Aema, Bema = state["kron"]["units"]["b0"][group][name]
            transpose = G.shape[-2] > G.shape[-1]
            M = (Bema if transpose else Aema).double()
            d = M.shape[-1]
            tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
            M = M + (KFAC_DAMPING * (tr / d + 1e-12))[..., None, None] \
                * torch.eye(d, device=device, dtype=torch.float64)
            w, V = torch.linalg.eigh(M)
            root = (V * w.rsqrt()[..., None, :]) @ V.transpose(-2, -1)
            ref = G @ root if transpose else root @ G
            upd = old - new
            err = torch.linalg.norm(upd / torch.linalg.norm(upd)
                                    - ref / torch.linalg.norm(ref)).item()
            check(err <= KFAC_WHITEN_TOL,
                  f"kfac whiten {group}.{name}: update off the fp64 eigh "
                  f"reference by {err} > {KFAC_WHITEN_TOL}")
            out[f"{group}.{name}"] = dict(
                shape=list(G.shape), side="B" if transpose else "A",
                direction_err=err, tol=KFAC_WHITEN_TOL,
                cond=(w[..., -1] / w[..., 0]).max().item())
        return out

    step_ms = []
    for i in range(KFAC_STEPS):
        last = i == KFAC_STEPS - 1
        if i == 0:
            with b1_inputs("step 1"):
                ms, launches["step 1"], _ = counted(step)
        else:
            ms, launches[f"step {i + 1}"], _ = counted(
                (lambda: profile_calls(lambda _: step(), "kfac step", 1,
                                       unit="step", warm=0, cpu=False))
                if last else step)
        if last:
            rec["profile_step"] = ms
        else:
            step_ms.append(ms)
        need(launches[f"step {i + 1}"], ["tri_inv_blocks"], "kfac step")
    rec["step_ms"] = step_ms
    rec["b1_launches_per_step"] = launches[f"step {KFAC_STEPS}"][
        "tri_inv_blocks"]
    mark("steps")

    counts = kfac._kron_order_counts(state)
    check(counts == KFAC_ORDERS, f"kfac: orders {counts}, want "
                                 f"{KFAC_ORDERS}")
    with b1_inputs("banking"):
        (banks, manifest), launches["banking"], rec["banking_ms"] = \
            counted(lambda: kfac.factor_banks_from_state(state, grid=grid))
    need(launches["banking"], ["tri_inv_blocks"], "kfac banking")
    check({d: b.size for d, b in banks.items()} == KFAC_ORDERS,
          f"kfac: bank sizes {({d: b.size for d, b in banks.items()})}")
    check(manifest[1024][0] == ("['units']['b0']['attn']['wk']", "B", 0),
          f"kfac: first order-1024 tag {manifest[1024][0]}")
    factors = {}

    def refactor(st, what):
        """Every damped factor of ``st`` as the banking computes it (the
        stacked units in one call: factored one by one, cusolver's
        unbatched route gives another factor of the same matrix, and at
        cond(A) ~ 4e3 a relres against that one reads ~6e-5 on the H100
        where against the banked one it reads ~1e-6), each held to its
        own damped matrix M + lam I, written out here: in fp64,
        ||L L^T - (M + lam I)|| / ||M + lam I|| within 10x of
        torch.linalg.cholesky's on the same fp32 matrix, and L lower
        triangular.  Returns the worst residual and ratio by order."""
        factors.clear()
        worst = {}
        for name, side, M in kfac._iter_kron_factors(st):
            L = factors[(name, side)] = kfac._damped_chol(M, KFAC_DAMPING)
            d = M.shape[-1]
            tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
            Md = M + (KFAC_DAMPING * (tr / d + 1e-12))[..., None, None] \
                * torch.eye(d, device=device)
            Llib = torch.linalg.cholesky(Md)
            check(not torch.triu(L, 1).any().item(),
                  f"kfac {what} {name} {side}: entries above the diagonal")
            for u in range(M.shape[0] if M.ndim == 3 else 1):
                sel = (lambda X: X[u]) if M.ndim == 3 else (lambda X: X)
                M64 = sel(Md).double()
                res, res_lib = (fro_rel(F @ F.T - M64, M64) for F in (
                    sel(L).double(), sel(Llib).double()))
                check(res <= 10 * res_lib,
                      f"kfac {what} {name} {side} unit {u}: ||LL^T - "
                      f"(M + lam I)|| / ||M + lam I|| {res} > 10x the "
                      f"library's {res_lib}")
                w = worst.setdefault(d, dict(rel_residual=0.0,
                                             library_rel_residual=0.0,
                                             ratio=0.0))
                w.update(rel_residual=max(w["rel_residual"], res),
                         library_rel_residual=max(
                             w["library_rel_residual"], res_lib),
                         ratio=max(w["ratio"], res / res_lib))
            del Md, Llib
        return worst

    def damped(tag):
        name, side, unit = tag
        L = factors[(name, side)]
        return L if unit is None else L[unit]

    rec["factors"] = refactor(state, "banked")

    def serve_banks(what):
        worst, ms = {}, {}
        for d, bank in sorted(banks.items()):
            solver = api.Solver.from_bank(bank).warmup(PANEL_K)
            B = torch.randn((bank.width, d, PANEL_K), generator=g,
                            device=device)
            ms[d] = host_ms(lambda: solver.solve(B), 3)
            X = solver.solve(B).double()
            worst[d] = max(fro_rel(damped(tag).double() @ X[i]
                                   - B[i].double(), B[i].double())
                           for i, tag in enumerate(manifest[d]))
            check(worst[d] <= RELRES_BOUND["fp32"],
                  f"kfac {what} order {d}: worst relres {worst[d]}")
        return dict(worst_relres=worst, ms_per_wave=ms)

    rec["serve"], launches["serve"], _ = counted(
        lambda: serve_banks("serve"))
    need(launches["serve"], ["trmm"], "kfac serve")
    keys = {d: api.Solver.from_bank(b).spec_for(PANEL_K)
            for d, b in banks.items()}
    serving_builds = {d: session.BUILD_COUNTS[k] for d, k in keys.items()}

    # one more step, then the in-place refresh (the fleet below banks the
    # state before it and refreshes to it)
    mark("banked and served")
    state_banked, params_before = state, params
    gr = grads()
    rec["step_ms"].append(step(gr))
    rec["whiten"] = whiten_check(params_before, gr)
    del params_before, gr
    rec["factors_refreshed"] = refactor(state, "refreshed")
    before = dict(session.BUILD_COUNTS)
    with b1_inputs("refresh"):
        _, launches["refresh"], rec["refresh_first_ms"] = counted(
            lambda: kfac.refresh_banks(banks, manifest, state))
    need(launches["refresh"], ["tri_inv_blocks"], "kfac refresh")
    first_builds = sum((session.BUILD_COUNTS - collections.Counter(
        before)).values())
    before = dict(session.BUILD_COUNTS)
    rec["refresh_ms"] = host_ms(
        lambda: kfac.refresh_banks(banks, manifest, state), 3)
    check(dict(session.BUILD_COUNTS) == before,
          "kfac refresh: BUILD_COUNTS moved on a warm refresh")
    check({d: session.BUILD_COUNTS[k] for d, k in keys.items()}
          == serving_builds, "kfac refresh: a serving program was rebuilt")
    rec["refresh_builds_first_call"] = first_builds
    again = "serve after refresh"
    rec["serve_after_refresh"], launches[again], _ = counted(
        lambda: serve_banks(again))
    need(launches[again], ["trmm"], f"kfac {again}")
    rec["profile_refresh"] = profile_calls(
        lambda i: kfac.refresh_banks(banks, manifest, state),
        "kfac refresh_banks", 1, unit="refresh", warm=0, cpu=False)
    mark("refreshed")

    # ROADMAP A14: a replace_run of u slots against u single replaces of
    # the same factors, in the order-2048 bank (warm: each updater is
    # built by its first call, outside the timing)
    bank = banks[2048]
    cs = torch.stack([damped(tag) for tag in manifest[2048][:4]])
    rec["replace_run"] = {}
    for u in (2, 4):
        calls = bank.updates_dispatched
        bank.replace_run(0, cs[:u])
        check(bank.updates_dispatched == calls + 1,
              f"kfac: a replace_run of {u} took "
              f"{bank.updates_dispatched - calls} updater calls")
        for j in range(u):
            bank.replace(j, cs[j])
        run_ms = host_ms(lambda: bank.replace_run(0, cs[:u]), 5)
        single_ms = host_ms(lambda: [bank.replace(j, cs[j])
                                     for j in range(u)], 5)
        rec["replace_run"][f"u={u}"] = dict(
            run_ms=run_ms, singles_ms=single_ms, ratio=run_ms / single_ms)
    del bank, cs, banks
    gc.collect()
    torch.cuda.empty_cache()
    mark("replace_run")

    # the fleet: the planner's buckets, one wave, one refresh
    with b1_inputs("fleet banking"):
        (fleet, handles), launches["fleet banking"], \
            rec["fleet_banking_ms"] = counted(
                lambda: kfac.factor_banks_from_state(
                    state_banked, grid=grid, fleet=True))
    del state_banked
    rec["fleet_plan"] = [[b.n, list(b.orders), b.capacity, b.method, b.n0]
                         for b in fleet.plan.buckets]

    def fleet_refresh_and_wave():
        t = time.perf_counter()
        kfac.refresh_banks(fleet, handles, state)
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t) * 1e3
        Bs = {key: torch.zeros((fleet.solver(key).width, key[0], PANEL_K),
                               device=device) for key in fleet.buckets}
        for h in handles.values():
            Bs[h.bucket][h.slot, :h.order] = torch.randn(
                (h.order, PANEL_K), generator=g, device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        Xs = {key: fleet.solver(key).solve(B) for key, B in Bs.items()}
        torch.cuda.synchronize()
        wave_ms = (time.perf_counter() - t) * 1e3
        worst = 0.0
        for tag, h in handles.items():
            x = Xs[h.bucket][h.slot].double()
            b = Bs[h.bucket][h.slot].double()
            check(not x[h.order:].any(), f"kfac fleet {tag}: padded tail "
                                         f"not zero")
            worst = max(worst, fro_rel(damped(tag).double() @ x[:h.order]
                                       - b[:h.order], b[:h.order]))
        check(worst <= RELRES_BOUND["fp32"], f"kfac fleet: worst relres "
                                             f"{worst}")
        return dict(refresh_ms=refresh_ms, wave_ms=wave_ms,
                    worst_relres=worst)

    rec["fleet"], launches["fleet refresh + wave"], _ = counted(
        fleet_refresh_and_wave)
    need(launches["fleet banking"], ["tri_inv_blocks_valid"],
         "kfac fleet banking")
    need(launches["fleet refresh + wave"], ["trmm"], "kfac fleet wave")
    mark("fleet")
    # B1 (B5) against the plain version on the stacks the path gave it;
    # these launches come after every count was read
    rec["b1_vs_plain"] = b1_inputs.check()
    mark("b1 vs plain")
    rec["launches"] = launches
    print(json.dumps({"kfac": rec}), flush=True)
    del fleet, handles, params, state
    return launches, rec


def dist_cases(p1: int, p2: int, n: int) -> list:
    """Phase 12's cases on one grid: (label, kind, dtype, options,
    profiled).  Every grid: "inv" at n0 = n/8 (m = 8: p | m, the
    all-to-all phase 1) in fp64 and fp32, at n0 = n/2 (m = 2 < p: the
    cooperative doubling) and with the all-gather phase 1, and "rec" at
    its default n0; (2, 2) also ``core.trsm`` upper and transposed, the
    3D product and the inversion.  On (2, 2) the first "inv" and the
    "rec" case run once more under the profiler (its start and stop
    take ~5 s a case, so the other grids run none)."""
    a, b = n // 8, n // 2
    prof = (p1, p2) == (2, 2)
    cases = [(f"inv float64 n0={a}", "inv", "float64", dict(n0=a), prof),
             (f"inv float32 n0={a}", "inv", "float32", dict(n0=a), False),
             (f"inv float64 n0={b}", "inv", "float64", dict(n0=b), False),
             ("inv float64 allgather", "inv", "float64",
              dict(n0=a, mode="allgather"), False),
             ("rec float64", "rec", "float64", dict(n0=None), prof)]
    if (p1, p2) == (2, 2):
        cases += [("trsm upper float64", "inv", "float64",
                   dict(n0=a, lower=False), False),
                  ("trsm transposed float64", "inv", "float64",
                   dict(n0=a, transpose=True), False),
                  ("mm3d float64", "mm3d", "float64", {}, False),
                  ("invert float32", "invert", "float32", {}, False)]
    return cases


def dist_inputs(n: int, k: int, seed: int):
    """The natural L = tril(randn) + n I and B = randn (n, k), fp64, the
    same in every rank (one numpy seed)."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n)))
    L[np.diag_indices(n)] += n
    return torch.from_numpy(L), torch.from_numpy(rng.standard_normal((n, k)))


def dist_device_ms(run) -> dict:
    """One more run of ``run`` under the profiler: device ms by kernel
    (the top 6), the sums of the kernels' and of the copies' (the
    staging's host <-> device memcpys), the wall ms and the device's busy
    share (kernels and copies) and kernel share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.key[:50], e.count))
    rows.sort(reverse=True)
    copies = sum(r[0] for r in rows if r[1].startswith(("Memcpy", "Memset")))
    kernels = sum(r[0] for r in rows) - copies
    return dict(kernel_ms=kernels, copy_ms=copies, wall_ms=wall,
                busy_share=(kernels + copies) / wall,
                kernel_share=kernels / wall, top=[list(r) for r in rows[:6]])


def dist_rank(grid, n: int, k: int, seed: int) -> dict:
    """One rank's part of phase 12 on ``grid``: every case through the
    entry point a user calls, each with the kernel counts set to 0 just
    before and read just after, its cost trace, its staged bytes and its
    host-clock seconds (collectives staged through the host); the
    profiled cases once more under the profiler.  Every rank holds B1,
    B2 and B3 to their plain versions on the inputs the case handed
    them in this rank (``DistKernelInputs``).  Rank 0 holds each result
    to its bound and to the p = 1 run of the same inputs on the card.
    Returns {label: record}."""
    import torch.distributed as dist
    from repro_torch import core
    from repro_torch.core import comm, cost_model, mm3d, tri_inv
    from repro_torch.core import grid as gridlib
    t_enter = time.time()
    t_in = time.perf_counter()
    L64, B64 = dist_inputs(n, k, seed)
    p1, p2, rank = grid.p1, grid.p2, grid.mesh.rank
    dev = grid.device
    one = gridlib.make_trsm_mesh(1, 1, device=dev) if rank == 0 else None
    out = {"setup": dict(inputs_s=time.perf_counter() - t_in, checks_s=0.0,
                         profile_s=0.0, enter=t_enter)}
    for label, kind, dtype, opt, profiled in dist_cases(p1, p2, n):
        dt = getattr(torch, dtype)
        L, B = L64.to(dt), B64.to(dt)
        lower, transpose = opt.get("lower", True), opt.get("transpose", False)
        A = L if lower else L.T

        def run():
            if kind == "mm3d":
                return mm3d.matmul(L, B, grid)
            if kind == "invert":
                return tri_inv.invert(L, grid)
            return core.trsm(A, B, grid, method=kind, n0=opt["n0"],
                             mode=opt.get("mode"), lower=lower,
                             transpose=transpose)
        staged0 = grid.mesh.staged_bytes
        torch.cuda.synchronize()
        dist.barrier()                 # every rank starts the case at once
        kept = DistKernelInputs()
        reset_counts()
        t0 = time.perf_counter()
        with kept, comm.trace() as t:
            res = run()
        torch.cuda.synchronize()
        rec = dict(seconds=time.perf_counter() - t0, launches=read_counts(),
                   staged_bytes=grid.mesh.staged_bytes - staged0,
                   cost=dict(t.summary(), by_op=t.by_op()))
        what = f"phase 12 {p1}x{p1}x{p2} rank {rank} {label}"
        for name, used in (("tri_inv_blocks", kind in ("inv", "invert")),
                           ("trmm", kind == "inv"),
                           ("trsm_substitution", kind == "rec")):
            check(not used or rec["launches"][name] > 0,
                  f"{what}: {name} launched 0 times")
        tc = time.perf_counter()
        rec["vs_plain"] = kept.check(what, rec["launches"])
        kept.kept.clear()
        out["setup"]["checks_s"] += time.perf_counter() - tc
        if profiled:
            tp = time.perf_counter()
            rec["profile"] = dist_device_ms(run)
            out["setup"]["profile_s"] += time.perf_counter() - tp
        if rank == 0:
            tc = time.perf_counter()
            rec.update(dist_check(one, kind, dtype, opt, res, L, B, A, label,
                                  f"{p1}x{p1}x{p2}"))
            out["setup"]["checks_s"] += time.perf_counter() - tc
            if kind == "mm3d":
                c = cost_model.mm_cost(n, k, grid.p, p1, p2)
                rec["mm_cost"] = dict(s=c.s, w=c.w, f=c.f)
                check((rec["cost"]["s"], rec["cost"]["w"]) == (c.s, c.w),
                      f"phase 12 mm3d: traced S, W {rec['cost']} differ "
                      f"from mm_cost's {c}")
        out[label] = rec
        del res
    t13 = time.perf_counter()
    out["front"] = front_rank(grid, L64, one)          # phase 13
    out["setup"]["front_s"] = time.perf_counter() - t13
    out["setup"]["exit"] = time.time()
    return out


def dist_check(one, kind, dtype, opt, res, L, B, A, label, gname) -> dict:
    """Rank 0's checks of one phase-12 result (fp64 on the card)."""
    from repro_torch import core
    from repro_torch.core import tri_inv
    dev = one.device
    if kind == "mm3d":
        want = L.to(dev, torch.float64) @ B.to(dev, torch.float64)
        err = ((res.to(dev) - want).abs().max() / want.abs().max()).item()
        check(err <= DIST_MM3D_TOL, f"phase 12 {gname} {label}: max rel "
                                    f"diff from torch.matmul {err}")
        return dict(rel_err_vs_matmul=err)
    if kind == "invert":
        L64 = L.to(dev, torch.float64)
        eye = torch.eye(L.shape[0], dtype=torch.float64, device=dev)
        res64 = res.to(dev, torch.float64)
        r = (torch.linalg.norm(L64 @ res64 - eye) / torch.linalg.norm(eye)
             ).item()
        Llib = torch.linalg.solve_triangular(L.to(dev), eye.to(L.dtype),
                                             upper=False).double()
        r_lib = (torch.linalg.norm(L64 @ Llib - eye)
                 / torch.linalg.norm(eye)).item()
        want = tri_inv.invert(L.to(dev), one).double()
        agree = ((res64 - want).abs().max() / want.abs().max()).item()
        check(r <= 10 * r_lib, f"phase 12 {gname} {label}: ||L Li - I|| {r} "
                               f"> 10x the library's {r_lib}")
        check(agree <= DIST_AGREE[dtype], f"phase 12 {gname} {label}: "
                                          f"{agree} from the p = 1 inverse")
        return dict(residual=r, library_residual=r_lib, vs_p1=agree)
    lower, transpose = opt.get("lower", True), opt.get("transpose", False)
    A64 = A.to(dev, torch.float64)
    op = A64.T if transpose else A64
    X = res.to(dev, torch.float64)
    B64 = B.to(dev, torch.float64)
    relres = (torch.linalg.norm(op @ X - B64) / torch.linalg.norm(B64)).item()
    X1 = core.trsm(A.to(dev), B.to(dev), one, method=kind, n0=opt["n0"],
                   mode=opt.get("mode"), lower=lower,
                   transpose=transpose).double()
    agree = ((X - X1).abs().max() / X1.abs().max()).item()
    check(relres <= DIST_RELRES[dtype], f"phase 12 {gname} {label}: relres "
                                        f"{relres} > {DIST_RELRES[dtype]}")
    check(agree <= DIST_AGREE[dtype], f"phase 12 {gname} {label}: {agree} "
                                      f"from the p = 1 solve")
    return dict(relres=relres, vs_p1=agree)


# kernel-against-plain bounds on phase 12's kept inputs: fp64 as the
# earlier slices' fp64 checks; fp32 as kernel_phase's at each kernel
DIST_VS_PLAIN = {"tri_inv_blocks": {"float64": 1e-10, "float32": 1e-4},
                 "trmm": {"float64": 1e-10, "float32": 2e-5},
                 "trsm_substitution": {"float64": 1e-10, "float32": 1e-4,
                                       "bfloat16": 1e-4}}


class DistKernelInputs:
    """Keeps, while entered, the last inputs of each (kernel, shapes,
    dtype) that reach B1's, B2's and B3's wrappers through
    ``kernels.ops`` (as the distributed solvers call them; B5 and B6 are
    their gated calls), and passes every call through unchanged (the
    counts stay the wrappers').  ``check`` then holds each kernel
    against its plain version on each kept input, after the case's
    counts were read, and ``times`` times it there."""

    def __init__(self):
        self.kept = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = {name: getattr(ops, name) for name in DIST_VS_PLAIN}

        def keeper(name, fn):
            def keep(*args, **kw):
                key = (name, tuple(tuple(a.shape) for a in args
                                   if torch.is_tensor(a))
                       + tuple(tuple(v.shape) for v in kw.values()
                               if torch.is_tensor(v)),
                       str(args[0].dtype).removeprefix("torch."))
                self.kept[key] = (
                    [a.clone() if torch.is_tensor(a) else a for a in args],
                    {kk: v.clone() if torch.is_tensor(v) else v
                     for kk, v in kw.items()})
                return fn(*args, **kw)
            return keep
        for name, fn in self.saved.items():
            setattr(ops, name, keeper(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    @staticmethod
    def gated_name(name: str, args, kw) -> str:
        """The kernel a kept call launched: B5 (``tri_inv_blocks`` with
        a mask, passed second) and B6 (``trsm_substitution`` with
        ``valid=``) under their own names."""
        gated = (kw.get("valid") is not None
                 or (name == "tri_inv_blocks" and len(args) > 1
                     and args[1] is not None))
        return f"{name}_valid" if gated else name

    def check(self, what: str, launches: dict) -> list:
        """Each kept input through the kernel and its plain version; a
        kernel that launched in the case, gated (B5, B6) or not, must
        have had an input kept.  The inputs stay kept (:meth:`times`
        drops them)."""
        from repro_torch.kernels import tri_inv_block, trmm, trsm_block
        pairs = dict(
            tri_inv_blocks=(tri_inv_block.tri_inv_blocks,
                            tri_inv_block.tri_inv_blocks_plain),
            trmm=(trmm.trmm, trmm.trmm_plain),
            trsm_substitution=(trsm_block.trsm_substitution,
                               trsm_block.trsm_substitution_plain))
        seen = {self.gated_name(key[0], *val)
                for key, val in self.kept.items()}
        for name in DIST_VS_PLAIN:
            for counted in (name, f"{name}_valid"):
                check(launches.get(counted, 0) == 0 or counted in seen,
                      f"{what}: {counted} launched but no input was kept")
        out = []
        for (name, shapes, dtype), (args, kw) in self.kept.items():
            kernel, plain = pairs[name]
            if name == "trmm":
                check(kw.get("block_mask") is None,
                      f"{what}: trmm called with a block mask (B4)")
                plain_kw = {}
            else:
                plain_kw = kw
            got, want = kernel(*args, **kw), plain(*args, **plain_kw)
            abs_err, rel_err = errors(got, want)
            tol = DIST_VS_PLAIN[name][dtype]
            row = dict(kernel=self.gated_name(name, args, kw),
                       shapes=[list(sh) for sh in shapes],
                       dtype=dtype, max_abs_err=abs_err,
                       max_rel_err=rel_err, tol=tol)
            check(rel_err <= tol, f"{what}: {name} {shapes} {dtype} against "
                                  f"its plain version: {rel_err} of its "
                                  f"largest entry > {tol}")
            if name == "tri_inv_blocks":
                row["lower_rel_err"] = lower_rel_error(got, want)
                check(row["lower_rel_err"] <= tol,
                      f"{what}: {name} {shapes} {dtype}: strictly lower "
                      f"part off by {row['lower_rel_err']} of its max > "
                      f"{tol}")
            out.append(row)
        return out

    def times(self, timer) -> list:
        """Each kept input's kernel time (``Timer.ms``: median of 5
        launches, each after an L2 flush), then the inputs are
        dropped; run while no other rank uses the card."""
        from repro_torch.kernels import ops
        out = []
        for (name, shapes, dtype), (args, kw) in self.kept.items():
            fn = getattr(ops, name)
            out.append(dict(kernel=self.gated_name(name, args, kw),
                            shapes=[list(sh) for sh in shapes], dtype=dtype,
                            ms=timer.ms(lambda: fn(*args, **kw), reps=5,
                                        warm=1)))
        self.kept.clear()
        return out


def front_cases(p1: int, p2: int) -> list:
    """Phase 13's cases on one grid: (label, kind, options).  (2, 2):
    ``Solver.from_factor`` "inv" in the three presets and "rec"
    bf16_refine; a C = 4 "inv" bf16_refine capacity bank's lifecycle
    with a padded admission (B5); an upper padded bank (the reversed
    mask); a "rec" fp32 capacity bank with 2 of 4 slots live (B6).
    (2, 1) and (1, 4): the padded "inv" bank and the "rec" dead lanes.
    Every case at n0 = 1024 (m = 8: the all-to-all phase 1)."""
    padded = ("capacity inv bf16_refine padded", "padded",
              dict(method="inv", precision="bf16_refine", lower=True))
    dead = ("capacity rec fp32 dead lanes", "dead",
            dict(method="rec", precision="fp32"))
    if (p1, p2) != (2, 2):
        return [padded, dead]
    return [(f"{m} {pre}", "solver", dict(method=m, precision=pre))
            for m, pre in (("inv", "bf16_refine"), ("inv", "fp32"),
                           ("inv", "fp64_refine"), ("rec", "bf16_refine"))] \
        + [("capacity inv bf16_refine lifecycle", "lifecycle",
            dict(method="inv", precision="bf16_refine")), padded,
           ("capacity inv bf16_refine upper padded", "padded",
            dict(method="inv", precision="bf16_refine", lower=False)),
           dead]


def front_factor(L64, j: int, order: int | None = None,
                 dtype=torch.float32):
    """Factor j of phase 13: phase 12's L (tril(randn) + n I from a numpy
    seed, the same on every rank), its leading order x order block, at
    ``dtype``, the diagonal raised by 512 j so each j is another
    factor."""
    L = L64[:order, :order].to(dtype, copy=True)
    if j:
        L.diagonal().add_(512.0 * j)
    return L


class FrontCase:
    """One rank's run of one phase-13 case: the calls a user makes, each
    solve's host-clock seconds to a synchronize (the collectives staged
    through the host) and staged bytes, the solve program's builds, and,
    in rank 0, every request's X and the factor it was solved against
    (kept for the checks after the counts were read)."""

    def __init__(self, grid, opt):
        self.grid, self.opt = grid, opt
        self.rank0 = grid.mesh.rank == 0
        self.solves = []              # (seconds, staged bytes)
        self.requests = []            # rank 0: (label, A, B, X, pad d)
        self.sums = []                # sum of every X: the same everywhere
        self.bits = []                # rank 0: padded vs unpadded pairs
        self.key = None

    def solve(self, solver, B, label, held=()):
        """Solve B (numpy) through ``solver``; ``held`` per slot: (A,
        padded order d or None) or None for a dead slot."""
        mesh = self.grid.mesh
        Bt = torch.as_tensor(B).to(self.grid.device, solver.dtype)
        staged0 = mesh.staged_bytes
        torch.cuda.synchronize()
        t = time.perf_counter()
        X = solver.solve(Bt)
        torch.cuda.synchronize()
        self.solves.append((time.perf_counter() - t,
                            mesh.staged_bytes - staged0))
        self.sums.append(float(X.double().sum()))
        if self.rank0:
            for s, h in enumerate(held):
                self.requests.append((f"{label} slot {s}", h, B[s],
                                      X[s].cpu()))
        return B, X

    def built(self, solver) -> int:
        from repro_torch.core import session
        return session.BUILD_COUNTS[solver.program_for(FRONT_K).key]


def front_rhs(rng, C: int, live: dict, n: int, dt) -> np.ndarray:
    """(C, n, k) right-hand sides: randn for every live slot (its first
    d rows for a slot padded from order d), zeros for a dead one."""
    B = np.zeros((C, n, FRONT_K), dt)
    for s, d in live.items():
        B[s, :d or n] = rng.standard_normal((d or n, FRONT_K))
    return B


def front_solver_case(api, case, L64, rng):
    """``Solver.from_factor`` at the preset, then 3 steady solves."""
    o, n = case.opt, L64.shape[0]
    dt = torch.float64 if o["precision"] == "fp64_refine" else torch.float32
    A = front_factor(L64, 0, dtype=dt)
    solver = api.Solver.from_factor(A, case.grid, method=o["method"],
                                    n0=FRONT_N0, precision=o["precision"])
    npdt = np.float64 if dt == torch.float64 else np.float32
    for i in range(1 + FRONT_STEADY):
        B = rng.standard_normal((1, n, FRONT_K)).astype(npdt)
        case.solve(solver, B, f"solve {i}", [(A, None)])
        if i == 0:
            case.key = case.built(solver)
    case.steady = case.built(solver) == case.key


def front_lifecycle_case(api, case, L64, rng):
    """A C = 4 capacity bank: two admits, a padded admission of an order
    n/2 factor (B5), 3 steady waves; replace, a replace_run of 2, evict,
    a wave; re-admit, a wave.  The solve program is built once over all
    of it."""
    o, n = case.opt, L64.shape[0]
    d = n // 2
    bank = api.FactorBank(case.grid, n, method=o["method"], n0=FRONT_N0,
                          precision=o["precision"], capacity=FRONT_C)
    solver = api.Solver.from_bank(bank)
    held = [None] * FRONT_C
    j = iter(range(1, 100))

    def admit(order=None, slot=None):
        A = front_factor(L64, next(j), order)
        if slot is not None:
            bank.replace(slot, A)
        else:
            slot = bank.admit(A, pad_to=n if order else None)
        held[slot] = (A, order)
        return slot

    def wave(label):
        live = {s: held[s][1] for s in bank.live_slots()}
        B = front_rhs(rng, FRONT_C, live, n, np.float32)
        return case.solve(solver, B, label,
                          [held[s] if s in live else None
                           for s in range(FRONT_C)])

    case.width = FRONT_C

    admit()
    admit()
    pad_slot = admit(order=d)
    for i in range(1 + FRONT_STEADY):
        B, X = wave(f"wave {i}")
        if i == 0:
            case.key = case.built(solver)
            first = (pad_slot, held[pad_slot][0], X[pad_slot].cpu(),
                     B[pad_slot])
    admit(slot=1)
    run = torch.stack([front_factor(L64, next(j)) for _ in range(2)])
    bank.replace_run(0, run)
    held[0], held[1] = (run[0], None), (run[1], None)
    bank.evict(1)
    held[1] = None
    wave("after replace, replace_run, evict")
    admit()
    wave("after re-admit")
    case.steady = case.built(solver) == case.key
    case.padded = [first]


def front_padded_case(api, case, L64, rng, C: int = 2):
    """A C = 2 capacity bank: one admit and one padded admission of an
    order n/2 factor (B5), lower or upper (the reversed mask), then 3
    steady waves."""
    o, n = case.opt, L64.shape[0]
    d = n // 2
    lower = o["lower"]
    bank = api.FactorBank(case.grid, n, method=o["method"], n0=FRONT_N0,
                          precision=o["precision"], capacity=C,
                          lower=lower)
    solver = api.Solver.from_bank(bank)
    case.width = C
    held = [None] * C
    for s, order in enumerate((None, d)):
        L = front_factor(L64, s + 1, order)
        A = L if lower else L.T
        held[bank.admit(A, pad_to=n if order else None)] = (A, order)
    for i in range(1 + FRONT_STEADY):
        B = front_rhs(rng, C, {s: h[1] for s, h in enumerate(held)}, n,
                      np.float32)
        B, X = case.solve(solver, B, f"wave {i}", held)
        if i == 0:
            case.key = case.built(solver)
            first = (1, held[1][0], X[1].cpu(), B[1])
    case.steady = case.built(solver) == case.key
    case.padded = [first]


def front_dead_case(api, case, L64, rng):
    """A "rec" C = 4 capacity bank with slots 0-1 live and 2-3 never
    admitted: B6 gates the dead lanes, which solve to exact zeros."""
    o, n = case.opt, L64.shape[0]
    bank = api.FactorBank(case.grid, n, method=o["method"], n0=FRONT_N0,
                          precision=o["precision"], capacity=FRONT_C)
    solver = api.Solver.from_bank(bank)
    held = [None] * FRONT_C
    for _ in range(2):
        A = front_factor(L64, bank.size + 1)
        held[bank.admit(A)] = (A, None)
    for i in range(1 + FRONT_STEADY):
        B = front_rhs(rng, FRONT_C, {0: None, 1: None}, n, np.float32)
        case.solve(solver, B, f"wave {i}", held)
        if i == 0:
            case.key = case.built(solver)
    case.steady = case.built(solver) == case.key


def front_checks(api, case, one, label, gname) -> dict:
    """Rank 0's checks of one phase-13 case, in fp64 on the card: every
    request's relres against the factor its slot held (its leading d
    rows for a padded slot, whose tail must be exactly zero), every dead
    lane exactly zero, the X of each request against the p = 1 solve of
    the same factor, preset and B, and a padded slot's leading block
    bit-equal to the unpadded p > 1 solve of the same factor (an order
    n/2 bank of the same width, its phase 1 the all-gather's B1).  Each
    p = 1 solve is held to the preset's bound as well."""
    o, dev = case.opt, one.device
    bound = FRONT_RELRES[o["precision"]]
    what = f"phase 13 {gname} {label}"
    worst, worst_p1, p1_solves, on_card = 0.0, 0.0, {}, {}
    for req, h, B, X in case.requests:
        if h is None:
            check(not torch.any(X), f"{what} {req}: a dead lane is not zero")
            continue
        A, d = h
        d = d or A.shape[0]
        if d < X.shape[0]:
            check(not torch.any(X[d:]), f"{what} {req}: the padded tail "
                                        f"is not zero")
        if id(A) not in on_card:
            on_card.clear()                  # one factor on the card at once
            on_card[id(A)] = A.to(dev, torch.float64)
        A64, X64 = on_card[id(A)], X[:d].to(dev, torch.float64)
        B64 = torch.as_tensor(B[:d], device=dev, dtype=torch.float64)
        rel = (torch.linalg.norm(A64 @ X64 - B64)
               / torch.linalg.norm(B64)).item()
        check(rel <= bound, f"{what} {req}: relres {rel} > {bound}")
        worst = max(worst, rel)
        # the p = 1 solve of the first request against each factor
        key = id(A)
        if key not in p1_solves:
            s1 = api.Solver.from_factor(
                A, one, method=o["method"], n0=FRONT_N0,
                precision=o["precision"], lower=o.get("lower", True))
            X1 = s1.solve(torch.as_tensor(B[:d], device=dev,
                                          dtype=s1.dtype)).double()
            # the p = 1 solve is served at the preset's bound too (for
            # fp64_refine at n = 8192, ROADMAP C's open contract)
            rel1 = (torch.linalg.norm(A64 @ X1 - B64)
                    / torch.linalg.norm(B64)).item()
            check(rel1 <= bound, f"{what} {req}: the p = 1 solve's relres "
                                 f"{rel1} > {bound}")
            gap = ((X64 - X1).abs().max() / X1.abs().max()).item()
            check(gap <= FRONT_AGREE[o["precision"]],
                  f"{what} {req}: {gap} from the p = 1 solve")
            worst_p1 = max(worst_p1, gap)
            p1_solves[key] = rel1
    out = dict(relres=worst, vs_p1=worst_p1, requests=len(case.requests),
               p1_solves=len(p1_solves),
               relres_p1=max(p1_solves.values(), default=0.0))
    return out


def front_padded_bits(api, case) -> list:
    """Every rank: each padded slot's first wave against an unpadded
    p > 1 bank of order n/2 and the same width, lower flag and preset
    (phase 1 on the all-gather: B1 on the same blocks B5 inverted),
    solving the same leading rows: the leading block must be bit-equal
    (``FactorBank.admit(pad_to=)``'s contract)."""
    o = case.opt
    rows = []
    for slot, A, Xpad, Bpad in getattr(case, "padded", []):
        d, C = A.shape[0], case.width
        small = api.FactorBank(case.grid, d, method=o["method"], n0=FRONT_N0,
                               precision=o["precision"], capacity=C,
                               mode="allgather",
                               lower=o.get("lower", True))
        small.admit(A)
        B = np.zeros((C, d, FRONT_K), np.float32)
        B[0] = Bpad[:d]
        X = api.Solver.from_bank(small).solve(torch.as_tensor(
            B, device=case.grid.device))[0].cpu()
        bit = torch.equal(Xpad[:d], X)
        rows.append(dict(slot=slot, order=d, bit_equal=bit))
        check(bit, f"phase 13 rank {case.grid.mesh.rank}: padded slot "
                   f"{slot}'s leading block differs from the unpadded "
                   f"p > 1 solve")
    return rows


FRONT_RUNNERS = {"solver": front_solver_case,
                 "lifecycle": front_lifecycle_case,
                 "padded": front_padded_case, "dead": front_dead_case}


def front_rank(grid, L64, one) -> dict:
    """One rank's part of phase 13 on ``grid`` (after phase 12, in the
    same ranks): every case through the front door a user calls, the
    kernel counts set to 0 just before it and read just after, its cost
    trace, host-staged seconds and staged bytes per solve, the sum of
    every X (the same in every rank); then, after the counts were read,
    B1, B2, B3, B5 and B6 against their plain versions on the inputs
    the case handed them, each padded slot against the unpadded p > 1
    solve, and in rank 0 every request's relres and its gap to the
    p = 1 solve.  Returns {label: record}."""
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import comm
    p1, p2, rank = grid.p1, grid.p2, grid.mesh.rank
    gname = f"{p1}x{p1}x{p2}"
    timer = Timer(grid.device) if rank == 0 else None
    out = {}
    for label, kind, opt in front_cases(p1, p2):
        rng = np.random.default_rng(FRONT_SEED)
        case = FrontCase(grid, opt)
        torch.cuda.synchronize()
        dist.barrier()                 # every rank starts the case at once
        kept = DistKernelInputs()
        reset_counts()
        t0 = time.perf_counter()
        with kept, comm.trace() as t:
            FRONT_RUNNERS[kind](api, case, L64, rng)
        torch.cuda.synchronize()
        launches = read_counts()
        rec = dict(seconds=time.perf_counter() - t0, launches=launches,
                   solve_s=[sv[0] for sv in case.solves],
                   staged_bytes=[sv[1] for sv in case.solves],
                   x_sums=case.sums, steady=case.steady,
                   cost=dict(t.summary(), by_op=t.by_op(),
                             residual=t.part("residual").summary()))
        what = f"phase 13 {gname} rank {rank} {label}"
        check(case.steady, f"{what}: the solve program was rebuilt")
        for name, used in (
                ("tri_inv_blocks", opt["method"] == "inv"),
                ("trmm", opt["method"] == "inv"),
                ("trsm_substitution", kind == "solver"
                 and opt["method"] == "rec"),
                ("tri_inv_blocks_valid", kind in ("lifecycle", "padded")),
                ("trsm_substitution_valid", kind == "dead")):
            check(not used or launches[name] > 0,
                  f"{what}: {name} launched 0 times")
        tc = time.perf_counter()
        rec["vs_plain"] = kept.check(what, launches)
        # rank 0 times the kernels at this case's inputs while the other
        # ranks wait: a card shared by p ranks at once times contention
        dist.barrier()
        rec["kernel_ms"] = kept.times(timer) if rank == 0 else []
        kept.kept.clear()
        dist.barrier()
        rec["padded_bits"] = front_padded_bits(api, case)
        if rank == 0:
            rec.update(front_checks(api, case, one, label, gname))
        rec["checks_s"] = time.perf_counter() - tc
        out[label] = rec
        del case
        gc.collect()
        torch.cuda.empty_cache()
    return out


FRONT_KERNELS = ("tri_inv_blocks", "trmm", "trsm_substitution",
                 "tri_inv_blocks_valid", "trsm_substitution_valid")


def front_report(ranks, gname: str, totals) -> None:
    """Phase 13's lines for one grid: per case the host-staged ms per
    solve, staged bytes per solve and launches in every rank, each
    kernel's ms at the case's inputs (rank 0's, the card to itself),
    relres, the gap to p = 1
    and the padded bits; the cost traces and every X the same in every
    rank; then every kernel the grid ran held against its plain
    version (B1, B2, B5 and B6 everywhere, B3 on (2, 2))."""
    held = {}
    for label, rec in ranks[0]["front"].items():
        recs = [r["front"][label] for r in ranks]
        check(all(r["cost"] == rec["cost"] for r in recs),
              f"phase 13 {gname} {label}: cost traces differ across ranks")
        check(all(r["x_sums"] == rec["x_sums"] for r in recs),
              f"phase 13 {gname} {label}: X differs across ranks")
        for r in recs:
            totals.update(r["launches"])
        kernel_ms = {}
        for r in recs:
            for v in r["vs_plain"]:
                a = held.setdefault(v["kernel"], dict(
                    inputs=0, worst_rel_err=0.0, shapes=[]))
                a["inputs"] += 1
                a["worst_rel_err"] = max(a["worst_rel_err"], v["max_rel_err"])
                if v["shapes"] not in a["shapes"]:
                    a["shapes"].append(v["shapes"])
        for v in rec["kernel_ms"]:
            kernel_ms.setdefault(v["kernel"], []).append(
                dict(shapes=v["shapes"], dtype=v["dtype"], ms=v["ms"]))
        row = dict(
            grid=gname, case=label,
            host_staged_ms_per_solve=[
                float(np.median(r["solve_s"])) * 1e3 for r in recs],
            staged_bytes_per_solve=[
                int(np.median(r["staged_bytes"])) for r in recs],
            solves=len(rec["solve_s"]), case_seconds=[r["seconds"]
                                                      for r in recs],
            launches_per_rank=[{k: v for k, v in r["launches"].items() if v}
                               for r in recs],
            kernel_ms_rank0=kernel_ms,
            cost=dict(s=rec["cost"]["s"], w=rec["cost"]["w"],
                      f=rec["cost"]["f"], residual=rec["cost"]["residual"]),
            padded_bits=rec["padded_bits"],
            **{k: rec[k] for k in ("relres", "relres_p1", "vs_p1",
                                   "requests", "p1_solves")})
        print(json.dumps({"front_case": row}), flush=True)
    want = FRONT_KERNELS if gname == "2x2x2" else tuple(
        k for k in FRONT_KERNELS if k != "trsm_substitution")
    for name in want:
        check(name in held, f"phase 13 {gname}: {name} was held against its "
                            f"plain version on no input")
    print(json.dumps({"front_kernels": dict(
        grid=gname, note="each kernel against its plain version on the "
                         "inputs phase 13's cases handed it, every rank",
        **held)}), flush=True)


def distributed_phase(card: str) -> dict:
    """Phases 12 and 13: It-Inv, rec, the one-shot ``core.trsm``, the 3D
    product and the inversion, then the front door (``front_rank``), at
    n = 8192 on the (2, 2), (2, 1) and (1, 4) grids: one spawn of p
    ranks each, serving both phases (spawn start method: this process holds a
    CUDA context), gloo, every rank on cuda:0 with its own context.  NCCL
    refuses two ranks on one GPU, so every collective goes through host
    memory (staged) while every kernel launch runs on the card: this
    checks the algorithms and their kernels, not an interconnect.  Any
    rank's failure fails the phase.  Returns {kernel: launches}, summed
    over ranks, grids, cases and both phases."""
    from repro_torch.core import selfcheck
    t0 = time.perf_counter()
    print(json.dumps(dict(distributed=dict(
        backend="gloo", device="cuda:0", card=card,
        note="the ranks of each grid share one card; collectives are "
             "staged through host memory, kernels run on the card; NCCL "
             "(one GPU per rank) is not exercised"))), flush=True)
    totals = collections.Counter()
    t13 = 0.0
    for p1, p2 in DIST_GRIDS:
        tg, t_spawn = time.perf_counter(), time.time()
        ranks = selfcheck.spawn(p1, p2, "cuda:0", dist_rank, N, DIST_K,
                                DIST_SEED)
        t_joined = time.time()
        gname = f"{p1}x{p1}x{p2}"
        vs_plain = {}     # kernel -> inputs checked, worst error, dtypes, shapes
        for label, rec in ranks[0].items():
            if label == "setup":
                setup = rec
                continue
            if label == "front":
                continue
            costs = [r[label]["cost"] for r in ranks]
            check(all(c == costs[0] for c in costs),
                  f"phase 12 {gname} {label}: cost traces differ across "
                  f"ranks")
            for r in ranks:
                totals.update(r[label]["launches"])
            row = dict(grid=gname, case=label,
                       host_staged_seconds=[r[label]["seconds"]
                                            for r in ranks],
                       staged_bytes_per_rank=[r[label]["staged_bytes"]
                                              for r in ranks],
                       launches_per_rank=[{kk: v for kk, v in
                                           r[label]["launches"].items() if v}
                                          for r in ranks],
                       cost=dict(s=rec["cost"]["s"], w=rec["cost"]["w"],
                                 f=rec["cost"]["f"]),
                       **{kk: rec[kk] for kk in ("relres", "vs_p1",
                                                 "rel_err_vs_matmul",
                                                 "residual",
                                                 "library_residual",
                                                 "mm_cost") if kk in rec})
            case_vs = {}
            for r in ranks:
                for v in r[label]["vs_plain"]:
                    for acc in (case_vs, vs_plain):
                        a = acc.setdefault(v["kernel"], dict(
                            inputs=0, worst_rel_err=0.0, dtypes=[],
                            shapes=[]))
                        a["inputs"] += 1
                        a["worst_rel_err"] = max(a["worst_rel_err"],
                                                 v["max_rel_err"])
                        if v["dtype"] not in a["dtypes"]:
                            a["dtypes"].append(v["dtype"])
                        if v["shapes"] not in a["shapes"]:
                            a["shapes"].append(v["shapes"])
            row["vs_plain"] = case_vs
            if "profile" in rec:
                for key in ("kernel_ms", "copy_ms", "wall_ms", "busy_share",
                            "kernel_share"):
                    row[f"{key}_per_rank"] = [r[label]["profile"][key]
                                              for r in ranks]
                row["top_rank0"] = rec["profile"]["top"]
            print(json.dumps({"distributed_case": row}), flush=True)
        for name in DIST_VS_PLAIN:
            check(name in vs_plain, f"phase 12 {gname}: {name} was held "
                                    f"against its plain version on no input")
        print(json.dumps({"distributed_kernels": dict(
            grid=gname, note="each kernel against its plain version on the "
                             "inputs the grid's cases handed it, every rank",
            **vs_plain)}), flush=True)
        print(json.dumps(dict(
            distributed_grid=gname, ranks=len(ranks),
            seconds=time.perf_counter() - tg,
            spawn_to_ranks_s=max(r["setup"]["enter"] for r in ranks)
            - t_spawn,
            ranks_to_join_s=t_joined - max(r["setup"]["exit"]
                                           for r in ranks),
            rank0_inputs_s=setup["inputs_s"],
            rank0_checks_s=setup["checks_s"],
            rank0_profile_s=setup["profile_s"],
            phase13_s_per_rank=[r["setup"]["front_s"] for r in ranks])),
            flush=True)
        t13 += max(r["setup"]["front_s"] for r in ranks)
        front_report(ranks, gname, totals)
    print(json.dumps(dict(phase12_s=time.perf_counter() - t0 - t13,
                          phase13_s=t13)), flush=True)
    return dict(totals)


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
    main_launches["traffic"], _ = traffic_phase(api, seed=130)  # phase 10
    check(main_launches["traffic"]["trmm"] > 0,
          "trmm never launched on the traffic path")
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    grid = api.make_trsm_mesh(1, 1)
    producers_phase(api, grid, seed=140)                      # phase 11
    gc.collect()
    torch.cuda.empty_cache()
    kfac_phase(api, grid, seed=150)
    print(json.dumps(dict(phase11_s=time.perf_counter() - t11)), flush=True)
    del grid
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = distributed_phase(card)               # phases 12-13

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
        check(name == "trmm_masked" or dist_launches.get(name, 0) > 0,
              f"{name} never launched at p > 1 (phases 12-13)")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=rec["max_abs_err"],
                            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
                            bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"],
                            library_ms=rec["library_ms"],
                            launches_distributed=dist_launches.get(name, 0)))
    print(json.dumps(dict(elapsed_s=time.perf_counter() - t_start)))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
