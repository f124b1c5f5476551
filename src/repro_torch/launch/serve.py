"""Serving CLI: TRSM solve requests against resident factors.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm \
        --n 8192 --panel-k 16 --requests 64 [--n0 4096] \
        [--method inv|rec|auto] \
        [--precision fp32|bf16|bf16_refine|fp64_refine] [--cache-stats] \
        [--structure dense|banded[:BW]|block-sparse] [--device cuda:0|cpu]

    # M resident factors (a FactorBank), every wave one solve over all M
    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm-bank \
        --bank 16 --n 256 --panel-k 16 --requests 256 [--method inv|rec]

    # a capacity-allocated live-mutable bank, warmed up empty, started at
    # half occupancy; between waves a slot is replaced in place and every
    # third update evicts a slot and re-admits into it, while the one
    # program keyed on the capacity keeps serving (DESIGN.md Sec. 11)
    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm-churn \
        --bank 16 --n 256 --panel-k 16 --requests 256 --updates 32 \
        [--method inv|rec] [--precision bf16_refine]

    # a mixed-order multi-tenant fleet: the planner buckets the order
    # spectrum [n, n/2, n/4], two tenants' factors land in the planned
    # buckets (padded where merged), requests route by (tenant, order),
    # a factor is refreshed in place after every wave and every third
    # update a third tenant's burst reclaims the coldest slot across
    # tenants (DESIGN.md Sec. 12)
    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm-fleet \
        --n 256 --panel-k 16 --requests 96 --updates 12 \
        [--precision bf16_refine] [--fleet-stats] [--cache-stats]

Factors are L = tril(randn) + n I from seeded device generators;
requests have random widths 1..panel_k.  ``--method rec`` serves
through the recursive baseline (its base cases on the substitution
kernel), ``auto`` lets the cost model choose at k = panel_k.  ``--structure`` declares a
block structure; admission masks the factor to it, so the solves are
against the masked operator.  Prints requests served, panels (waves)
and ms per panel (wave); ``trsm-churn`` also ms per update and the
program builds during the churn (0 and 0 in the steady state).  On a
"rec" churn bank every base case runs the validity-gated substitution
kernel (B6), which solves the empty and evicted lanes to zeros.
``trsm-fleet`` prints the plan's bucket table and requests, bucket-waves,
refreshes, reclaims and the program builds during the run (0 in the
steady state), and with ``--fleet-stats`` the fleet's stats table.
The other workloads of ``repro.launch.serve`` are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# workload -> the ROADMAP item that ports it
_NOT_PORTED = {"lm": "A15", "trsm-traffic": "A10"}


def _print_cache_stats():
    from repro_torch import api
    st = api.default_cache().stats()
    print(f"compiled-solver cache: size={st['size']} hits={st['hits']} "
          f"misses={st['misses']} evictions={st['evictions']} "
          f"hit_rate={st['hit_rate']:.3f}")


def serve_trsm(args):
    """Serve TRSM solve requests against a device-resident factor."""
    from repro_torch import api
    grid = api.make_trsm_mesh(1, 1, device=args.device)
    rng = np.random.default_rng(0)
    n = args.n
    gen = torch.Generator(device=grid.device).manual_seed(0)
    L = torch.randn((n, n), generator=gen, device=grid.device,
                    dtype=torch.float64).tril_()
    L.diagonal().add_(n)
    if args.precision != "fp64_refine":
        L = L.float()
    structure = api.FactorStructure.parse(args.structure, n=n) \
        if args.structure else None
    solver = api.Solver.from_factor(L, grid, method=args.method,
                                    n0=args.n0, precision=args.precision,
                                    k_hint=args.panel_k,
                                    structure=structure)
    server = api.SolveServer(solver, args.panel_k).warmup()
    widths = rng.integers(1, args.panel_k + 1, args.requests)
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    t0 = time.perf_counter()
    for w in widths:
        server.submit(torch.randn((n, int(w)), generator=gen,
                                  device=grid.device))
    server.drain()
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    dt = time.perf_counter() - t0
    panels = server.panels_solved
    policy = solver.policy
    print(f"served {server.requests_served} solve requests "
          f"({int(widths.sum())} columns) in {panels} panels, "
          f"{dt:.3f}s ({dt / max(panels, 1) * 1e3:.2f} ms/panel) "
          f"on {grid.device} n={n} "
          f"n0={solver.spec_for(args.panel_k).n0} "
          f"method={solver.method} precision={policy.name} "
          f"structure={args.structure or 'dense'} "
          f"({policy.describe()})")
    if args.cache_stats:
        _print_cache_stats()


def _factor_maker(n: int, args, device):
    """fresh() -> a new L = tril(randn) + n I on ``device`` (fp64 for
    fp64_refine, else fp32), from one seeded generator."""
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = torch.float64 if args.precision == "fp64_refine" \
        else torch.float32

    def fresh():
        L = torch.randn((n, n), generator=gen, device=device,
                        dtype=dtype).tril_()
        L.diagonal().add_(n)
        return L

    return fresh, gen


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_trsm_bank(args):
    """Serve solve requests against a bank of M resident factors: one
    solve per wave covers every factor."""
    from repro_torch import api
    grid = api.make_trsm_mesh(1, 1, device=args.device)
    rng = np.random.default_rng(0)
    n, M = args.n, args.bank
    fresh, gen = _factor_maker(n, args, grid.device)
    solver = api.Solver.from_factors(torch.stack([fresh() for _ in range(M)]),
                                     grid, method=args.method, n0=args.n0,
                                     precision=args.precision)
    server = api.SolveServer(solver, args.panel_k).warmup()
    widths = rng.integers(1, args.panel_k + 1, args.requests)
    _sync(grid.device)
    t0 = time.perf_counter()
    for i, w in enumerate(widths):
        server.submit(torch.randn((n, int(w)), generator=gen,
                                  device=grid.device), int(i % M))
    server.drain()
    _sync(grid.device)
    dt = time.perf_counter() - t0
    waves = server.waves_solved
    policy = solver.policy
    print(f"served {server.requests_served} solve requests "
          f"({int(widths.sum())} columns) against {M} factors in "
          f"{waves} waves (one solve per wave, {M} factors each), "
          f"{dt:.3f}s ({dt / max(waves, 1) * 1e3:.2f} ms/wave, "
          f"{dt / max(waves * M, 1) * 1e3:.3f} ms/factor solve) on "
          f"{grid.device} n={n} n0={solver.spec_for(args.panel_k).n0} "
          f"method={solver.method} precision={policy.name} "
          f"({policy.describe()})")
    if args.cache_stats:
        _print_cache_stats()


def serve_trsm_churn(args):
    """Serve against a capacity-allocated live-mutable bank while its
    factors churn: a replace between waves and, every third update, an
    evict followed by a re-admit into the same (lowest free) slot; one
    program (keyed on the capacity) and one updater throughout."""
    from repro_torch import api
    from repro_torch.core import session
    grid = api.make_trsm_mesh(1, 1, device=args.device)
    rng = np.random.default_rng(0)
    n, C = args.n, args.bank
    fresh, gen = _factor_maker(n, args, grid.device)
    bank = api.FactorBank(grid, n, method=args.method, n0=args.n0,
                          precision=args.precision, capacity=C)
    solver = api.Solver.from_bank(bank)
    server = api.SolveServer(solver, args.panel_k).warmup()   # EMPTY
    for _ in range(max(C // 2, 1)):          # start at half occupancy
        bank.admit(fresh())
    key = solver.spec_for(args.panel_k)
    uspec = bank.update_spec()
    builds0 = (session.BUILD_COUNTS[key], session.BUILD_COUNTS[uspec])

    widths = rng.integers(1, args.panel_k + 1, args.requests)
    per_wave = max(args.requests // max(args.updates, 1), 1)
    replaced = evicted = 0
    t_update = 0.0
    _sync(grid.device)
    t0 = time.perf_counter()
    for i, w in enumerate(widths):
        live = bank.live_slots()
        server.submit(torch.randn((n, int(w)), generator=gen,
                                  device=grid.device),
                      int(live[i % len(live)]))
        if (i + 1) % per_wave == 0:
            server.drain()
            _sync(grid.device)
            live = bank.live_slots()
            tu = time.perf_counter()
            bank.replace(int(live[replaced % len(live)]), fresh())
            replaced += 1
            if replaced % 3 == 0:
                victim = int(live[evicted % len(live)])
                bank.evict(victim)
                slot = bank.admit(fresh())
                if slot != victim:         # lowest-free-slot reuse
                    raise AssertionError((slot, victim))
                evicted += 1
            _sync(grid.device)
            t_update += time.perf_counter() - tu
    server.drain()
    _sync(grid.device)
    dt_total = time.perf_counter() - t0
    rebuilt = (session.BUILD_COUNTS[key] - builds0[0],
               session.BUILD_COUNTS[uspec] - builds0[1])
    updates = replaced + evicted       # one updater call per replace and
    policy = solver.policy             # per re-admit (evict is a flag)
    print(f"served {server.requests_served} solve requests in "
          f"{server.waves_solved} waves against a capacity-{C} bank "
          f"(occupancy {bank.size}) with {updates} in-place updates "
          f"({replaced} replaces, {evicted} evict+readmit), "
          f"{dt_total:.3f}s total, "
          f"{t_update / max(updates, 1) * 1e3:.2f} ms/update; "
          f"rebuilds solve={rebuilt[0]} update={rebuilt[1]} "
          f"(steady state: 0/0) on {grid.device} n={n} "
          f"n0={key.n0} method={solver.method} precision={policy.name}")
    if args.cache_stats:
        _print_cache_stats()


def serve_trsm_fleet(args):
    """Mixed-order multi-tenant serving through the fleet tier: the
    planner buckets the order spectrum, two tenants' factors land in
    the planned buckets, requests route by (tenant, order), churn
    refreshes factors in place, and over-subscribed buckets reclaim
    their coldest slot across tenants (DESIGN.md Sec. 12)."""
    from repro_torch import api
    from repro_torch.core import session
    grid = api.make_trsm_mesh(1, 1, device=args.device)
    rng = np.random.default_rng(0)
    n = args.n
    orders = [n, n // 2, n // 4]        # the tenants' order spectrum
    makers = {d: _factor_maker(d, args, grid.device)[0] for d in orders}
    gen = torch.Generator(device=grid.device).manual_seed(1)
    # two tenants, two factors per order each
    manifest = {d: 4 for d in orders}
    plan = api.plan_fleet(manifest, grid, k=args.panel_k,
                          precision=args.precision)
    print(plan.table())
    fleet = api.SolverFleet(grid, plan)
    handles = {}
    for tenant in ("tenant-a", "tenant-b"):
        for d in orders:
            for j in range(2):
                tag = f"layer{orders.index(d)}-{j}"
                handles[(tenant, tag)] = fleet.admit(
                    makers[d](), tenant=tenant, tag=tag)
    server = api.SolveServer(fleet, args.panel_k).warmup()
    keys = [fleet.solver(key).spec_for(args.panel_k)
            for key in fleet.buckets]
    builds0 = sum(session.BUILD_COUNTS[k] for k in keys)

    widths = rng.integers(1, args.panel_k + 1, args.requests)
    per_wave = max(args.requests // max(args.updates, 1), 1)
    names = list(handles)
    replaced = reclaimed = 0
    _sync(grid.device)
    t0 = time.perf_counter()
    for i, w in enumerate(widths):
        tenant, tag = names[i % len(names)]
        h = handles[(tenant, tag)]
        server.submit(torch.randn((h.order, int(w)), generator=gen,
                                  device=grid.device),
                      tenant=tenant, tag=tag)
        if (i + 1) % per_wave == 0:
            server.drain()
            # churn between waves: refresh one factor in place; every
            # third update over-subscribes a bucket so the fleet
            # reclaims its coldest slot across tenants
            tenant, tag = names[replaced % len(names)]
            h = handles[(tenant, tag)]
            fleet.replace(h, makers[h.order]())
            replaced += 1
            if replaced % 3 == 0:
                d = orders[reclaimed % len(orders)]
                hot = fleet.admit(makers[d](), tenant="tenant-c",
                                  tag=f"burst{reclaimed}")
                reclaimed += 1
                # drop the handles the reclaim made stale
                live = set(map(id, fleet.handles()))
                handles = {kt: hh for kt, hh in handles.items()
                           if id(hh) in live}
                handles[("tenant-c", hot.tag)] = hot
                names = list(handles)
    server.drain()
    _sync(grid.device)
    dt_total = time.perf_counter() - t0
    rebuilt = sum(session.BUILD_COUNTS[k] for k in keys) - builds0
    st = fleet.stats()
    print(f"served {server.requests_served} mixed-order requests "
          f"({len(orders)} orders, {len(fleet.buckets)} planned "
          f"bucket(s)) in {server.waves_solved} bucket-waves, "
          f"{dt_total:.3f}s; {replaced} in-place refreshes, "
          f"{st['reclaims']} cross-tenant reclaims; rebuilds solve="
          f"{rebuilt} (steady state: 0) on {grid.device} n={n} "
          f"precision={plan.buckets[0].policy.name}")
    if args.fleet_stats:
        print(fleet.format_stats())
    if args.cache_stats:
        _print_cache_stats()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="trsm",
                    choices=["trsm", "trsm-bank", "trsm-churn",
                             "trsm-fleet", *_NOT_PORTED])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--n0", type=int, default=None)
    ap.add_argument("--panel-k", type=int, default=16)
    ap.add_argument("--method", default="inv",
                    choices=["inv", "rec", "auto"],
                    help="It-Inv-TRSM, the recursive baseline, or the "
                         "cost model's choice")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--bank", type=int, default=16,
                    help="factors (trsm-bank) or capacity (trsm-churn)")
    ap.add_argument("--updates", type=int, default=32,
                    help="in-place updates between waves (trsm-churn)")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "bf16_refine", "fp64_refine"],
                    help="mixed-precision policy of the solve pipeline")
    ap.add_argument("--structure", default=None,
                    metavar="dense|banded[:BW]|block-sparse",
                    help="factor block structure for the trsm workload "
                         "(level-scheduled sweep; DESIGN.md Sec. 14)")
    ap.add_argument("--fleet-stats", action="store_true",
                    help="print fleet-wide serving stats (per-bucket "
                         "occupancy, admits, reclaims, hit rate) after "
                         "the drain (trsm-fleet workload)")
    ap.add_argument("--cache-stats", action="store_true",
                    help="print compiled-solver cache stats after the "
                         "drain")
    ap.add_argument("--device", default=None,
                    help="device of the 1 x 1 x 1 grid (default cuda:0)")
    args = ap.parse_args(argv)
    if args.workload in _NOT_PORTED:
        ap.error(f"workload {args.workload!r} is not ported yet (ROADMAP "
                 f"{_NOT_PORTED[args.workload]})")
    if args.workload != "trsm" and args.method == "auto":
        ap.error("a bank takes --method inv or rec (auto depends on k)")
    {"trsm": serve_trsm, "trsm-bank": serve_trsm_bank,
     "trsm-churn": serve_trsm_churn,
     "trsm-fleet": serve_trsm_fleet}[args.workload](args)


if __name__ == "__main__":
    main()
