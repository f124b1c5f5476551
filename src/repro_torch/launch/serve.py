"""Serving CLI: TRSM solve requests against resident factors.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm \
        --n 8192 --panel-k 16 --requests 64 [--n0 4096] \
        [--method inv|rec|auto] [--p1 2 --p2 1] [--overlap auto|on|off] \
        [--precision fp32|bf16|bf16_refine|fp64_refine] [--cache-stats] \
        [--structure dense|banded[:BW]|block-sparse] [--device cuda:0|cpu]

    # M resident factors (a FactorBank), every wave one solve over all M
    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm-bank \
        --bank 16 --n 256 --panel-k 16 --requests 256 [--method inv|rec] \
        [--map-mode vmap|scan]

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

    # open-loop serving: Poisson arrivals at --rate against the async
    # tier's background drain loop (min(--bank, 4) resident factors),
    # tail latency against --slo-ms, bounded queues; --admission slo sheds
    # requests whose estimated wait cannot meet the SLO, --autoscale
    # serves a two-order fleet with the Autoscaler attached (DESIGN.md
    # Secs. 13, 15)
    PYTHONPATH=src python -m repro_torch.launch.serve --workload trsm-traffic \
        --n 8192 --rate 500 --requests 512 --slo-ms 50 --queue-depth 128 \
        [--admission depth|slo] [--autoscale] [--stats-json]

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
``trsm-traffic`` prints the reference's summary line (served of
offered, goodput, waves, p50/p99 against the SLO, violations, sheds at
depth and at admission), the autoscaler's replans, and with
``--stats-json`` one JSON line of server, admission and autoscaler
stats.

    # the LM: prefill + greedy decode of random prompts on a mesh of the
    # world's ranks (this process, or torchrun's world)
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
        --arch qwen3-1.7b [--smoke] --batch 4 --prompt-len 32 \
        --new-tokens 16 [--mesh debug|single|multi] [--device cpu]

``lm`` takes every decoder-only arch (dense, MoE, RG-LRU, xLSTM),
random weights from seed 0 and prompts from a seeded NumPy generator
(embeddings for ``embed_inputs`` archs), and prints each sequence's
first 12 tokens and the tokens per second, through
``train.serve_step.jit_decode_step`` on ``--mesh`` (``serve_lm``).  It
refuses whisper-tiny,
as the reference's CLI cannot serve it either (its enc-dec decode
takes the encoder states, which the workload has no input for; ROADMAP
C): the encoder-decoder serves through
``train.serve_step.make_decode_fn``.

Every trsm workload runs on a p1 x p1 x p2 grid (``--p1``/``--p2``,
default 1 x 1 x 1).  With p = p1^2 p2 > 1 the CLI joins the world a
launcher started (torchrun: ``WORLD_SIZE`` and ``RANK`` in the
environment; NCCL where each rank has a card of its own, gloo where
ranks share one), or else starts its own p ranks (the spawn start
method, a file rendezvous, gloo, every rank on ``--device``).  Every
rank makes the same factors and requests and makes each call alike
(the synchronous servers and the fleet are SPMD); ``trsm-traffic``
serves from rank 0, which draws the arrivals and right-hand sides,
while the other ranks follow its stream (``AsyncSolveServer.follow``).
Rank 0 prints the summary lines.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import time

import numpy as np
import torch


def _print_cache_stats():
    from repro_torch import api
    st = api.default_cache().stats()
    print(f"compiled-solver cache: size={st['size']} hits={st['hits']} "
          f"misses={st['misses']} evictions={st['evictions']} "
          f"hit_rate={st['hit_rate']:.3f}")


def _on(grid) -> str:
    return f"grid p1={grid.p1} p2={grid.p2} ({grid.device})"


def serve_trsm(args, grid):
    """Serve TRSM solve requests against a device-resident factor."""
    from repro_torch import api
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
                                    structure=structure,
                                    overlap=args.overlap)
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
          f"on {_on(grid)} n={n} "
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


def serve_trsm_bank(args, grid):
    """Serve solve requests against a bank of M resident factors: one
    solve per wave covers every factor."""
    from repro_torch import api
    rng = np.random.default_rng(0)
    n, M = args.n, args.bank
    fresh, gen = _factor_maker(n, args, grid.device)
    solver = api.Solver.from_factors(torch.stack([fresh() for _ in range(M)]),
                                     grid, method=args.method, n0=args.n0,
                                     precision=args.precision,
                                     map_mode=args.map_mode,
                                     overlap=args.overlap)
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
          f"{_on(grid)} n={n} n0={solver.spec_for(args.panel_k).n0} "
          f"map_mode={solver.bank.map_mode} "
          f"method={solver.method} precision={policy.name} "
          f"({policy.describe()})")
    if args.cache_stats:
        _print_cache_stats()


def serve_trsm_churn(args, grid):
    """Serve against a capacity-allocated live-mutable bank while its
    factors churn: a replace between waves and, every third update, an
    evict followed by a re-admit into the same (lowest free) slot; one
    program (keyed on the capacity) and one updater throughout."""
    from repro_torch import api
    from repro_torch.core import session
    rng = np.random.default_rng(0)
    n, C = args.n, args.bank
    fresh, gen = _factor_maker(n, args, grid.device)
    bank = api.FactorBank(grid, n, method=args.method, n0=args.n0,
                          precision=args.precision, capacity=C,
                          map_mode=args.map_mode, overlap=args.overlap)
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
          f"(steady state: 0/0) on {_on(grid)} n={n} "
          f"n0={key.n0} method={solver.method} precision={policy.name}")
    if args.cache_stats:
        _print_cache_stats()


def serve_trsm_fleet(args, grid):
    """Mixed-order multi-tenant serving through the fleet tier: the
    planner buckets the order spectrum, two tenants' factors land in
    the planned buckets, requests route by (tenant, order), churn
    refreshes factors in place, and over-subscribed buckets reclaim
    their coldest slot across tenants (DESIGN.md Sec. 12)."""
    from repro_torch import api
    from repro_torch.core import session
    rng = np.random.default_rng(0)
    n = args.n
    orders = [n, n // 2, n // 4]        # the tenants' order spectrum
    makers = {d: _factor_maker(d, args, grid.device)[0] for d in orders}
    gen = torch.Generator(device=grid.device).manual_seed(1)
    # two tenants, two factors per order each
    manifest = {d: 4 for d in orders}
    plan = api.plan_fleet(manifest, grid, k=args.panel_k,
                          precision=args.precision, overlap=args.overlap)
    print(plan.table())
    fleet = api.SolverFleet(grid, plan, map_mode=args.map_mode)
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
          f"{rebuilt} (steady state: 0) on {_on(grid)} n={n} "
          f"precision={plan.buckets[0].policy.name}")
    if args.fleet_stats:
        print(fleet.format_stats())
    if args.cache_stats:
        _print_cache_stats()


def serve_trsm_traffic(args, grid):
    """Open-loop async serving: Poisson arrivals against the
    background drain loop, futures resolved as waves finalize, tail
    latency reported against the --slo-ms objective.

    ``--admission slo`` runs the SLO-aware admission controller
    (requests whose estimated queue wait cannot meet --slo-ms are shed
    at submit with DeadlineUnmeetable, surfaced through the future);
    ``--autoscale`` serves a mixed-order FLEET instead of a flat bank
    and attaches the planner-driven Autoscaler (DESIGN.md Sec. 15).
    At p > 1 rank 0 serves the traffic and the other ranks follow."""
    import json

    from repro_torch import api
    leads = grid.p == 1 or grid.mesh.rank == 0
    rng = np.random.default_rng(0)
    n, M = args.n, min(args.bank, 4)
    admission = api.AdmissionController(slo_ms=args.slo_ms) \
        if args.admission == "slo" else None
    gen = torch.Generator(device=grid.device).manual_seed(1)
    if args.autoscale:
        # mixed-order fleet: half the factors at n, half at n // 2 —
        # the spectrum the autoscaler splits/merges under load drift
        orders = [n] * max(M // 2, 1) + [n // 2] * max(M // 2, 1)
        makers = {d: _factor_maker(d, args, grid.device)[0]
                  for d in set(orders)}
        manifest = {}
        for d in orders:
            manifest[d] = manifest.get(d, 0) + 1
        plan = api.plan_fleet(manifest, grid, k=args.panel_k,
                              precision=args.precision,
                              overlap=args.overlap)
        fleet = api.SolverFleet(grid, plan, map_mode=args.map_mode)
        tags = []
        for j, d in enumerate(orders):
            tag = f"f{j}"
            fleet.admit(makers[d](), tenant="traffic", tag=tag)
            tags.append((tag, d))
        server = api.AsyncSolveServer(
            fleet, args.panel_k, queue_depth=args.queue_depth,
            slo_ms=args.slo_ms).warmup()
        scaler = api.Autoscaler(server) if leads else None
        policy = fleet.solver(next(iter(fleet.buckets))).policy
    else:
        fresh, _ = _factor_maker(n, args, grid.device)
        solver = api.Solver.from_factors(
            torch.stack([fresh() for _ in range(M)]), grid,
            method=args.method, n0=args.n0, precision=args.precision,
            map_mode=args.map_mode, overlap=args.overlap)
        server = api.AsyncSolveServer(
            solver, args.panel_k, queue_depth=args.queue_depth,
            slo_ms=args.slo_ms).warmup()
        scaler = None
        policy = solver.policy
    if not leads:
        server.follow()               # until rank 0's stop()
        return
    width = max(args.panel_k // 4, 1)
    dtype = torch.float64 if args.precision == "fp64_refine" \
        else torch.float32
    pools = {d: [torch.randn((d, width), generator=gen,
                             device=grid.device, dtype=dtype)
                 for _ in range(32)]
             for d in ({n, n // 2} if args.autoscale else {n})}

    def sub(i):
        if args.autoscale:
            tag, order = tags[i % len(tags)]
            return server.submit(pools[order][i % 32],
                                 tenant="traffic", tag=tag)
        return server.submit(pools[n][i % 32], factor=i % M)

    # prime every wave composition before the clock starts: lazy
    # first builds belong to startup, not to the measured traffic
    per_wave = M * max(args.panel_k // width, 1)
    for count in range(1, per_wave + 1):
        for i in range(count):
            sub(i)
        while server.pending() or server._inflight:
            server.step()
        server.flush()
    # admission goes live only now: priming builds must not feed the
    # controller's service estimates
    server.reset_service_ewma()
    if admission is not None:
        server.set_admission(admission)
    _sync(grid.device)
    gaps = rng.exponential(1.0 / args.rate, size=args.requests)
    shed = 0
    futs = []
    t0 = time.monotonic()
    sched = t0 + np.cumsum(gaps)
    with server:                       # background drain loop
        for i, t_i in enumerate(sched):
            delay = t_i - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                futs.append((t_i, sub(i)))
            except api.Overloaded:
                shed += 1              # depth shed (raised at submit)
        served, deadline_shed = [], 0
        for t_i, f in futs:
            try:
                f.result(timeout=120)
                served.append((t_i, f))
            except api.DeadlineUnmeetable:
                deadline_shed += 1     # SLO shed (through the future)
    elapsed = time.monotonic() - t0
    lat = np.asarray([f.completed for _, f in served]) \
        - np.asarray([t for t, _ in served])
    violations = int((lat * 1e3 > args.slo_ms).sum())

    def pct(q):
        return f"{np.percentile(lat, q) * 1e3:.2f}" if len(lat) \
            else "n/a"
    print(f"served {len(served)}/{args.requests} open-loop requests "
          f"(offered {args.rate:.0f} rps, goodput "
          f"{len(served) / elapsed:.0f} rps) in "
          f"{server.stats()['waves']} waves; p50 "
          f"{pct(50)} ms p99 "
          f"{pct(99)} ms vs SLO "
          f"{args.slo_ms:.0f} ms ({violations} violations); "
          f"shed {shed} at depth {args.queue_depth} + "
          f"{deadline_shed} at admission ({args.admission}) on "
          f"{_on(grid)} n={n} precision={policy.name}")
    if scaler is not None:
        print(f"autoscaler: {len(scaler.replans)} replan(s) "
              + "".join(f"[{r['kind']}: {r['moved']} moved] "
                        for r in scaler.replans)
              + f"buckets now "
                f"{sorted(k[0] for k in server.fleet.buckets)}")
    if args.stats_json:
        st = server.stats()
        if scaler is not None:
            st["autoscaler"] = scaler.stats()
        if admission is not None:
            st["admission"] = admission.stats()
        print(json.dumps(st, default=str, sort_keys=True))
    if args.cache_stats:
        _print_cache_stats()


def serve_lm(ap, args):
    """Prefill + greedy decode of ``--batch`` random prompts through
    ``serve_step.jit_decode_step`` on a mesh of the world's ranks (as
    ``launch.train`` builds it: the launcher's world under torchrun,
    else this process; ``--mesh debug|single|multi``).  Each rank
    decodes its rows of the batch and holds its pieces of the
    parameters and caches; rank 0 prints."""
    from repro_torch import configs
    from repro_torch.core import world
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import lm
    from repro_torch.models import sharding
    from repro_torch.train import serve_step as ss
    if not args.arch:
        ap.error("--arch is required for the lm workload")
    if args.p1 * args.p1 * args.p2 != 1:
        ap.error("the lm workload runs on --mesh, not on a TRSM grid "
                 "(--p1 1 --p2 1)")
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    if cfg.enc_dec:
        ap.error(f"--arch {args.arch} is an encoder-decoder: the lm workload "
                 f"serves decoder-only archs, and the reference's CLI fails "
                 f"on it too (its decode step takes the encoder states; "
                 f"ROADMAP C); serve it through "
                 f"repro_torch.train.serve_step.make_decode_fn")
    if torch.device(args.device or "cuda").type == "cuda" \
            and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    device = torch.device(world.join_world(args.device) if world.launched()
                          else args.device or "cuda")
    try:
        mesh = meshlib.from_flag(args.mesh)
    except RuntimeError as e:
        ap.error(f"--mesh {args.mesh}: {e}")

    B = args.batch
    max_seq = args.prompt_len + args.new_tokens
    params = lm.init(cfg, 0, device=device)
    cache = lm.init_cache(cfg, B, max_seq, device=device)
    decode = ss.jit_decode_step(cfg, mesh, params, cache, B)
    ps, cs = ss.serve_shardings(cfg, mesh, params, cache)
    rows = ss.rows(mesh, B)
    params, cache = sharding.shard(params, ps), sharding.shard(cache, cs)

    rng = np.random.default_rng(0)
    prompts = sharding.piece(torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, args.prompt_len)), device=device),
        rows)
    extra = []
    if cfg.embed_inputs:
        # stub frontend: one embedding a position, prompt and decode
        extra = [sharding.piece(torch.as_tensor(rng.standard_normal(
            (B, max_seq, cfg.d_model), np.float32), device=device), rows)]

    def at(t, k):
        return [e[:, t:t + k] for e in extra]

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    # prefill IS a decode step with S = prompt length (same code path)
    logits, cache = decode(params, cache, prompts, *at(0, args.prompt_len))
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for t in range(args.new_tokens - 1):
        logits, cache = decode(params, cache, tok,
                               *at(args.prompt_len + t, 1))
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    gen = sharding.whole(torch.cat(out, dim=1), rows).cpu().numpy()
    dt = time.time() - t0
    if mesh.rank == 0:
        for b in range(B):
            print(f"seq {b}: {gen[b, :12].tolist()}")
        print(f"{B * args.new_tokens} tokens in {dt:.2f}s "
              f"({B * args.new_tokens / dt:.1f} tok/s) on {device}, mesh "
              f"{mesh.shape}")


WORKLOADS = {"trsm": serve_trsm, "trsm-bank": serve_trsm_bank,
             "trsm-churn": serve_trsm_churn, "trsm-fleet": serve_trsm_fleet,
             "trsm-traffic": serve_trsm_traffic}


def _serve_rank(grid, args):
    """A spawned rank's run of the workload: rank 0 returns what it
    printed, the other ranks' output is dropped."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        WORKLOADS[args.workload](args, grid)
    return out.getvalue() if grid.mesh.rank == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="trsm",
                    choices=["lm", "trsm", "trsm-bank", "trsm-churn",
                             "trsm-fleet", "trsm-traffic"])
    ap.add_argument("--arch", help="the lm workload's model "
                                   "(repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (lm)")
    ap.add_argument("--mesh", default="debug",
                    choices=["single", "multi", "debug"],
                    help="lm: the mesh of the world's ranks; 'debug' "
                         "fits any world, 'single'/'multi' need 256/512 "
                         "ranks")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts decoded together (lm)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--n0", type=int, default=None)
    ap.add_argument("--panel-k", type=int, default=16)
    ap.add_argument("--method", default="inv",
                    choices=["inv", "rec", "auto"],
                    help="It-Inv-TRSM, the recursive baseline, or the "
                         "cost model's choice")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--bank", type=int, default=16,
                    help="factors (trsm-bank; trsm-traffic serves "
                         "min(bank, 4)) or capacity (trsm-churn)")
    ap.add_argument("--updates", type=int, default=32,
                    help="in-place updates between waves (trsm-churn)")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "bf16_refine", "fp64_refine"],
                    help="mixed-precision policy of the solve pipeline")
    ap.add_argument("--structure", default=None,
                    metavar="dense|banded[:BW]|block-sparse",
                    help="factor block structure for the trsm workload "
                         "(level-scheduled sweep; DESIGN.md Sec. 14)")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="offered Poisson arrival rate in req/s "
                         "(trsm-traffic)")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="latency objective: completions slower than "
                         "this count as SLO violations (trsm-traffic)")
    ap.add_argument("--queue-depth", type=int, default=128,
                    help="per-slot bounded queue depth; submits beyond "
                         "it are shed with Overloaded (trsm-traffic)")
    ap.add_argument("--admission", default="depth",
                    choices=["depth", "slo"],
                    help="admission policy for trsm-traffic: 'depth' "
                         "sheds only on full queues; 'slo' also sheds "
                         "requests whose estimated queue wait cannot "
                         "meet --slo-ms (DeadlineUnmeetable through "
                         "the future; DESIGN.md Sec. 15)")
    ap.add_argument("--autoscale", action="store_true",
                    help="serve a mixed-order fleet with the "
                         "planner-driven Autoscaler attached: bucket "
                         "splits/merges follow offered-load drift "
                         "(trsm-traffic; DESIGN.md Sec. 15)")
    ap.add_argument("--stats-json", action="store_true",
                    help="dump one machine-readable JSON line of "
                         "server (+ admission/autoscaler) stats after "
                         "the run (trsm-traffic)")
    ap.add_argument("--fleet-stats", action="store_true",
                    help="print fleet-wide serving stats (per-bucket "
                         "occupancy, admits, reclaims, hit rate) after "
                         "the drain (trsm-fleet workload)")
    ap.add_argument("--cache-stats", action="store_true",
                    help="print compiled-solver cache stats after the "
                         "drain")
    ap.add_argument("--p1", type=int, default=1,
                    help="the grid's p1 (p = p1 * p1 * p2 ranks)")
    ap.add_argument("--p2", type=int, default=1,
                    help="the grid's p2")
    ap.add_argument("--overlap", default="auto",
                    choices=["auto", "on", "off"],
                    help="software-pipeline the steady-state sweep "
                         "(prefetch the next panel's collectives under "
                         "this panel's compute; bit-identical results; "
                         "DESIGN.md Sec. 16)")
    ap.add_argument("--map-mode", default="vmap",
                    choices=["vmap", "scan"],
                    help="how the bank program maps the factor axis")
    ap.add_argument("--device", default=None,
                    help="every rank's device (default cuda:0; cuda:<local "
                         "rank> under a launcher with a card per rank)")
    args = ap.parse_args(argv)
    if args.workload == "lm":
        return serve_lm(ap, args)
    if args.workload != "trsm" and args.method == "auto":
        ap.error("a bank takes --method inv or rec (auto depends on k)")
    if args.p1 < 1 or args.p2 < 1:
        ap.error("--p1 and --p2 must be >= 1")
    from repro_torch.core import world
    run = WORKLOADS[args.workload]
    if args.p1 * args.p1 * args.p2 == 1:
        from repro_torch import api
        run(args, api.make_trsm_mesh(1, 1, device=args.device))
    elif world.launched():
        if args.device is None and not torch.cuda.is_available():
            ap.error("no CUDA device: pass --device cpu")
        grid = world.join(args.p1, args.p2, args.device)
        with (contextlib.nullcontext() if grid.mesh.rank == 0
              else contextlib.redirect_stdout(io.StringIO())):
            run(args, grid)
    else:
        device = args.device or "cuda:0"
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            ap.error("no CUDA device: pass --device cpu")
        print(world.spawn(args.p1, args.p2, device, _serve_rank, args)[0],
              end="")


if __name__ == "__main__":
    main()
