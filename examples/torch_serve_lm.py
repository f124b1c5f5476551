"""Serving on the PyTorch port: batched prefill + greedy decode
with KV caches, and the paper's solve workload served three ways.

    PYTHONPATH=src python examples/torch_serve_lm.py               # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu \\
        --arch qwen3-1.7b --batch 2 --prompt-len 8 --new-tokens 4

Prefill is a decode step with S = the prompt's length; the decode loop
replaces finished sequences from a request queue (continuous batching).
The first wave's last logits are held against ``lm.forward`` over the
whole sequence (DECODE_BOUND, relative to their largest entry; the
decode runs in fp32).

The solve workload (``--serve-solves``) serves requests against a
resident factor through a ``SolveServer``; ``--serve-fleet`` serves a
mixed-order spectrum through a planner-bucketed ``SolverFleet``;
``--serve-traffic`` submits open-loop requests to an
``AsyncSolveServer``'s drain loop.  Every answer's relative residual
||L x - b|| / ||b|| must be within SOLVE_BOUND.  Exits 1 on any miss.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm

DECODE_BOUND = 2e-3      # fp32 decode against fp32 forward
SOLVE_BOUND = 1e-5       # the reference's fp32 / bf16_refine bound


def _relres(L, x, b) -> float:
    x = np.asarray(x.detach().cpu().double()).reshape(b.shape)
    return float(np.linalg.norm(L @ x - b) / np.linalg.norm(b))


def serve_lm(args, device) -> bool:
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    if cfg.enc_dec:
        raise SystemExit(f"{cfg.name} is an encoder-decoder: it serves "
                         f"through train.serve_step.make_decode_fn with "
                         f"its encoder states, not this decoder loop")
    if cfg.n_experts:
        # capacity for every token: with less, which tokens a capacity
        # drops depends on how many are routed together, and a decode
        # step routes fewer than the forward
        cfg = dataclasses.replace(cfg, moe_capacity=float(cfg.n_experts))
    params = lm.init(cfg, 0, device=device)
    B, P = args.batch, args.prompt_len
    max_seq = P + args.new_tokens
    f32 = torch.float32

    rng = np.random.default_rng(0)
    queue = [torch.as_tensor(rng.integers(0, cfg.vocab, (1, P)),
                             device=device) for _ in range(args.requests)]
    done, tokens_out, worst = 0, 0, None
    t0 = time.time()
    while done < args.requests:
        wave = queue[done:done + B]
        if len(wave) < B:
            wave += [wave[-1]] * (B - len(wave))
        prompts = torch.cat(wave, dim=0)
        cache = lm.init_cache(cfg, B, max_seq, dtype=f32, device=device)
        logits, cache = lm.decode_step(params, cfg, prompts, cache,
                                       dtype=f32)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        outs = [tok]
        for _ in range(args.new_tokens - 1):
            logits, cache = lm.decode_step(params, cfg, tok, cache,
                                           dtype=f32)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            outs.append(tok)
        gen = torch.cat(outs, dim=1)
        if worst is None:
            # the last step's logits against the whole sequence's forward
            seq = torch.cat([prompts, gen[:, :-1]], dim=1)
            full, _ = lm.forward(params, cfg, seq, dtype=f32)
            want = full[:, -1]
            worst = float((logits[:, -1] - want).abs().max()
                          / want.abs().max())
        n = min(B, args.requests - done)
        for i in range(n):
            print(f"req {done + i}: prompt[:8]="
                  f"{wave[i][0, :8].tolist()} -> "
                  f"gen[:8]={gen[i, :8].tolist()}")
        tokens_out += n * args.new_tokens
        done += n
    dt = time.time() - t0
    print(f"served {args.requests} requests, {tokens_out} tokens in "
          f"{dt:.2f}s ({tokens_out / dt:.1f} tok/s); decode vs forward "
          f"{worst:.2e} (bound {DECODE_BOUND:.0e})")
    return worst <= DECODE_BOUND


def _factor(rng, n):
    return (np.tril(rng.standard_normal((n, n)))
            + n * np.eye(n)).astype(np.float32)


def serve_solves(args, grid) -> bool:
    """Continuous batching for the paper's workload: solve requests
    against a factor held resident on the device."""
    from repro_torch import api

    n = args.solve_n
    rng = np.random.default_rng(1)
    L = _factor(rng, n)
    solver = api.Solver.from_factor(L, grid, method="inv",
                                    precision=args.solve_precision)
    server = api.SolveServer(solver, panel_k=8).warmup()
    bs = [rng.standard_normal((n,)).astype(np.float32)
          for _ in range(args.serve_solves)]
    t0 = time.time()
    for b in bs:
        server.submit(b)
    outs = server.drain()[0]
    worst = max(_relres(L, x, b) for x, b in zip(outs, bs))
    print(f"served {server.requests_served} solve requests (n={n}, "
          f"precision={solver.policy.name}) in {server.panels_solved} "
          f"panels, {time.time() - t0:.3f}s; worst relres {worst:.2e} "
          f"(bound {SOLVE_BOUND:.0e})")
    return worst <= SOLVE_BOUND


def serve_fleet(args, grid) -> bool:
    """The mixed-order tier: a model's whole factor spectrum served
    through planner-chosen buckets, addressed by (tenant, order)."""
    from repro_torch import api

    n = args.solve_n
    orders = [n, n // 2, n // 4]
    plan = api.plan_fleet({d: 1 for d in orders}, grid, k=8)
    print(f"fleet plan: {len(orders)} orders -> "
          f"{len(plan.buckets)} bucket(s)")
    print(plan.table())
    fleet = api.SolverFleet(grid, plan)
    rng = np.random.default_rng(2)
    Ls = {d: _factor(rng, d) for d in orders}
    for d in orders:
        fleet.admit(Ls[d], tenant="lm", tag=d)
    server = api.SolveServer(fleet, panel_k=8).warmup()
    t0, worst = time.time(), 0.0
    for _ in range(args.serve_fleet):
        bs = {d: rng.standard_normal((d,)).astype(np.float32)
              for d in orders}
        for d in orders:
            server.submit(bs[d], tenant="lm", tag=d)
        outs = server.drain()
        for d in orders:
            worst = max(worst, _relres(Ls[d], outs[("lm", d)][-1], bs[d]))
    st = fleet.stats()
    print(f"served {server.requests_served} mixed-order requests "
          f"({orders}) in {server.waves_solved} bucket dispatches, "
          f"{time.time() - t0:.3f}s; fleet hit_rate={st['hit_rate']:.2f}; "
          f"worst relres {worst:.2e} (bound {SOLVE_BOUND:.0e})")
    return worst <= SOLVE_BOUND


def serve_traffic(args, grid) -> bool:
    """Async open-loop serving: submit returns a SolveFuture at once;
    the background drain loop packs fair waves and resolves futures as
    each wave finalizes (DESIGN.md Sec. 13)."""
    from repro_torch import api

    n = args.solve_n
    rng = np.random.default_rng(3)
    L = _factor(rng, n)
    solver = api.Solver.from_factor(L, grid, method="inv",
                                    precision=args.solve_precision)
    server = api.AsyncSolveServer(solver, panel_k=8, queue_depth=64,
                                  slo_ms=100.0).warmup()
    bs = [rng.standard_normal((n,)).astype(np.float32)
          for _ in range(args.serve_traffic)]
    t0 = time.time()
    with server:                          # the background drain loop
        futs = [server.submit(b, tenant=f"user{i % 3}")
                for i, b in enumerate(bs)]
        outs = [f.result(timeout=60) for f in futs]
    st = server.stats()
    worst = max(_relres(L, x, b) for x, b in zip(outs, bs))
    print(f"async-served {st['served']} open-loop requests from "
          f"{min(args.serve_traffic, 3)} tenants in {st['waves']} waves, "
          f"{time.time() - t0:.3f}s; p50 {st['p50_ms']:.2f} ms, p99 "
          f"{st['p99_ms']:.2f} ms, shed {st['shed']}, "
          f"{st['slo_violations']} SLO violations; worst relres "
          f"{worst:.2e} (bound {SOLVE_BOUND:.0e})")
    return worst <= SOLVE_BOUND


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--serve-solves", type=int, default=8,
                    help="also serve this many solve requests against a "
                         "resident factor (0 = off)")
    ap.add_argument("--solve-n", type=int, default=128)
    ap.add_argument("--solve-precision", default="fp32",
                    choices=["fp32", "bf16_refine"])
    ap.add_argument("--serve-traffic", type=int, default=12,
                    help="open-loop requests through AsyncSolveServer's "
                         "drain loop (0 = off)")
    ap.add_argument("--serve-fleet", type=int, default=2,
                    help="mixed-order solve waves through a "
                         "planner-bucketed SolverFleet (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    device = torch.device(args.device)
    ok = serve_lm(args, device)
    if args.serve_solves or args.serve_fleet or args.serve_traffic:
        from repro_torch import api
        grid = api.make_trsm_mesh(1, 1, device=device)
        if args.serve_solves:
            ok &= serve_solves(args, grid)
        if args.serve_fleet:
            ok &= serve_fleet(args, grid)
        if args.serve_traffic:
            ok &= serve_traffic(args, grid)
    print("all checks within their bounds" if ok else "a check missed its "
          "bound")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
