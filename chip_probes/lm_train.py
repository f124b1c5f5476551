#!/usr/bin/env python3
"""The trainer at qwen3-1.7b's full widths, depth by depth, on the card:
what ``chip_smoke.py``'s phase 16 measures of a train step (seconds a
step, peak memory, B1 launches a step, losses: its ``lm_train``, at
its B = 2, S = 1024, remat) and what it does not: where a profiled
step's device time goes, and the attention core's share.

For each ``--layers`` value (deepest first) it runs phase 16's
``lm_train`` on ``lm.init`` from seed 0 with ``--optimizer`` at the
CLI's lr, 3e-4, and the synthetic batch of step 0; then one more step
under torch.profiler (device activity only: a K-FAC step is tens of
thousands of operators): device ms, the busy share of the step's wall
time and the top kernels.  A depth that runs out of memory is reported
and the next one tried.  One JSON line a depth.  Last, the attention
core: its einsums run as batched GEMMs that cannot be told from the
others by name, so one layer's ``layers._attend_full`` forward and
backward are timed apart at the step's shapes, bf16, under CUDA events
(a remat step runs the forward twice and the backward once a layer).

    PYTHONPATH=src python3 chip_probes/lm_train.py --optimizer kfac_ca \
        --layers 28 24 20 --steps 2
"""

import argparse
import dataclasses
import gc
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

LR = 3e-4                                     # launch/train.py's default


def profile_step(run) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in rows)
    return dict(wall_ms=wall * 1e3, device_ms=device_ms,
                busy_share=device_ms / (wall * 1e3) if rows else None,
                top=[[k[:70], ms, n] for ms, k, n in rows[:10]])


def attention_ms(cfg, batch: int, seq: int) -> dict:
    """One layer's attention core (``layers._attend_full``: scores,
    masked fp32 softmax, output) forward and backward in bf16 at the
    step's shapes, median of 5 under CUDA events."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    hd = cfg.head_dim
    q = torch.randn((batch, seq, cfg.n_heads, hd), generator=g, device=dev,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn((batch, seq, cfg.n_kv, hd), generator=g, device=dev,
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    dy = torch.randn((batch, seq, cfg.n_heads, hd), generator=g, device=dev,
                     dtype=torch.bfloat16)
    fwd, bwd = [], []
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        o = layers._attend_full(q, k, v, causal=True, window=0)
        ev[1].record()
        torch.autograd.grad(o, (q, k, v), dy)
        ev[2].record()
        torch.cuda.synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    med = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]  # noqa: E731
    return dict(forward_ms=med(fwd), backward_ms=med(bwd))


def run_depth(args, n_layers: int) -> dict:
    cfg = dataclasses.replace(configs.get(args.arch), n_layers=n_layers)
    rec = dict(arch=args.arch, optimizer=args.optimizer)
    params = state = None
    try:
        opt = optim.get(args.optimizer, lr=LR)
        batch = synthetic.host_batch(cfg, chip_smoke.LM_TRAIN_SEQ,
                                     chip_smoke.LM_TRAIN_BATCH, step=0)
        params, state, train, _ = chip_smoke.lm_train(
            cfg, opt, lm.init(cfg, 0, device="cuda"), batch, args.steps,
            args.optimizer)
        rec.update(train)
        step = train_step.make_train_step(cfg, opt, remat=True)

        def one():
            nonlocal params, state
            params, state, _ = step(params, state, batch)
        rec["profiled_step"] = profile_step(one)
        rec["ok"] = True
    except torch.cuda.OutOfMemoryError as e:
        rec.update(layers=n_layers, ok=False,
                   error=str(e).splitlines()[0][:300],
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated()
                   / 2 ** 30)
    params = state = None
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--optimizer", default="kfac_ca",
                    choices=["adamw", "kfac_ca"])
    ap.add_argument("--layers", type=int, nargs="+", default=[28])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_train: needs a CUDA card", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    build.build_all()
    for n in args.layers:
        print(json.dumps({"lm_train": run_depth(args, n)}), flush=True)
    cfg = configs.get(args.arch)
    print(json.dumps({"attention_core": dict(
        per_layer=attention_ms(cfg, chip_smoke.LM_TRAIN_BATCH,
                               chip_smoke.LM_TRAIN_SEQ),
        layers=cfg.n_layers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
