"""Training CLI (the counterpart of ``repro.launch.train``, one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        [--shape train_4k] [--smoke] [--steps N] [--optimizer adamw|kfac_ca] \
        [--batch B] [--seq S] [--microbatches M] [--lr LR] \
        [--ckpt DIR] [--ckpt-every K] [--resume auto|none] [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise; ``--smoke`` takes
the arch's reduced config (B = 4, S = 64 unless given) and turns remat
off.  Parameters are random from seed 0, batches the deterministic
synthetic stream (``data.synthetic``, prefetched on a thread), so a
run resumed from its latest complete checkpoint (``--resume auto``, the
default) continues bit-exactly.  Prints the loss every 10 steps and at
the last; on the card also seconds per step, peak memory and the
``tri_inv_blocks`` (B1) launches per step, which every ``kfac_ca``
step makes.  Every arch trains: the decoder-only ones through
``models.lm``, whisper-tiny (enc-dec, its batches carrying encoder
frames) through ``models.whisper``.  ``--mesh single|multi`` and
``--compress`` wait for the multi-GPU port (ROADMAP A15h).
"""

from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time

import torch

from repro_torch import configs, optim
from repro_torch.configs import SHAPES
from repro_torch.data import synthetic
from repro_torch.models import lm, whisper
from repro_torch.train import checkpoint as ckpt, ft
from repro_torch.train import train_step as ts


def _b1_launches() -> int:
    from repro_torch.kernels import tri_inv_block
    return tri_inv_block.tri_inv_blocks.launches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS
                    + ["preset-100m"])
    ap.add_argument("--shape", default="train_4k",
                    choices=[s for s in SHAPES])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="debug",
                    choices=["single", "multi", "debug"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "kfac_ca"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod gradient compression")
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch (smoke)")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default cuda)")
    args = ap.parse_args(argv)

    if args.arch not in configs.ARCH_IDS:
        ap.error(f"--arch {args.arch} has no config in repro_torch.configs")
    if args.mesh != "debug":
        ap.error(f"--mesh {args.mesh} is not ported yet: production meshes "
                 f"and sharding wait for ROADMAP A15h (launch/mesh.py, "
                 f"models/sharding.py)")
    if args.compress:
        ap.error("--compress is not ported yet: cross-pod gradient "
                 "compression waits for ROADMAP A15h (train/compress.py)")
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    sh = SHAPES[args.shape]
    B = args.batch or (4 if args.smoke else sh.global_batch)
    S = args.seq or (64 if args.smoke else sh.seq_len)
    on_card = device.type == "cuda"
    print(f"device={device} arch={cfg.name} B={B} S={S} "
          f"opt={args.optimizer}")

    opt = optim.get(args.optimizer, lr=args.lr)
    init = whisper.init if cfg.enc_dec else lm.init
    params = init(cfg, 0, device=device)
    opt_state = opt.init(params)
    step_fn = ts.make_train_step(cfg, opt, microbatches=args.microbatches,
                                 remat=not args.smoke)

    start = 0
    if args.resume == "auto" and ckpt.latest_step(args.ckpt) is not None:
        restored, start = ckpt.restore(
            args.ckpt, ckpt.latest_step(args.ckpt),
            {"p": params, "o": opt_state})
        params, opt_state = restored["p"], restored["o"]
        print(f"resumed from step {start}")

    mon = ft.StepMonitor(n_hosts=1)
    hb = ft.Heartbeat(args.ckpt, host=0)
    pf = synthetic.Prefetcher(cfg, S, B, start_step=start)
    times, b1 = [], []
    saving, saved = None, None      # the async save's thread, its step
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        for i in range(start, args.steps):
            t0 = time.time()
            s_idx, batch = next(pf)
            launches = _b1_launches()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if on_card:
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            times.append(dt)
            b1.append(_b1_launches() - launches)
            mon.record(0, dt)
            hb.beat(i)
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                      f"{dt * 1e3:.0f}ms"
                      + (" STRAGGLER" if mon.stragglers() else ""))
            if (i + 1) % args.ckpt_every == 0:
                if saving is not None:      # one save of a step at a time
                    saving.join()
                saving = ckpt.save(args.ckpt, i + 1,
                                   {"p": params, "o": opt_state},
                                   blocking=False)
                saved = i + 1
    finally:
        pf.close()
        if saving is not None:
            saving.join()
    if on_card and times:
        steady = times[1:] or times
        print(f"{len(times)} steps: {statistics.median(steady):.3f} s/step "
              f"(median after the first, {times[0]:.3f} s the first), peak "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
              f"allocated, tri_inv_blocks {b1[-1]} launches/step")
    if saved != args.steps:
        ckpt.save(args.ckpt, args.steps, {"p": params, "o": opt_state})
    print("done")


if __name__ == "__main__":
    main()
