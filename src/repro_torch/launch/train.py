"""Training CLI (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        [--shape train_4k] [--smoke] [--steps N] [--optimizer adamw|kfac_ca] \
        [--mesh debug|single|multi] [--compress] \
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
frames) through ``models.whisper``.

The step is ``train_step.jit_train_step`` on a mesh of the world's
ranks: under torchrun (``WORLD_SIZE``/``RANK`` set) the world the
launcher started (``core.world.join_world``: NCCL with a card per rank,
else gloo), otherwise this one process.  ``--mesh debug`` (the default)
is ``make_debug_mesh(max(n // 4, 1), min(4, n))`` over n ranks, as the
reference builds it over its devices; ``single`` and ``multi`` are the
production meshes of 256 and 512 ranks.  Each rank holds its pieces of
the parameters, optimizer state and batch rows, and rank 0 prints and
writes the checkpoints.  ``--compress`` passes ``compress_grads``
(the identity on the step's gradients, as in the reference).
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
from repro_torch.core import world
from repro_torch.data import synthetic
from repro_torch.launch import mesh as meshlib
from repro_torch.models import lm, whisper
from repro_torch.models import sharding
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
    if torch.device(args.device or "cuda").type == "cuda" \
            and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    device = torch.device(world.join_world(args.device) if world.launched()
                          else args.device or "cuda")
    try:
        mesh = meshlib.from_flag(args.mesh)
    except RuntimeError as e:
        ap.error(f"--mesh {args.mesh}: {e}")
    lead = mesh.rank == 0
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    sh = SHAPES[args.shape]
    B = args.batch or (4 if args.smoke else sh.global_batch)
    S = args.seq or (64 if args.smoke else sh.seq_len)
    on_card = device.type == "cuda"
    say = print if lead else (lambda *a, **k: None)
    say(f"device={device} mesh={mesh.shape} arch={cfg.name} B={B} S={S} "
        f"opt={args.optimizer}")

    opt = optim.get(args.optimizer, lr=args.lr)
    init = whisper.init if cfg.enc_dec else lm.init
    params = init(cfg, 0, device=device)
    opt_state = opt.init(params)
    batch0 = synthetic.host_batch(cfg, S, B, 0)
    step_fn = ts.jit_train_step(cfg, mesh, opt, params, opt_state, batch0,
                                microbatches=args.microbatches,
                                remat=not args.smoke,
                                compress_grads=args.compress)
    ps, os_, _ = ts.shardings_for(cfg, mesh, params, opt_state, batch0)
    shardings = {"p": ps, "o": os_}
    params, opt_state = sharding.shard(params, ps), \
        sharding.shard(opt_state, os_)

    start = 0
    if args.resume == "auto" and ckpt.latest_step(args.ckpt) is not None:
        restored, start = ckpt.restore(
            args.ckpt, ckpt.latest_step(args.ckpt),
            {"p": init(cfg, device="meta"), "o": opt.init(init(
                cfg, device="meta"))}, shardings=shardings, device=device)
        params, opt_state = restored["p"], restored["o"]
        say(f"resumed from step {start}")

    mon = ft.StepMonitor(n_hosts=1)
    hb = ft.Heartbeat(args.ckpt, host=mesh.rank)
    host, n_hosts = sharding.data_split(mesh, B)
    pf = synthetic.Prefetcher(cfg, S, B, start_step=start, host=host,
                              n_hosts=n_hosts)
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
                say(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                    f"{dt * 1e3:.0f}ms"
                    + (" STRAGGLER" if mon.stragglers() else ""))
            if (i + 1) % args.ckpt_every == 0:
                if saving is not None:      # one save of a step at a time
                    saving.join()
                saving = ckpt.save(args.ckpt, i + 1,
                                   {"p": params, "o": opt_state},
                                   blocking=False, shardings=shardings)
                saved = i + 1
    finally:
        pf.close()
        if saving is not None:
            saving.join()
    if on_card and times:
        steady = times[1:] or times
        say(f"{len(times)} steps: {statistics.median(steady):.3f} s/step "
              f"(median after the first, {times[0]:.3f} s the first), peak "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
              f"allocated, tri_inv_blocks {b1[-1]} launches/step")
    if saved != args.steps:
        ckpt.save(args.ckpt, args.steps, {"p": params, "o": opt_state},
                  shardings=shardings)
    say("done")


if __name__ == "__main__":
    main()
