"""End-to-end training on the PyTorch port: a ~134M-parameter LM
for a few hundred steps on the synthetic pipeline, with
checkpoint/restart and the KFAC-CA (CA-TRSM-preconditioned) optimizer
available.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --arch smollm-360m \\
        --optimizer kfac_ca --steps 6 --smoke --device cpu

--smoke uses the reduced config (CI speed); the default preset is a
~134M model.  A run resumes from the newest checkpoint in --ckpt.  At
its end the run restores its last checkpoint before the final step and
replays the steps from there: the replayed parameters must equal the
trained ones within RESTART_BOUND (relative to the largest parameter),
and every loss must be finite; otherwise it exits 1.
"""

import argparse
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import configs, optim
from repro_torch.configs import ModelConfig
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.optim import schedules
from repro_torch.optim.tree import leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts

PRESET_100M = ModelConfig(
    name="preset-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv=4, d_ff=2048, vocab=32768, tie_embeddings=True)
# bit-exact on the CPU; on the card the embedding's backward sums with
# atomics, whose order may move the last bits of a replayed step
RESTART_BOUND = 1e-5


def _max_rel_diff(a, b) -> float:
    num = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(leaves(a), leaves(b)))
    den = max(float(x.float().abs().max()) for x in leaves(a))
    return num / den


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="preset-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "kfac_ca"])
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    device = torch.device(args.device)

    if args.arch == "preset-100m":
        cfg = PRESET_100M
    elif args.smoke:
        cfg = configs.get_smoke(args.arch)
    else:
        cfg = configs.get(args.arch)
    print(f"arch={cfg.name} params~{cfg.param_count / 1e6:.0f}M "
          f"optimizer={args.optimizer} device={device}")

    lr = schedules.warmup_cosine(args.lr, warmup=20, total=args.steps)
    kw = dict(lr=lr)
    if args.optimizer == "kfac_ca":
        kw.update(max_dim=4096, update_freq=10)
    opt = optim.get(args.optimizer, **kw)
    step_fn = ts.make_train_step(cfg, opt, remat=False, dtype=torch.float32)

    def fresh():
        params = lm.init(cfg, 0, device=device)
        return params, opt.init(params)

    def restored(step):
        like = {"p": lm.init(cfg, 0, device="meta")}
        like["s"] = opt.init(like["p"])
        state, _ = ckpt.restore(args.ckpt, step, like, device=device)
        return state["p"], state["s"]

    # resume or init
    start = ckpt.latest_step(args.ckpt)
    if start is not None and start < args.steps:
        params, state = restored(start)
        print(f"resumed from step {start}")
    else:
        start = 0
        params, state = fresh()

    def train(params, state, first, last, log=True):
        pf = synthetic.Prefetcher(cfg, args.seq, args.batch,
                                  start_step=first)
        losses, saved = [], None
        t0 = time.time()
        try:
            for i in range(first, last):
                s_idx, batch = next(pf)
                assert s_idx == i
                params, state, m = step_fn(params, state, batch)
                losses.append(float(m["loss"]))
                if log and (i % args.log_every == 0 or i == last - 1):
                    dt = time.time() - t0
                    tok_s = args.batch * args.seq * args.log_every \
                        / max(dt, 1e-9)
                    print(f"step {i:5d} loss {losses[-1]:.4f} "
                          f"lr {float(m['lr']):.2e} "
                          f"gnorm {float(m['grad_norm']):.2f} "
                          f"tok/s {tok_s:,.0f}")
                    t0 = time.time()
                if log and (i + 1) % args.ckpt_every == 0 \
                        and i + 1 < last:
                    ckpt.save(args.ckpt, i + 1, {"p": params, "s": state})
                    saved = i + 1
        finally:
            pf.close()
        return params, state, losses, saved

    params, state, losses, saved = train(params, state, start, args.steps)
    ckpt.save(args.ckpt, args.steps, {"p": params, "s": state})
    print(f"done; final checkpoint at step {args.steps} in {args.ckpt}")

    # restart check: replay from the last checkpoint before the end (the
    # run's own, or the fresh init when the run saved none)
    back = saved if saved is not None else start
    p0, s0 = restored(back) if back else fresh()
    replayed, _, _, _ = train(p0, s0, back, args.steps, log=False)
    diff = _max_rel_diff(params, replayed)
    finite = all(math.isfinite(x) for x in losses)
    print(f"restart from step {back}: replayed parameters differ by "
          f"{diff:.2e} (bound {RESTART_BOUND:.0e}); losses finite: "
          f"{finite}")
    return 0 if finite and diff <= RESTART_BOUND else 1


if __name__ == "__main__":
    raise SystemExit(main())
