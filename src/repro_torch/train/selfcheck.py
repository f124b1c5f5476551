"""Sharded self-checks for the LM's training and serving stack (the
counterpart of ``repro.train.selfcheck``), on a world of four ranks:

    PYTHONPATH=src python -m repro_torch.train.selfcheck [what] \\
        [--device cpu|cuda] [--out DIR] [--init DIR]

``what`` is one of ``train_step``, ``serve_step``, ``pipeline``,
``compress``, ``ckpt_reshard`` (all by default).  The script spawns its
own four gloo ranks (``core.world.spawn_ranks``; with ``--device
cuda``, the default, every rank on cuda:0) and runs the checks in each:

* ``train_step``: ``jit_train_step`` on the (2, 2) ("data", "model")
  mesh, fp32, two microbatches, remat, two adamw steps for the smoke
  qwen3-1.7b, grok-1-314b and recurrentgemma-2b (:data:`ADAMW`), and
  one kfac_ca step
  for the smoke smollm-360m, each step held against the one-rank step
  (``make_train_step``) on the whole batch, and every stored shard's
  shape against its spec;
* ``serve_step``: ``jit_decode_step`` on the same mesh, fp32 caches, a
  prefill and two steps for qwen3-1.7b and recurrentgemma-2b, against
  ``lm.decode_step`` on one rank;
* ``pipeline``: ``pipeline_apply`` over a ("pipe",) mesh of 4 against
  the sequential composition of its stages;
* ``compress``: ``psum_compressed`` over a ("pod",) mesh of 4, and the
  mean of stochastic rounding;
* ``ckpt_reshard``: parameters saved from (2, 2), restored onto (1, 4)
  and gathered, bit for bit.

``--init DIR`` takes each arch's initial parameters from the checkpoint
``DIR/<arch>`` (step 0, the shared on-disk format) instead of
``lm.init`` at seed 0; ``--out DIR`` receives what rank 0 computed
(``<check>_<arch>.npz`` with the parameters and optimizer state after
each step, ``<check>.npz``) and every rank's stored
shapes (``shards.json``), for the parity tests.  Prints one line a
check and ``selfcheck: N failures``; exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

WORLD = 4
TRAIN_ARCHS = ("qwen3-1.7b", "grok-1-314b", "recurrentgemma-2b")
SERVE_ARCHS = ("qwen3-1.7b", "recurrentgemma-2b")
# the K-FAC step on the smoke config the one-device parity uses
KFAC_ARCH = "smollm-360m"
KFAC = dict(lr=1e-2, min_dim=8, max_dim=512)
# adamw at eps 1e-2: the first update of an entry is lr g / (|g| + eps),
# and where |g| is far below eps a gradient error dg moves it by
# lr dg / eps.  Two summation orders in fp32 differ by dg ~ 1e-6 of the
# leaf's largest gradient (4e-8 on the smoke recurrentgemma's zero-init
# conv_b, whose scale after a step is the update itself): at the default
# eps 1e-8 that moved its entries by 10% of the leaf's scale, at 1e-2 by
# well under the 1e-4 the package parity asks
ADAMW = dict(lr=1e-3, eps=1e-2)
SEQ, BATCH, MICRO, STEPS = 32, 4, 2, 2
PROMPT, CACHE = 8, 16
ONE_RANK_TOL = 1e-5          # the sharded step against one rank's, fp32


def _err(got, want) -> float:
    """max |got - want| over the largest |want| (1 if that is 0)."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / (scale or 1.0) \
        if want.numel() else 0.0


def _tree_err(got, want) -> float:
    from repro_torch.optim.tree import leaves
    return max((_err(a, b) for a, b in zip(leaves(got), leaves(want))),
               default=0.0)


def _arrays(tree, prefix: str) -> dict:
    from repro_torch.optim.tree import leaves_with_keys
    return {prefix + "/".join(str(k) for k in keys):
            t.detach().cpu().double().numpy()
            for keys, t in leaves_with_keys(tree)}


def _shapes(pieces, shardings, full) -> tuple:
    """({path: stored shape}, whether every stored shape is the one its
    spec gives on its mesh)."""
    from repro_torch.models import sharding as sr
    from repro_torch.optim.tree import leaves_with_keys, leaves
    out, ok = {}, True
    for (keys, t), sh, f in zip(leaves_with_keys(pieces),
                                leaves(shardings), leaves(full)):
        out["/".join(str(k) for k in keys)] = list(t.shape)
        ok &= tuple(t.shape) == sr.local_shape(f.shape, sh.spec, sh.mesh)
    return out, ok


def _params(cfg, device, init_dir):
    from repro_torch.models import lm
    from repro_torch.train import checkpoint
    if init_dir is None:
        return lm.init(cfg, 0, device=device)
    like = lm.init(cfg, device="meta")
    params, _ = checkpoint.restore(os.path.join(init_dir, cfg.name), 0,
                                   like, device=device)
    return params


def _train(device, arch, opt_name, opt_kw, steps, init_dir) -> dict:
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import sharding as sr
    from repro_torch.train import train_step as ts
    optim = importlib.import_module("repro_torch.optim")
    cfg = configs.get_smoke(arch)
    mesh = make_debug_mesh(2, 2)
    params = _params(cfg, device, init_dir)
    opt = optim.get(opt_name, **opt_kw)
    state = opt.init(params)
    batches = [synthetic.host_batch(cfg, SEQ, BATCH, step=s)
               for s in range(steps)]
    kw = dict(microbatches=MICRO, remat=True, dtype=torch.float32)
    step = ts.jit_train_step(cfg, mesh, opt, params, state, batches[0],
                             **kw)
    one = ts.make_train_step(cfg, opt, **kw)
    ps, os_, bs = ts.shardings_for(cfg, mesh, params, state, batches[0])
    p, o = sr.shard(params, ps), sr.shard(state, os_)
    shapes_p, ok_p = _shapes(p, ps, params)
    shapes_o, ok_o = _shapes(o, os_, state)
    p1, o1 = params, state
    rec = dict(losses=[], one_rank_losses=[], one_rank_err=0.0,
               arrays={}, shards=dict(params=shapes_p, opt=shapes_o),
               shapes_ok=ok_p and ok_o)
    for s, batch in enumerate(batches):
        p, o, m = step(p, o, sr.shard(batch, bs))
        p1, o1, m1 = one(p1, o1, batch)
        whole_p, whole_o = sr.gather(p, ps), sr.gather(o, os_)
        rec["losses"].append(float(m["loss"]))
        rec["one_rank_losses"].append(float(m1["loss"]))
        rec["one_rank_err"] = max(
            rec["one_rank_err"], _err(m["loss"], m1["loss"]),
            _tree_err(whole_p, p1), _tree_err(whole_o, o1))
        rec["arrays"].update(_arrays(whole_p, f"{s + 1}/"))
        rec["arrays"].update(_arrays(whole_o, f"{s + 1}/opt/"))
    rec["ok"] = (rec["shapes_ok"] and rec["one_rank_err"] <= ONE_RANK_TOL
                 and all(np.isfinite(rec["losses"])))
    rec["line"] = (f"train_step {arch} {opt_name}: loss "
                   + " -> ".join(f"{v:.4f}" for v in rec["losses"])
                   + f", vs one rank {rec['one_rank_err']:.2e}, shards "
                   f"{'as specified' if rec['shapes_ok'] else 'WRONG'} "
                   f"{'OK' if rec['ok'] else 'FAIL'}")
    return rec


def check_train_step(device, init_dir) -> dict:
    out = {f"train_{a}": _train(device, a, "adamw", ADAMW, STEPS, init_dir)
           for a in TRAIN_ARCHS}
    out[f"kfac_{KFAC_ARCH}"] = _train(device, KFAC_ARCH, "kfac_ca", KFAC,
                                      1, init_dir)
    return out


def _serve(device, arch, init_dir) -> dict:
    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models import sharding as sr
    from repro_torch.train import serve_step as ss
    cfg = configs.get_smoke(arch)
    mesh = make_debug_mesh(2, 2)
    params = _params(cfg, device, init_dir)
    cache = lm.init_cache(cfg, BATCH, CACHE, torch.float32, device=device)
    one_cache = lm.init_cache(cfg, BATCH, CACHE, torch.float32,
                              device=device)
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT + 2)),
                           device=device)
    step = ss.jit_decode_step(cfg, mesh, params, cache, BATCH,
                              dtype=torch.float32)
    ps, cs = ss.serve_shardings(cfg, mesh, params, cache)
    rows = ss.rows(mesh, BATCH)
    p, c = sr.shard(params, ps), sr.shard(cache, cs)
    shapes_c, ok = _shapes(c, cs, cache)
    rec = dict(arrays={}, one_rank_err=0.0, shards=dict(cache=shapes_c),
               shapes_ok=ok)
    for i, (a, b) in enumerate(((0, PROMPT), (PROMPT, PROMPT + 1),
                                (PROMPT + 1, PROMPT + 2))):
        lg, c = step(p, c, sr.piece(toks[:, a:b], rows))
        want, one_cache = lm.decode_step(params, cfg, toks[:, a:b],
                                         one_cache, dtype=torch.float32)
        got = sr.whole(lg, rows)
        rec["one_rank_err"] = max(rec["one_rank_err"], _err(got, want))
        rec["arrays"][f"logits_{i}"] = got.cpu().double().numpy()
    rec["cache_err"] = _tree_err(sr.gather(c, cs), one_cache)
    rec["ok"] = ok and max(rec["one_rank_err"],
                           rec["cache_err"]) <= ONE_RANK_TOL
    rec["line"] = (f"serve_step {arch}: prefill {PROMPT} + 2 steps, logits "
                   f"vs one rank {rec['one_rank_err']:.2e}, cache "
                   f"{rec['cache_err']:.2e} {'OK' if rec['ok'] else 'FAIL'}")
    return rec


def check_serve_step(device, init_dir) -> dict:
    return {f"serve_{a}": _serve(device, a, init_dir) for a in SERVE_ARCHS}


def check_pipeline(device, init_dir) -> dict:
    from repro_torch.core.comm import make_named_mesh
    from repro_torch.models import sharding as sr
    from repro_torch.models.sharding import NamedSharding, P
    from repro_torch.train.pipeline import pipeline_apply
    mesh = make_named_mesh((WORLD,), ("pipe",))
    S, M, B, d = WORLD, 6, 2, 8
    rng = np.random.default_rng(0)
    # four stages, each an affine map; the reference is their sequential
    # composition (fp32, as the reference's jnp.asarray draws)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    Ws = f32(rng.standard_normal((S, d, d)) / np.sqrt(d))
    bs = f32(rng.standard_normal((S, d)) * 0.1)
    x = f32(rng.standard_normal((M, B, d)))

    def stage(p, h):
        W, b = p
        return torch.tanh(h @ W + b)

    stages = NamedSharding(mesh, P("pipe"))
    out = pipeline_apply(stage, (sr.piece(Ws, stages), sr.piece(bs, stages)),
                         x, mesh=mesh, axis="pipe")
    ref = x
    for s in range(S):
        ref = torch.tanh(ref @ Ws[s] + bs[s])
    err = float((out - ref).abs().max())
    ok = err < 1e-5
    return {"pipeline": dict(
        ok=ok, arrays=dict(out=out.cpu().double().numpy()),
        line=f"pipeline S={S} M={M}: err={err:.2e} "
             f"{'OK' if ok else 'FAIL'}")}


def check_compress(device, init_dir) -> dict:
    import torch.distributed as dist

    from repro_torch.core import comm
    from repro_torch.core.comm import make_named_mesh
    from repro_torch.train import compress
    mesh = make_named_mesh((WORLD,), ("pod",))
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.standard_normal((64, 64)), dtype=torch.float32,
                        device=device)
    gen = torch.Generator(device=device).manual_seed(1000 + dist.get_rank())
    with comm.on_mesh(mesh):
        out = compress.psum_compressed(g, "pod", gen)
    want = g * WORLD
    rel = float((out - want).abs().max() / want.abs().max())
    ok = rel < 0.05                  # int8: ~1% expected, unbiased
    # unbiasedness of stochastic rounding: 256 x 64 draws of 0.3
    x = torch.full((256, 64), 0.3, device=device)
    mean = float(compress._stochastic_round(
        x, torch.Generator(device=device).manual_seed(1)).mean())
    ok2 = abs(mean - 0.3) < 0.02
    return {"compress": dict(
        ok=ok and ok2, arrays=dict(out=out.cpu().double().numpy()),
        line=f"compress int8 psum: rel={rel:.4f} {'OK' if ok else 'FAIL'}; "
             f"stochastic rounding mean {mean:.3f} (want 0.3) "
             f"{'OK' if ok2 else 'FAIL'}")}


def check_ckpt_reshard(device, init_dir, ckpt_dir) -> dict:
    """Save from the (2, 2) mesh, restore onto (1, 4): elastic."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models import sharding as sr
    from repro_torch.optim.tree import leaves
    from repro_torch.train import checkpoint as ckpt
    cfg = configs.get_smoke("qwen3-1.7b")
    params = _params(cfg, device, init_dir)
    sh4 = sr.param_shardings(cfg, params, make_debug_mesh(2, 2))
    ckpt.save(ckpt_dir, 7, {"params": sr.shard(params, sh4)},
              shardings={"params": sh4})
    latest = ckpt.latest_step(ckpt_dir)
    sh14 = sr.param_shardings(cfg, params, make_debug_mesh(1, 4))
    like = lm.init(cfg, device="meta")
    restored, step = ckpt.restore(ckpt_dir, 7, {"params": like},
                                  shardings={"params": sh14}, device=device)
    _, ok_shapes = _shapes(restored["params"], sh14, params)
    back = sr.gather(restored["params"], sh14)
    same = latest == 7 and step == 7 and ok_shapes and all(
        torch.equal(a, b) for a, b in zip(leaves(params), leaves(back)))
    return {"ckpt_reshard": dict(
        ok=same, arrays={},
        line=f"ckpt reshard (2, 2) -> (1, 4): "
             f"{'OK' if same else 'FAIL'}")}


CHECKS = {
    "train_step": check_train_step,
    "serve_step": check_serve_step,
    "pipeline": check_pipeline,
    "compress": check_compress,
    "ckpt_reshard": check_ckpt_reshard,
}


def run_checks(device, names, init_dir, ckpt_dir) -> dict:
    """Every named check in this rank (the ranks' spawned target)."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    out = {}
    for name in names:
        args = (ckpt_dir,) if name == "ckpt_reshard" else ()
        out.update(CHECKS[name](device, init_dir, *args))
    return out


def main(argv=None) -> int:
    from repro_torch.core.world import spawn_ranks
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?", choices=sorted(CHECKS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="write what rank 0 computed here")
    ap.add_argument("--init", help="initial parameters: DIR/<arch> "
                                   "checkpoints at step 0")
    args = ap.parse_args(argv)
    device = "cuda:0" if args.device == "cuda" else "cpu"
    if device != "cpu" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    names = [args.what] if args.what else list(CHECKS)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        try:
            ranks = spawn_ranks(
                WORLD, device, run_checks, names, args.init, ckpt_dir,
                log_dir=os.path.join(args.out, "ranks") if args.out
                else None)
        except Exception as e:                   # a rank failed or hung
            print(f"selfcheck: FAIL ({type(e).__name__}: {e})")
            print(f"selfcheck: {len(names)} failures")
            return 1
    fails = 0
    for key, rec in ranks[0].items():
        ok = all(r[key]["ok"] for r in ranks)
        line = rec["line"] if ok == rec["ok"] else \
            f"{rec['line']} (FAIL on another rank)"
        print(line, flush=True)
        fails += 0 if ok else 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for key, rec in ranks[0].items():
            extra = {k: np.asarray(rec[k]) for k in
                     ("losses", "one_rank_losses") if k in rec}
            np.savez(os.path.join(args.out, f"{key}.npz"),
                     **rec["arrays"], **extra)
        with open(os.path.join(args.out, "shards.json"), "w") as f:
            json.dump({key: [r[key].get("shards") for r in ranks]
                       for key in ranks[0]}, f)
    print(f"selfcheck: {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
