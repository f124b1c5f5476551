"""Dry run: one rank's step of every (architecture x input shape) cell
on the production meshes, on meta tensors over an abstract mesh, and
the a-priori plans of the solver and the fleet (the counterpart of
``repro.launch.dryrun``).  Nothing is computed and no process is
started.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-1.7b --shape train_4k --mesh single,multi

Each cell records, for rank 0 of the 256-rank ("data", "model") or
512-rank ("pod", "data", "model") mesh (``launch.mesh.PRODUCTION``):
the bytes of its pieces of the parameters, optimizer state, cache and
batch (temp bytes: not measured); the flops ``FlopCounterMode`` counts
in its step (eager torch unrolls every loop, so every trip counts);
the collectives of that step, traced (``comm.traced_cost``); and the
analytic ``roofline.model.cell_model``.  The step is the port's own
design: parameters stored sharded, gathered whole and computed on, so a
rank's flops are the whole model's on its data shard, repeated along
"model" (``useful_flops_ratio`` shows it).

The solver's plan smoke (``--spec``) and the fleet planner's bucket
table (``--fleet``) are cost-model arithmetic alone:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --spec
    PYTHONPATH=src python -m repro_torch.launch.dryrun --spec 16384,512,256
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fleet

One JSON artifact per cell is written to ``build/dryrun/`` (ignored by
git), so a sweep resumes with ``--skip-existing``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.core import comm
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models import lm, whisper
from repro_torch.models import sharding as shard_rules
from repro_torch.optim.tree import leaves
from repro_torch.roofline import analysis
from repro_torch.roofline import model as rmodel

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
META = torch.device("meta")


# --------------------------- input specs ---------------------------

def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg, sh) -> dict:
    """Meta stand-ins for every model input of the cell: the global
    batch (a decode step: one new token against a seq_len-deep
    cache)."""
    B, S = sh.global_batch, sh.seq_len
    bf16 = torch.bfloat16
    if sh.kind == "decode":
        batch = {"tokens": _meta((B, 1))}
        if cfg.embed_inputs:
            batch = {"embeds": _meta((B, 1, cfg.d_model), bf16)}
        if cfg.enc_dec:
            batch["enc_states"] = _meta((B, cfg.enc_frames, cfg.d_model),
                                        bf16)
        return batch
    batch = {"tokens": _meta((B, S))}
    if cfg.embed_inputs:
        batch = {"embeds": _meta((B, S, cfg.d_model), bf16)}
    if sh.kind == "train":
        batch["labels"] = _meta((B, S))
    if cfg.enc_dec:
        batch["frames"] = _meta((B, cfg.enc_frames, cfg.d_model), bf16)
    return batch


def microbatches_for(cfg, sh, mesh) -> int:
    """Gradient-accumulation depth M.  The reference bounds each
    device's live activations to ~8k tokens a microbatch, its
    microbatches spread over the D data-parallel devices; here a
    microbatch is computed whole by one data rank, so M is D times the
    reference's depth, each rank computing M/D microbatches of the
    same per-device size."""
    dp = shard_rules.dp_axes(mesh)
    D = mesh.size(dp) if dp else 1
    mb = 1
    while (sh.global_batch // mb) * sh.seq_len // D > 8192 \
            and mb * 2 <= sh.global_batch // D:
        mb *= 2
    return mb * D if sh.global_batch % (mb * D) == 0 else mb


# ------------------------------- cells -------------------------------

def _init(cfg):
    return (whisper.init if cfg.enc_dec else lm.init)(cfg, 0, device=META)


def _rows(t, mesh):
    """This rank's rows of a global batch leaf (whole where they do
    not split over the data-parallel axes)."""
    return shard_rules.piece(t, shard_rules.NamedSharding(
        mesh, shard_rules.batch_specs({"x": t}, mesh)["x"]))


def build_train(cfg, sh, mesh, shard_mode="2d", mb=None,
                moment_dtype=torch.float32):
    from repro_torch import optim
    from repro_torch.train import train_step as ts
    params = _init(cfg)
    opt = optim.get("adamw", moment_dtype=moment_dtype)
    opt_state = opt.init(params)
    batch = input_specs(cfg, sh)
    mb = mb or microbatches_for(cfg, sh, mesh)
    fn = ts.jit_train_step(cfg, mesh, opt, params, opt_state, batch,
                           shard_mode, microbatches=mb, remat=True)
    ps, os_, bs = ts.shardings_for(cfg, mesh, params, opt_state, batch,
                                   shard_mode)
    args = (shard_rules.shard(params, ps), shard_rules.shard(opt_state, os_),
            shard_rules.shard(batch, bs))
    return fn, args, {"microbatches": mb}, dict(
        params=args[0], opt_state=args[1], batch=args[2])


def build_prefill(cfg, sh, mesh, shard_mode="2d"):
    params = _init(cfg)
    batch = input_specs(cfg, sh)
    ps = shard_rules.param_shardings(cfg, params, mesh, shard_mode)

    def fn(params, batch):
        full = shard_rules.gather(params, ps)
        if cfg.enc_dec:
            enc = whisper.encode(full, cfg, batch["frames"])
            return whisper.decode(full, cfg, batch["tokens"], enc,
                                  last_only=True)[0]
        return lm.forward(full, cfg, batch.get("tokens"),
                          embeds=batch.get("embeds"), last_only=True)[0]

    args = (shard_rules.shard(params, ps),
            {k: _rows(v, mesh) for k, v in batch.items()})
    return fn, args, {}, dict(params=args[0], batch=args[1])


def build_decode(cfg, sh, mesh, kv_dtype=torch.bfloat16):
    from repro_torch.train import serve_step as ss
    B = sh.global_batch
    params = _init(cfg)
    init_cache = whisper.init_cache if cfg.enc_dec else lm.init_cache
    cache = init_cache(cfg, B, sh.seq_len, dtype=kv_dtype, device=META)
    fn = ss.jit_decode_step(cfg, mesh, params, cache, B)
    ps, cs = ss.serve_shardings(cfg, mesh, params, cache)
    batch = {k: _rows(v, mesh) for k, v in input_specs(cfg, sh).items()}
    args = [shard_rules.shard(params, ps), shard_rules.shard(cache, cs),
            batch.get("tokens", _rows(_meta((B, 1)), mesh))]
    if cfg.enc_dec:
        args.append(batch["enc_states"])
    elif cfg.embed_inputs:
        args.append(batch["embeds"])
    return fn, tuple(args), {}, dict(params=args[0], cache=args[1],
                                     batch=args[2:])


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


# -------------------------- SolveSpec smoke --------------------------

# one (n, k, p) per paper regime (Sec. VIII): tall solve (2d), the
# general 3d case, and the many-RHS 1d case
SPEC_REGIMES = [(16384, 128, 64), (16384, 512, 256), (256, 65536, 64)]


def run_spec_smoke(triples, structure: str | None = None,
                   overlap: str = "auto") -> int:
    """Resolve and print the a-priori plan (``SolveSpec.auto``) for each
    (n, k, p): pure cost-model arithmetic, no devices touched.

    ``structure`` ("dense" | "banded[:BW]" | "block-sparse") resolves
    the hoisted serving plan for a structured factor instead, with the
    analyzed level schedule beside the modeled times (DESIGN.md
    Sec. 14).  ``overlap`` ("auto" | "on" | "off") prices the steady
    sweep pipelined or sequential; every "inv" plan is followed by its
    steady cost on the nominal H100 machine and, when the port's
    calibration exists (``cost_model.CALIBRATION_PATH``), on the
    calibrated one."""
    from repro_torch.core import cost_model as cm, tuning
    from repro_torch.core.solver import SolveSpec, _normalize_overlap
    ov = _normalize_overlap(overlap) == "on"
    base = cm.h100()
    cal = tuning.calibration()
    cal_machine = tuning.default_machine()
    for (n, k, p) in triples:
        if structure is None:
            spec = SolveSpec.auto(n, k, p=p, overlap=overlap)
            method, plan, times = tuning.choose_method(n, k, p)
            assert method == spec.method, (method, spec.method)
            print(f"[spec] n={n} k={k} p={p}: "
                  f"regime={tuning.regime(n, k, p)}"
                  f" -> method={spec.method} grid={plan.p1}x{plan.p1}x"
                  f"{plan.p2} n0={spec.n0} r=({plan.r1},{plan.r2}) "
                  f"modeled inv={times['inv']:.3e}s "
                  f"rec={times['rec']:.3e}s "
                  f"(machine: {cal_machine.name})")
        else:
            from repro_torch.core.structure import FactorStructure, analyze
            st = FactorStructure.parse(structure, n=n)
            spec = SolveSpec.auto(n, k, p=p, structure=st, hoisted=True,
                                  overlap=overlap)
            _, _, times = tuning.choose_serving_method(
                n, k, spec.grid, structure=spec.structure, overlap=ov)
            line = (f"[spec] n={n} k={k} p={p} structure={st.kind}: "
                    f"-> method={spec.method} grid={spec.grid.p1}x"
                    f"{spec.grid.p1}x{spec.grid.p2} n0={spec.n0} "
                    f"modeled inv={times['inv']:.3e}s "
                    f"rec={times['rec']:.3e}s")
            if spec.structure is not None:
                info = analyze(spec.structure, n, spec.n0)
                dense_off = info.m * (info.m - 1) // 2
                line += (f" levels={info.n_levels}/{info.m} "
                         f"offdiag={info.nnz_offdiag}/{dense_off}")
            print(line)
        # predicted vs calibrated steady cost at the resolved plan
        if spec.method == "inv" and spec.n0 is not None:
            c = cm.it_inv_trsm_steady_cost(
                n, k, spec.n0, spec.grid.p1, spec.grid.p2,
                structure=spec.structure, overlap=ov)
            steady = (f"[spec]   steady overlap={'on' if ov else 'off'} "
                      f"predicted={c.time(base):.3e}s")
            if cal is not None:
                steady += (f" calibrated={c.time(cal_machine):.3e}s "
                           f"(a={cal.a:.3g} b={cal.b:.3g} "
                           f"g={cal.g:.3g})")
            else:
                steady += " calibrated=n/a (no port calibration)"
            print(steady)
    return 0


# a mixed-order manifest spanning planner behaviors: the small orders
# merge into shared buckets (padding overhead < the saved dispatch),
# the large ones split out
FLEET_MANIFEST = {16384: 2, 8192: 4, 1024: 8, 512: 16, 256: 32, 128: 32}


def run_fleet_smoke(p1: int = 2, p2: int = 2, k: int = 16) -> int:
    """Print the fleet capacity planner's bucket table for a mixed-order
    manifest: pure cost-model arithmetic on a device-less grid
    (DESIGN.md Sec. 12), first with the default machine and dispatch
    (calibrated when the port's calibration exists), then on the
    nominal H100 machine at a high dispatch cost, where merging must
    pay."""
    from repro_torch.core import cost_model as cm, fleet as fleetlib
    from repro_torch.core.solver import plan_grid
    grid = plan_grid(p1, p2)
    plan_cal = fleetlib.plan_fleet(FLEET_MANIFEST, grid, k=k)
    print(f"[fleet] manifest={FLEET_MANIFEST} on p1={p1} p2={p2} "
          f"(p={grid.p}) k={k} dispatch_s={plan_cal.dispatch_s:.1e} "
          f"(calibrated default)")
    print(plan_cal.table())
    plan = fleetlib.plan_fleet(FLEET_MANIFEST, grid, k=k,
                               machine=cm.h100(), dispatch_s=5e-5)
    print("[fleet] nominal high-dispatch regime dispatch_s=5.0e-05:")
    print(plan.table())
    for p_ in (plan_cal, plan):
        orders = sum(len(b.orders) for b in p_.buckets)
        assert orders == len(FLEET_MANIFEST), (orders, FLEET_MANIFEST)
    orders = sum(len(b.orders) for b in plan.buckets)
    print(f"[fleet] {orders} orders -> {len(plan.buckets)} bucket(s) "
          f"at 5.0e-05; calibrated default -> {len(plan_cal.buckets)}")
    assert len(plan.buckets) < orders, "planner merged nothing"
    return 0


# ------------------------------ runner ------------------------------

def run_cell(arch: str, shape_name: str, mesh_kind: str,
             shard_mode: str = "2d", mb: int | None = None,
             kv_dtype: str = "bf16", moment_dtype: str = "f32", *,
             cfg=None, rank: int = 0) -> dict:
    """One cell's record, seen from ``rank``; ``cfg`` (default
    ``configs.get(arch)``) runs another config, a smoke one say, on the
    production mesh."""
    cfg = cfg or configs.get(arch)
    sh = SHAPES[shape_name]
    ok, why = configs.shape_applicable(cfg, sh)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": sh.kind, "shard_mode": shard_mode,
           "kv_dtype": kv_dtype, "time": time.time()}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    dims, names = PRODUCTION[mesh_kind == "multi"]
    mesh = comm.abstract_mesh(dims, names, rank=rank)
    n_chips = mesh.size(mesh.axis_names)
    kvd = {"bf16": torch.bfloat16, "int8": torch.int8}[kv_dtype]
    md = {"f32": torch.float32, "bf16": torch.bfloat16}[moment_dtype]
    t0 = time.time()
    if sh.kind == "train":
        fn, args, extra, parts = build_train(cfg, sh, mesh, shard_mode, mb,
                                             moment_dtype=md)
    elif sh.kind == "prefill":
        fn, args, extra, parts = build_prefill(cfg, sh, mesh, shard_mode)
    else:
        fn, args, extra, parts = build_decode(cfg, sh, mesh, kv_dtype=kvd)
    t_build = time.time() - t0
    flops = []
    trace = comm.traced_cost(
        lambda: flops.append(analysis.counted_flops(fn, *args)),
        mesh=mesh, rank=rank)
    flops = flops[0]
    t_step = time.time() - t0 - t_build

    part_bytes = {f"{k}_bytes": _nbytes(v) for k, v in parts.items()}
    arg_bytes = sum(part_bytes.values())
    mem_rec = dict(part_bytes, argument_size_in_bytes=arg_bytes,
                   temp_size_in_bytes="not measured")
    mflops = analysis.model_flops_for(cfg, sh)
    roof, colls = analysis.from_counts(flops, arg_bytes, trace, n_chips,
                                       mflops)
    mesh_roles = dict(mesh.shape)
    if shard_mode == "fsdp_all":
        # the model axis re-roled into FSDP/SP: model the collective
        # structure accordingly (no per-layer TP reductions)
        mesh_roles = {"pod": mesh_roles.get("pod", 1),
                      "data": mesh_roles.get("data", 1)
                      * mesh_roles.get("model", 1), "model": 1}
        mesh_roles = {k: v for k, v in mesh_roles.items() if v > 1} or \
            {"data": 1}
    cm = rmodel.cell_model(cfg, sh, mesh_roles,
                           microbatches=extra.get("microbatches", 1),
                           kv_bytes=(1.03 if kv_dtype == "int8" else 2.0))
    rec.update(status="ok", n_chips=n_chips, rank=rank,
               build_s=round(t_build, 2), step_s=round(t_step, 2),
               memory=mem_rec, collectives=colls,
               traced=dict(trace.summary()),
               counted=roof.to_dict(), roofline=cm.to_dict(), **extra)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--shard-mode", default="2d",
                    choices=["2d", "fsdp_all"])
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs on the production meshes")
    ap.add_argument("--tag", default="",
                    help="artifact suffix (perf-iteration runs)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--spec", nargs="*", default=None, metavar="N,K,P",
                    help="print the auto-resolved SolveSpec plan for "
                         "each n,k,p triple (default: one per paper "
                         "regime) and exit")
    ap.add_argument("--fleet", action="store_true",
                    help="print the fleet capacity planner's bucket "
                         "table for a mixed-order manifest (pure cost "
                         "model, no devices) and exit")
    ap.add_argument("--structure", default=None,
                    metavar="dense|banded[:BW]|block-sparse",
                    help="with --spec: resolve the hoisted serving "
                         "plan for a structured factor (structured n0 "
                         "argmin + level schedule; DESIGN.md Sec. 14)")
    ap.add_argument("--overlap", default="auto",
                    choices=["auto", "on", "off"],
                    help="with --spec: price the steady-state sweep "
                         "software-pipelined (on/auto) or sequential "
                         "(off); DESIGN.md Sec. 16")
    args = ap.parse_args(argv)

    if args.spec is not None:
        triples = [tuple(int(x) for x in s.split(","))
                   for s in args.spec] or SPEC_REGIMES
        return run_spec_smoke(triples, structure=args.structure,
                              overlap=args.overlap)
    if args.fleet:
        return run_fleet_smoke()

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        cfg = configs.get_smoke(arch) if args.smoke else configs.get(arch)
        for shp in shapes:
            for mk in meshes:
                tag = f"{arch}__{shp}__{mk}"
                if args.smoke:
                    tag += "__smoke"
                if args.tag:
                    tag += "__" + args.tag
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] {tag}: exists, skipping")
                    continue
                print(f"[dryrun] {tag}: tracing...", flush=True)
                try:
                    rec = run_cell(arch, shp, mk,
                                   shard_mode=args.shard_mode,
                                   mb=args.microbatches or None,
                                   kv_dtype=args.kv_dtype, cfg=cfg)
                except Exception as e:
                    rec = {"arch": arch, "shape": shp, "mesh": mk,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                st = rec["status"]
                msg = ""
                if st == "ok":
                    r, c = rec["roofline"], rec["counted"]
                    msg = (f"step={rec['step_s']}s "
                           f"bottleneck={r['bottleneck']} "
                           f"frac={r['roofline_fraction']:.3f} "
                           f"counted useful={c['useful_flops_ratio']:.3f}")
                elif st == "skipped":
                    msg = rec["reason"][:60]
                else:
                    msg = rec["error"][:120]
                print(f"[dryrun] {tag}: {st} {msg}", flush=True)
    print(f"[dryrun] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
