"""The port's sharded LM steps (``repro_torch.train.selfcheck`` on four
gloo CPU ranks) against the reference's on a (2, 2) mesh of four forced
host devices.

One module fixture runs the port's ``python -m
repro_torch.train.selfcheck --device cpu``, then the reference (a
subprocess, ``XLA_FLAGS=--xla_force_host_platform_device_count=8``),
within one deadline (a timeout kills each subprocess's whole session,
ranks included).  Both start from the reference's initial parameters (drawn
here, written as step-0 checkpoints in the shared format) and take the
port's NumPy batches (``repro_torch.data.synthetic.host_batch``).

The reference runs ``jit_train_step`` (fp32, two microbatches, remat,
adamw at the selfcheck's ``ADAMW``, whose eps says why; the smoke
qwen3-1.7b, grok-1-314b and recurrentgemma-2b, two steps) and
``jit_decode_step`` (fp32 through its ``lm.decode_step`` patched in its
process; qwen3-1.7b and recurrentgemma-2b, a prefill and two steps),
``pipeline_apply`` and ``psum_compressed``.  Its
kfac_ca step on the mesh (smollm-360m smoke) runs ``make_train_step``
eagerly on inputs placed by ``shardings_for``, its SPD inverse under
``jax.jit`` (as ``test_torch_train.py`` does): the whole step under
``jit_train_step`` compiles for about 155 s on one core.

Tolerances, ``rtol = tol`` and ``atol = tol`` times the largest entry
compared: losses 1e-4 (relative), parameters and optimizer state
(moments, K-FAC factors, counts) after each step 1e-4,
logits 2e-3, the pipeline 1e-5, the compressed sum 0.05; the port's
sharded step against its own one-rank step 1e-5 and the checkpoint
reshard bit for bit (checked in the selfcheck's ranks).

The last two tests run ``launch.train --mesh debug --compress`` and
``launch.serve --workload lm --mesh debug`` in four processes with
torchrun's environment set by hand, against one process's run.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import abstract_mesh
from repro.models import lm as jlm
from repro.models import sharding as jsr
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch.launch import serve, train
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import selfcheck
from torch_parity import assert_close

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# a bound on the fixture's two subprocesses, far above their ~90 s alone
DEADLINE_S = 300
ARCHS = selfcheck.TRAIN_ARCHS + (selfcheck.KFAC_ARCH,)
STEP_TOL = 1e-4
LOGIT_TOL = 2e-3

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's in-process runs (the CLIs'
    one-process comparisons), as the other LM test files pin theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFERENCE = r'''
import functools, importlib, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat, configs, optim
from repro.models import lm
from repro.train import checkpoint as ckpt, compress
from repro.train import serve_step as ss, train_step as ts
from repro.train.pipeline import pipeline_apply
from repro_torch.data import synthetic
from repro_torch.train import selfcheck as sc

init_dir, out = sys.argv[1], sys.argv[2]
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def params_of(cfg):
    like = jax.eval_shape(lambda: lm.init(cfg, jax.random.key(0)))
    tree, _ = ckpt.restore(f"{init_dir}/{cfg.name}", 0, like)
    return jax.tree.map(jnp.asarray, tree)


def batch(cfg, step):
    return {k: jnp.asarray(v.numpy()) for k, v in
            synthetic.host_batch(cfg, sc.SEQ, sc.BATCH, step=step).items()}


def flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def train(arch, name, kw, steps, eager=False):
    cfg = configs.get_smoke(arch)
    params = params_of(cfg)
    opt = optim.get(name, **kw)
    state = opt.init(params)
    shapes = jax.eval_shape(opt.init, params)
    kws = dict(microbatches=sc.MICRO, remat=True, dtype=jnp.float32)
    b0 = batch(cfg, 0)
    with mesh:
        if eager:
            ps, os_, bs = ts.shardings_for(cfg, mesh, params, shapes, b0)
            params = jax.device_put(params, ps)
            state = jax.device_put(state, os_)
            step = ts.make_train_step(cfg, mesh, opt, **kws)
        else:
            step = ts.jit_train_step(cfg, mesh, opt, params, shapes, b0,
                                     **kws)
        losses, arrays = [], {}
        for s in range(steps):
            params, state, m = step(params, state, batch(cfg, s))
            losses.append(float(m["loss"]))
            arrays.update(flat(params, f"{s + 1}/"))
            arrays.update(flat(state, f"{s + 1}/opt/"))
    np.savez(f"{out}/{'kfac' if eager else 'train'}_{arch}.npz",
             losses=np.asarray(losses), **arrays)
    print(arch, name, losses, flush=True)


for arch in sc.TRAIN_ARCHS:
    train(arch, "adamw", sc.ADAMW, sc.STEPS)
jkfac = importlib.import_module("repro.optim.kfac_ca")
jkfac._spd_inv = jax.jit(jkfac._spd_inv)
train(sc.KFAC_ARCH, "kfac_ca", sc.KFAC, 1, eager=True)

lm.decode_step = functools.partial(lm.decode_step, dtype=jnp.float32)
for arch in sc.SERVE_ARCHS:
    cfg = configs.get_smoke(arch)
    params = params_of(cfg)
    cache = lm.init_cache(cfg, sc.BATCH, sc.CACHE, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    toks = jnp.asarray(rng.integers(0, cfg.vocab, (sc.BATCH, sc.PROMPT + 2)))
    arrays = {}
    with mesh:
        fn = ss.jit_decode_step(cfg, mesh, params, cache, sc.BATCH)
        for i, (a, b) in enumerate(((0, sc.PROMPT), (sc.PROMPT, sc.PROMPT + 1),
                                    (sc.PROMPT + 1, sc.PROMPT + 2))):
            logits, cache = fn(params, cache, toks[:, a:b])
            arrays[f"logits_{i}"] = np.asarray(logits, np.float64)
    np.savez(f"{out}/serve_{arch}.npz", **arrays)
    print("serve", arch, flush=True)

pmesh = Mesh(np.asarray(jax.devices()[:sc.WORLD]), ("pipe",))
S, M, B, d = sc.WORLD, 6, 2, 8
rng = np.random.default_rng(0)
Ws = jnp.asarray(rng.standard_normal((S, d, d)) / np.sqrt(d))
bs = jnp.asarray(rng.standard_normal((S, d)) * 0.1)
x = jnp.asarray(rng.standard_normal((M, B, d)))
stage = lambda p, h: jnp.tanh(h @ p[0] + p[1])
np.savez(f"{out}/pipeline.npz", out=np.asarray(pipeline_apply(
    stage, (Ws, bs), x, mesh=pmesh, axis="pipe"), np.float64))

cmesh = Mesh(np.asarray(jax.devices()[:sc.WORLD]), ("pod",))
g = jnp.asarray(np.random.default_rng(0).standard_normal((64, 64)),
                jnp.float32)


def body(g):
    key = jax.random.fold_in(jax.random.key(0), jax.lax.axis_index("pod"))
    return compress.psum_compressed(g, "pod", key)


np.savez(f"{out}/compress.npz", out=np.asarray(jax.jit(compat.shard_map(
    body, mesh=cmesh, in_specs=P(), out_specs=P()))(g), np.float64))
print("reference done")
'''


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _start(args, log, **env):
    """A subprocess writing its output to ``log``, in a session of its
    own, so that a timeout kills it and every rank it spawned."""
    with open(log, "w") as f:
        return subprocess.Popen(args, stdout=f, stderr=subprocess.STDOUT,
                                env=_env(**env), start_new_session=True)


def _finish(proc, log, timeout) -> tuple:
    """(exit code, output); the exit code is None when the session was
    killed at ``timeout``."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        return None, f"{log.read_text()}\nkilled at the deadline"
    return proc.returncode, log.read_text()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """((reference dir, (exit code, output)), (port dir, (exit code,
    output))): the port's selfcheck, then the reference, one after the
    other (each takes several cores; together they starved the test
    files running beside them), within ``DEADLINE_S``."""
    deadline = time.monotonic() + DEADLINE_S
    init = tmp_path_factory.mktemp("init")
    for arch in ARCHS:
        cfg = jconfigs.get_smoke(arch)
        jckpt.save(str(init / cfg.name), 0,
                   jlm.init(cfg, jax.random.key(0)))
    ref_dir = tmp_path_factory.mktemp("reference")
    port_dir = tmp_path_factory.mktemp("port")
    out = []
    for d, args, env in (
            (port_dir, ["-m", "repro_torch.train.selfcheck", "--device",
                        "cpu", "--out", str(port_dir), "--init", str(init)],
             {}),
            (ref_dir, ["-c", REFERENCE, str(init), str(ref_dir)],
             dict(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                  JAX_PLATFORMS="cpu"))):
        proc = _start([sys.executable] + args, d / "log.txt", **env)
        try:
            out.append((d, _finish(proc, d / "log.txt",
                                   max(deadline - time.monotonic(), 1.0))))
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return out[::-1]


def _log(out_dir, run) -> str:
    text = f"exit {run[0]}\n{run[1][-4000:]}"
    for log in sorted(out_dir.glob("ranks/rank*.log")):
        text += f"\n--- {log.name}\n{log.read_text()[-2000:]}"
    return text


def _load(runs, side, name):
    out_dir, run = runs[side]
    path = out_dir / f"{name}.npz"
    assert path.exists(), f"no {name} result:\n{_log(out_dir, run)}"
    return np.load(path)


def test_port_selfcheck_passes_on_every_rank(runs):
    """Every check passes on every rank: the sharded steps against the
    one-rank steps (1e-5), stored shards as their specs say, the
    pipeline, compression, and the (2, 2) -> (1, 4) checkpoint reshard
    bit for bit."""
    out_dir, run = runs[1]
    assert run[0] == 0 and "selfcheck: 0 failures" in run[1], \
        _log(out_dir, run)
    assert "ckpt reshard (2, 2) -> (1, 4): OK" in run[1]


def test_reference_side_ran(runs):
    out_dir, run = runs[0]
    assert run[0] == 0 and "reference done" in run[1], run[1][-4000:]


@pytest.mark.parametrize("kind,arch", [("train", a)
                                       for a in selfcheck.TRAIN_ARCHS]
                         + [("kfac", selfcheck.KFAC_ARCH)])
def test_sharded_step_matches_reference(runs, kind, arch):
    got, want = (_load(runs, side, f"{kind}_{arch}") for side in (1, 0))
    assert_close(got["losses"], want["losses"], STEP_TOL)
    keys = sorted(k for k in want.files if k != "losses")
    assert sorted(k for k in got.files
                  if k not in ("losses", "one_rank_losses")) == keys
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], STEP_TOL)


@pytest.mark.parametrize("kind,arch", [("train", a)
                                       for a in selfcheck.TRAIN_ARCHS]
                         + [("kfac", selfcheck.KFAC_ARCH)])
def test_sharded_step_matches_one_rank(runs, kind, arch):
    got = _load(runs, 1, f"{kind}_{arch}")
    assert_close(got["losses"], got["one_rank_losses"], 1e-5)


@pytest.mark.parametrize("arch", selfcheck.SERVE_ARCHS)
def test_sharded_decode_matches_reference(runs, arch):
    got, want = (_load(runs, side, f"serve_{arch}") for side in (1, 0))
    for i in range(3):
        g, w = got[f"logits_{i}"], want[f"logits_{i}"]
        assert g.shape == w.shape
        assert_close(g, w, LOGIT_TOL)


def test_pipeline_matches_reference(runs):
    got, want = (_load(runs, side, "pipeline")["out"] for side in (1, 0))
    assert_close(got, want, 1e-5)


def test_compressed_sum_matches_reference(runs):
    """Both packages' int8 sums (their own rounding draws) within 0.05
    of the largest entry of each other."""
    got, want = (_load(runs, side, "compress")["out"] for side in (1, 0))
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def _want_shapes(tree, specs, mesh):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    fspecs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(flat, fspecs):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                shape[d] //= int(np.prod([mesh.shape[a] for a in axes]))
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = shape
    return out


@pytest.mark.parametrize("arch", selfcheck.TRAIN_ARCHS)
def test_stored_shards_follow_reference_specs(runs, arch):
    """Each rank's stored parameter and adamw-state pieces have the
    shapes the reference's specs give on the (2, 2) mesh, and so do its
    decode caches."""
    shards = json.loads((runs[1][0] / "shards.json").read_text())
    mesh = abstract_mesh((2, 2), ("data", "model"))
    cfg = jconfigs.get_smoke(arch)
    params = jax.eval_shape(lambda: jlm.init(cfg, jax.random.key(0)))
    pspecs = jsr.param_specs(cfg, params, mesh)
    state = jax.eval_shape(
        __import__("repro.optim", fromlist=["get"]).get("adamw").init,
        params)
    want_p = _want_shapes(params, pspecs, mesh)
    want_o = _want_shapes(state, jts.opt_state_specs(state, params, pspecs),
                          mesh)
    assert len(shards[f"train_{arch}"]) == selfcheck.WORLD
    for rank in shards[f"train_{arch}"]:
        assert rank["params"] == want_p
        assert rank["opt"] == want_o
    if arch in selfcheck.SERVE_ARCHS:
        cache = jax.eval_shape(lambda: jlm.init_cache(
            cfg, selfcheck.BATCH, selfcheck.CACHE))
        want_c = _want_shapes(cache, jsr.cache_specs(cfg, cache, mesh),
                              mesh)
        for rank in shards[f"serve_{arch}"]:
            assert rank["cache"] == want_c


# each CLI rank runs the module as torchrun would, then leaves with
# os._exit, so that gloo's threads cannot abort it in the teardown
RANK_MAIN = ("import os, runpy, sys\n"
             "sys.argv = sys.argv[1:]\n"
             "runpy.run_module(sys.argv[0], run_name='__main__')\n"
             "sys.stdout.flush(); sys.stderr.flush(); os._exit(0)\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(module, args, world=selfcheck.WORLD) -> list:
    """Each rank's standard output of ``python -m module args`` in a
    world of ``world`` processes, torchrun's environment set by hand."""
    env = _env(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, module] + args,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append(out)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0]
    assert not failed, f"ranks {failed}\n" + "\n".join(
        o[-2000:] + e[-2000:] for o, e in zip(outs, errs))
    return outs


def _steps(out: str) -> list:
    return [re.sub(r" \d+ms", "", line) for line in out.splitlines()
            if line.startswith("step ")]


def test_train_cli_on_four_ranks(tmp_path, capsys):
    """``launch.train --mesh debug --compress`` under a launcher's world
    of four: the (1, 4) debug mesh, rank 0 alone printing, the losses of
    one process's run, the checkpoint gathered and written once."""
    args = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--mesh",
            "debug", "--compress", "--steps", "2", "--batch", "4", "--seq",
            "16"]
    outs = _ranks("repro_torch.launch.train",
                  args + ["--ckpt", str(tmp_path / "four")])
    assert "mesh={'data': 1, 'model': 4}" in outs[0]
    assert outs[0].rstrip().endswith("done")
    assert not any(o.strip() for o in outs[1:]), outs[1:]
    assert ckpt.latest_step(str(tmp_path / "four")) == 2
    train.main(args + ["--ckpt", str(tmp_path / "one")])
    one = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in one
    assert _steps(outs[0]) == _steps(one) and len(_steps(one)) == 2


def test_serve_cli_lm_on_four_ranks(capsys):
    """``launch.serve --workload lm --mesh debug`` on four ranks prints
    the tokens one process generates."""
    args = ["--workload", "lm", "--arch", "qwen3-1.7b", "--smoke",
            "--device", "cpu", "--mesh", "debug", "--batch", "4",
            "--prompt-len", "8", "--new-tokens", "4"]
    outs = _ranks("repro_torch.launch.serve", args)
    serve.main(args)
    one = capsys.readouterr().out
    seqs = [line for line in outs[0].splitlines() if line.startswith("seq")]
    assert len(seqs) == 4
    assert seqs == [line for line in one.splitlines()
                    if line.startswith("seq")]
    assert "mesh {'data': 1, 'model': 4}" in outs[0]
    assert not any(o.strip() for o in outs[1:]), outs[1:]
