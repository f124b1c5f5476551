"""The port's trainer (``repro_torch.data``, ``train.train_step``,
``train.checkpoint``, ``train.ft``, ``launch.train``) and the LM serving
CLI against the JAX package's, on the CPU.

Step parity: both packages start from the SAME parameters and
optimizer state (the reference's, carried across with
``convert.tree_from_reference``) and take one and two steps on the
same NumPy batches, each side on its own from there; the reference's
``adamw`` step runs under ``jax.jit`` (a one-device mesh), its
``kfac_ca`` step eagerly around a jitted SPD inverse (``_steps``).
Tolerances, ``rtol = tol`` and ``atol = tol`` times the largest entry
compared (``torch_parity.assert_close``): the fp32 loss 2e-5;
parameters and optimizer state after each step 1e-4; checkpoints,
restarts and ``remat`` bit for bit.
"""

import importlib
import os
import subprocess
import sys
import threading
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.data import synthetic
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.optim.tree import leaves_with_path, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import ft
from repro_torch.train import train_step as ts
from torch_parity import assert_close

TOL = 2e-5
STEP_TOL = 1e-4
ARCH = "qwen3-1.7b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

joptim = importlib.import_module("repro.optim")
jkfac = importlib.import_module("repro.optim.kfac_ca")
optim = importlib.import_module("repro_torch.optim")
# the reference tests' K-FAC on a smoke LM (tests/test_substrate.py),
# on smollm's smoke config (qwen3's orders 64 and 128 take longer
# through the blocked Cholesky and six doubling levels)
OPTIMIZERS = {"adamw": dict(lr=1e-3),
              "kfac_ca": dict(lr=1e-2, min_dim=8, max_dim=512)}
STEP_ARCH = {"adamw": ARCH, "kfac_ca": "smollm-360m"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests.  They run thousands of
    small CPU ops (the plain K-FAC inverses, the recurrences); beside
    other test processes on the same cores, an OpenMP team waits at
    every op for its descheduled threads, which made the kfac_ca steps
    here tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_device_mesh():
    """The reference's one-device ("data", "model") mesh, its axes Auto
    (``jax.make_mesh`` makes them Explicit on jax 0.9, where the
    microbatch step's sharding constraint refuses them)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _np_batch(cfg, step, B=4, S=16):
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    return {"tokens": toks[:, :S], "labels": toks[:, 1:]}


def _cfgs(arch=ARCH):
    return jconfigs.get_smoke(arch), configs.get_smoke(arch)


def _same_tree(got, want, tol):
    """Every leaf of a port tree against the reference's: same paths,
    shapes and dtypes, values within ``tol`` (exact with tol 0)."""
    g = list(leaves_with_path(got))
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        if tol:
            assert_close(a.numpy(), b, tol)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


def _steps(name, microbatches=1, steps=2, remat=False):
    """Run ``steps`` train steps in both packages from the reference's
    initial state; returns [(reference (params, state, metrics), port
    (...))], one pair a step.

    The reference's ``kfac_ca`` step runs eagerly with its SPD inverse
    (``_spd_inv``: a blocked Cholesky and two It-Inv solves, 28 of them
    a whitened tensor in the Denman-Beavers loop) under ``jax.jit``, in
    this process only: one compiled program per factor order.  Jitting
    the whole step inlines every one of those calls into a 10 MB module
    that takes ~45 s to trace and ~55 s to compile on one core, and
    several times that when the tests share the cores with parallel
    workers.  The same operations run on the same inputs either way."""
    jcfg, cfg = _cfgs(STEP_ARCH[name])
    jopt = joptim.get(name, **OPTIMIZERS[name])
    opt = optim.get(name, **OPTIMIZERS[name])
    jstep = jts.make_train_step(
        jcfg, _one_device_mesh(), jopt, microbatches=microbatches,
        remat=remat, dtype=jnp.float32)
    if name != "kfac_ca":
        jstep = jax.jit(jstep)
    step = ts.make_train_step(cfg, opt, microbatches=microbatches,
                              remat=remat, dtype=torch.float32)
    jp = jlm.init(jcfg, jax.random.key(0))
    js = jopt.init(jp)
    p = convert.tree_from_reference(jax.tree.map(np.asarray, jp))
    s = convert.tree_from_reference(jax.tree.map(np.asarray, js))
    out = []
    with mock.patch.object(jkfac, "_spd_inv", jax.jit(jkfac._spd_inv)):
        for i in range(steps):
            b = _np_batch(cfg, i)
            jp, js, jm = jstep(jp, js,
                               {k: jnp.asarray(v) for k, v in b.items()})
            p, s, m = step(p, s,
                           {k: torch.from_numpy(v) for k, v in b.items()})
            out.append(((jp, js, jm), (p, s, m)))
    return out


# ------------------------------- data -------------------------------

def test_host_batch_deterministic_disjoint_and_elastic():
    cfg = configs.get_smoke(ARCH)
    b1 = synthetic.host_batch(cfg, 16, 8, step=3, host=0, n_hosts=2)
    b2 = synthetic.host_batch(cfg, 16, 8, step=3, host=0, n_hosts=2)
    assert torch.equal(b1["tokens"], b2["tokens"])           # deterministic
    b3 = synthetic.host_batch(cfg, 16, 8, step=3, host=1, n_hosts=2)
    assert not torch.equal(b1["tokens"], b3["tokens"])       # disjoint
    b4 = synthetic.host_batch(cfg, 16, 8, step=4, host=0, n_hosts=2)
    assert not torch.equal(b1["tokens"], b4["tokens"])       # per-step
    # elastic re-partition: 1-host global == concat of 2-host slices
    g1 = synthetic.host_batch(cfg, 16, 8, step=3, host=0, n_hosts=1)
    assert torch.equal(g1["tokens"], torch.cat([b1["tokens"],
                                                b3["tokens"]]))
    # labels are next-token shifted; shapes and keys as the reference's
    full = synthetic.host_batch(cfg, 16, 4, step=0)
    assert torch.equal(full["tokens"][:, 1:], full["labels"][:, :-1])
    assert full["tokens"].shape == full["labels"].shape == (4, 16)
    assert int(full["tokens"].max()) < cfg.vocab
    with pytest.raises(ValueError):
        synthetic.host_batch(cfg, 16, 5, step=0, n_hosts=2)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-tiny"])
def test_host_batch_keys_and_shapes_match_reference(arch):
    from repro.data import synthetic as jsynthetic
    jcfg, cfg = _cfgs(arch)
    want = jsynthetic.host_batch(jcfg, 8, 2, step=1)
    got = synthetic.host_batch(cfg, 8, 2, step=1)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k


def test_prefetcher():
    cfg = configs.get_smoke(ARCH)
    pf = synthetic.Prefetcher(cfg, 8, 4, start_step=5, depth=2)
    s0, b0 = next(pf)
    s1, b1 = next(pf)
    pf.close()
    assert (s0, s1) == (5, 6)
    assert torch.equal(b0["tokens"],
                       synthetic.host_batch(cfg, 8, 4, step=5)["tokens"])
    assert torch.equal(b1["labels"],
                       synthetic.host_batch(cfg, 8, 4, step=6)["labels"])
    assert not pf._t.is_alive()


# ---------------------------- train step ----------------------------

@pytest.mark.parametrize("name", ["adamw", "kfac_ca"])
def test_train_step_matches_reference(name):
    """One and two steps: loss 2e-5, parameters and optimizer state
    1e-4, step counters exact."""
    for i, ((jp, js, jm), (p, s, m)) in enumerate(_steps(name)):
        assert_close(m["loss"].numpy(), np.asarray(jm["loss"]), TOL)
        assert_close(m["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                     STEP_TOL)
        _same_tree(p, jp, STEP_TOL)
        _same_tree(s, js, STEP_TOL)
        assert int(s["step"]) == int(js["step"]) == i + 1
    if name == "kfac_ca":     # the stacked units carry their Kronecker pairs
        A, B = s["kron"]["units"]["b0"]["mlp"]["gate"]
        assert A.shape == (2, 60, 60) and B.shape == (2, 96, 96)


def test_train_step_microbatches_match_reference():
    """microbatches = 2 against the reference's own two-microbatch
    step (adamw)."""
    for (jp, js, jm), (p, s, m) in _steps("adamw", microbatches=2):
        assert_close(m["loss"].numpy(), np.asarray(jm["loss"]), TOL)
        _same_tree(p, jp, STEP_TOL)
        _same_tree(s, js, STEP_TOL)


def test_train_step_remat_is_bit_identical():
    """remat recomputes each unit in the backward pass: loss, gradients
    and the step's parameters are the same bits as without it."""
    cfg = configs.get_smoke(ARCH)
    params = lm.init(cfg, 3, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _np_batch(cfg, 0).items()}
    outs = []
    for remat in (False, True):
        loss, grads = ts._value_and_grad(
            lambda p, bb: lm.loss_fn(p, cfg, bb, remat=remat,
                                     dtype=torch.float32), params, b)
        opt = optim.get("adamw")
        step = ts.make_train_step(cfg, opt, remat=remat,
                                  dtype=torch.float32)
        p2, _, _ = step(params, opt.init(params), b)
        outs.append((loss, grads, p2))
    (l0, g0, p0), (l1, g1, p1) = outs
    assert torch.equal(l0, l1)
    for (path, a), (_, c) in zip(leaves_with_path(g0), leaves_with_path(g1)):
        assert torch.equal(a, c), path
    for (path, a), (_, c) in zip(leaves_with_path(p0), leaves_with_path(p1)):
        assert torch.equal(a, c), path


def test_train_step_refusals():
    """``compress_grads`` builds and leaves the gradients as they are, as
    the reference's jitted step does (``tag_for_compression`` is the
    identity), on one device and on a mesh with a "pod" axis; an MoE
    config (A15e, ported) builds a step that takes one."""
    from repro_torch.core import comm
    cfg = configs.get_smoke(ARCH)
    opt = optim.get("adamw")
    params = lm.init(cfg, 0, device="cpu")
    batch = synthetic.host_batch(cfg, 8, 2, step=0)
    pod = comm.make_named_mesh((1, 1, 1), ("pod", "data", "model"))
    outs = []
    for compress in (False, True):
        step = ts.make_train_step(cfg, opt, remat=False,
                                  compress_grads=compress)
        sharded = ts.jit_train_step(cfg, pod, opt, params, opt.init(params),
                                    batch, remat=False,
                                    compress_grads=compress)
        outs.append([f(params, opt.init(params), batch)
                     for f in (step, sharded)])
    for got, want in zip(outs[1], outs[0]):
        _assert_bits(got[0], want[0])
        assert torch.equal(got[2]["grad_norm"], want[2]["grad_norm"])
    grok = configs.get_smoke("grok-1-314b")
    params = lm.init(grok, 0, device="cpu")
    step = ts.make_train_step(grok, opt, remat=False)
    _, _, metrics = step(params, opt.init(params),
                         synthetic.host_batch(grok, 8, 2, step=0))
    assert torch.isfinite(metrics["loss"])


# ---------------------------- checkpoints ----------------------------

def _state(name="kfac_ca"):
    cfg = configs.get_smoke(ARCH)
    params = lm.init(cfg, 0, device="cpu")
    opt = optim.get(name, **OPTIMIZERS[name])
    state = opt.init(params)
    # a non-zero state: one step's worth
    p, s, _ = ts.make_train_step(cfg, opt, remat=False)(
        params, state, synthetic.host_batch(cfg, 16, 4, step=0))
    return {"params": p, "opt": s}


def _assert_bits(got, want):
    g, w = list(leaves_with_path(got)), list(leaves_with_path(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_roundtrip_bitexact(tmp_path):
    state = _state()
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 3, state)
    ckpt.save(d, 9, state)
    assert ckpt.latest_step(d) == 9
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)
    restored, step = ckpt.restore(d, 9, like)
    assert step == 9
    _assert_bits(restored, state)
    assert sorted(os.listdir(os.path.join(d, "step_00000009"))) == \
        ["host0.npz", "manifest.json"]
    # bf16 leaves keep their bits through the uint16 view
    bf = {"w": torch.randn(5, 3).to(torch.bfloat16)}
    ckpt.save(d, 10, bf)
    back, _ = ckpt.restore(d, 10, bf)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             bf["w"])


def test_checkpoint_async_and_completeness(tmp_path):
    state = {"x": torch.arange(100), "y": [torch.ones(3), torch.zeros(())]}
    d = str(tmp_path)
    t = ckpt.save(d, 1, state, blocking=False)
    assert isinstance(t, threading.Thread)
    t.join()
    assert ckpt.latest_step(d) == 1
    restored, _ = ckpt.restore(d, 1, state)
    _assert_bits(restored, state)
    # a partial checkpoint (no manifest) is never 'latest'
    os.makedirs(os.path.join(d, "step_00000005"))
    assert ckpt.latest_step(d) == 1


@pytest.mark.parametrize("name", ["adamw", "kfac_ca"])
def test_checkpoints_cross_between_packages(name, tmp_path):
    """A checkpoint the reference wrote restores into the port bit for
    bit, and one the port wrote into the reference."""
    jcfg, cfg = _cfgs()
    jopt = joptim.get(name, **OPTIMIZERS[name])
    jp = jlm.init(jcfg, jax.random.key(1))
    jstate = {"p": jp, "o": jopt.init(jp)}
    jstate["o"] = jax.tree.map(lambda a: a + 1 if a.ndim == 0 else a * 0.5
                               + 0.25, jstate["o"])
    jckpt.save(str(tmp_path / "ref"), 4, jstate)
    like = convert.tree_from_reference(jax.tree.map(np.asarray, jstate))
    got, step = ckpt.restore(str(tmp_path / "ref"), 4, like)
    assert step == 4
    _same_tree(got, jstate, 0)

    opt = optim.get(name, **OPTIMIZERS[name])
    p = lm.init(cfg, 2, device="cpu")
    state = {"p": p, "o": opt.init(p)}
    ckpt.save(str(tmp_path / "port"), 6, state)
    jlike = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         jstate)
    back, jstep_ = jckpt.restore(str(tmp_path / "port"), 6, jlike)
    assert jstep_ == 6
    _same_tree(state, back, 0)


def test_train_restart_bitexact(tmp_path):
    """Kill a training run mid-way, restart from its checkpoint: the
    final params equal an uninterrupted run's, bit for bit."""
    cfg = configs.get_smoke("smollm-360m")
    opt = optim.get("adamw", lr=1e-3)
    step = ts.make_train_step(cfg, opt, remat=False, dtype=torch.float32)

    def run(n_steps, params, state, start=0):
        for i in range(start, n_steps):
            b = synthetic.host_batch(cfg, 16, 4, step=i)
            params, state, _ = step(params, state, b)
        return params, state

    p0 = lm.init(cfg, 0, device="cpu")
    s0 = opt.init(p0)
    ref, _ = run(6, p0, s0)
    d = str(tmp_path)
    p, s = run(3, p0, s0)                # run 3 steps, checkpoint, 'crash'
    ckpt.save(d, 3, {"p": p, "s": s})
    restored, st = ckpt.restore(d, ckpt.latest_step(d), {"p": p0, "s": s0})
    p2, _ = run(6, restored["p"], restored["s"], start=st)
    _assert_bits(p2, ref)


# ------------------------- fault tolerance -------------------------

def test_restart_loop_resumes_and_bounds():
    calls = {"n": 0}

    def restore_fn():
        return {"start": calls["n"]}

    def train_fn(state):
        calls["n"] += 1
        if calls["n"] < 3:
            raise ft.WorkerFailure("injected")
        return "done"

    restarts_seen = []
    out, restarts = ft.run_with_restarts(train_fn, restore_fn=restore_fn,
                                         max_restarts=5,
                                         on_restart=restarts_seen.append)
    assert out == "done" and restarts == 2 and restarts_seen == [1, 2]

    calls["n"] = 0

    def always_fail(state):
        calls["n"] += 1
        raise ft.WorkerFailure("injected")

    with pytest.raises(ft.WorkerFailure):
        ft.run_with_restarts(always_fail, restore_fn=restore_fn,
                             max_restarts=2)
    assert calls["n"] == 3    # 1 try + 2 restarts


def test_straggler_detection_and_heartbeat(tmp_path):
    mon = ft.StepMonitor(n_hosts=4, straggler_factor=1.5)
    for _ in range(10):
        for h, t in enumerate([1.0, 1.05, 0.95, 2.5]):
            mon.record(h, t)
    assert mon.stragglers() == [3]
    mon2 = ft.StepMonitor(n_hosts=2)
    mon2.record(0, 1.0)
    assert mon2.stragglers() == []   # not enough data
    hb = ft.Heartbeat(str(tmp_path), host=1)
    assert ft.Heartbeat.last(str(tmp_path), 1) is None
    hb.beat(7)
    assert ft.Heartbeat.last(str(tmp_path), 1)[0] == 7


# ------------------------------- CLIs -------------------------------

def test_train_cli_finishes_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    flags = ["--arch", ARCH, "--smoke", "--device", "cpu", "--optimizer",
             "kfac_ca", "--ckpt", d, "--batch", "2", "--seq", "16"]
    train.main(flags + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     2 loss" in out
    assert out.rstrip().endswith("done") and ckpt.latest_step(d) == 3
    train.main(flags + ["--steps", "5", "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step     4 loss" in out
    assert "step     0 loss" not in out and ckpt.latest_step(d) == 5


def test_train_cli_joins_its_async_save(tmp_path, monkeypatch, capsys):
    """--steps a multiple of --ckpt-every: each save starts after the
    last one's thread ended, the last step's async save is joined, and
    no step is written twice."""
    d = str(tmp_path / "ckpt")
    calls, threads, real = [], [], ckpt.save

    def save(ckpt_dir, step, state, *, blocking=True, **kw):
        assert not any(t.is_alive() for t in threads)
        calls.append((step, blocking))
        t = real(ckpt_dir, step, state, blocking=blocking, **kw)
        threads.extend([t] if t is not None else [])
        return t

    monkeypatch.setattr(ckpt, "save", save)
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt", d,
                "--batch", "2", "--seq", "16", "--steps", "2",
                "--ckpt-every", "1"])
    assert capsys.readouterr().out.rstrip().endswith("done")
    assert calls == [(1, False), (2, False)]
    assert not any(t.is_alive() for t in threads)
    assert ckpt.latest_step(d) == 2
    assert sorted(os.listdir(os.path.join(d, "step_00000002"))) == [
        "host0.npz", "manifest.json"]


def test_train_cli_runs_as_a_module_without_jax(tmp_path):
    """``python -m repro_torch.launch.train`` on the CPU, in a process
    that never imports JAX or the reference (one OpenMP thread, as this
    file's fixture pins its own process: beside other test processes
    an OpenMP team's barrier at each of the K-FAC step's small ops took
    it past the timeout)."""
    code = ("import runpy, sys\n"
            "sys.argv = ['train'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.train', "
            "run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'repro'))\n"
            "    assert not bad, bad\n")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", ARCH, "--smoke", "--device",
         "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
         "--optimizer", "kfac_ca", "--ckpt", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "opt=kfac_ca" in out.stdout and "done" in out.stdout


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "single"], "needs a world of 256 ranks"),
    (["--compress"], None),
    (["--arch", "preset-100m"], "no config"),
    (["--arch", "recurrentgemma-2b", "--mesh", "multi"],
     "needs a world of 512 ranks"),
])
def test_train_cli_refusals(flags, message, tmp_path, capsys):
    """The production meshes need their 256 or 512 ranks; ``--compress``
    trains (one rank: no "pod" axis, the gradients as they are)."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
            "--ckpt", str(tmp_path)]
    if message is None:
        train.main(argv + flags + ["--batch", "2", "--seq", "8"])
        assert capsys.readouterr().out.rstrip().endswith("done")
        assert ckpt.latest_step(str(tmp_path)) == 1
        return
    with pytest.raises(SystemExit):
        train.main(argv + flags)
    assert message in capsys.readouterr().err
    assert ckpt.latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-vl-72b"])
def test_serve_cli_lm_prints_tokens(arch, capsys):
    serve.main(["--workload", "lm", "--arch", arch, "--smoke", "--device",
                "cpu", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("seq 0: [") and lines[1].startswith("seq 1:")
    assert len(eval(lines[0].split(": ", 1)[1])) == 4
    assert lines[-1].startswith("8 tokens in ") and "tok/s" in lines[-1]


@pytest.mark.parametrize("flags,message", [
    (["--arch", ARCH, "--mesh", "multi"], "needs a world of 512 ranks"),
    (["--arch", "whisper-tiny"], "encoder-decoder"),
    ([], "--arch is required"),
])
def test_serve_cli_lm_refusals(flags, message, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--workload", "lm", "--smoke", "--device", "cpu"]
                   + flags)
    assert message in capsys.readouterr().err
