"""The port's MoE (``models.layers``: ``init_moe``, ``moe_apply`` and its
groups, ``_load_balance_loss``; ``models.lm``'s attention block with
experts and arctic's dense residual MLP) against the JAX package's, on
the CPU, at grok-1-314b's and arctic-480b's smoke configs.

Both sides run on the SAME weights: the reference draws them and
``convert.tree_from_reference`` carries them across.  Tolerances, each
``rtol = tol`` and ``atol = tol`` times the largest entry compared
(``torch_parity.assert_close``): fp32 layers, logits and losses 2e-5;
fp32 gradients 1e-4; bf16 2e-2; the port's decode against its own
forward 2e-3 at the no-drop capacity (``moe_capacity = n_experts``:
which tokens a capacity drops depends on what is routed together,
tests/test_models_smoke.py); the chosen experts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs, convert
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim.tree import leaves_with_path
from repro_torch.train import train_step
from torch_parity import assert_close

TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
DECODE_TOL = 2e-3
MOE = ["grok-1-314b", "arctic-480b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TDT_TOL = {"float32": TOL, "bfloat16": BF16_TOL}


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _carry(jtree):
    return convert.tree_from_reference(jax.tree.map(np.asarray, jtree))


def _pair(arch, seed=0, **replace):
    """(reference config, port config, reference params, port params)
    of the smoke config, the weights drawn by the reference."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **replace)
    jparams = jlm.init(jcfg, jax.random.key(seed))
    return (jcfg, configs.ModelConfig(**dataclasses.asdict(jcfg)), jparams,
            _carry(jparams))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


class Experts:
    """Records the experts each routing call picks (one call a group;
    the reference maps its groups under ``lax.map``, so a traced call
    records through an ordered debug callback)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def _record(self, idx):
        self.calls.append(np.asarray(idx))

    def __call__(self, gates, k):
        vals, idx = self.fn(gates, k)
        if isinstance(idx, jax.core.Tracer):
            jax.debug.callback(self._record, idx, ordered=True)
        else:
            self._record(idx)
        return vals, idx


# ------------------------------ routing ------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_orders_ties_as_the_reference(k):
    """Rows with planted ties (all equal, a three-way tie below the
    top, two pairs) and random rows: the same values and experts as
    ``jax.lax.top_k``, the lower expert first among equal gates."""
    rng = np.random.default_rng(0)
    rows = np.concatenate([
        np.array([[0.25, 0.25, 0.25, 0.25, 0.0],
                  [0.1, 0.3, 0.3, 0.3, 0.0],
                  [0.4, 0.1, 0.4, 0.1, 0.0],
                  [0.0, 0.2, 0.0, 0.2, 0.6],
                  [0.1, 0.1, 0.1, 0.1, 0.6]], np.float32),
        rng.random((6, 5), np.float32)])
    wv, wi = jax.lax.top_k(jnp.asarray(rows), k)
    gv, gi = L._top_k(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(1)
    gates = rng.random((24, 8)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    ik = np.stack([rng.permutation(8)[:2] for _ in range(24)])
    want = JL._load_balance_loss(jnp.asarray(gates), jnp.asarray(ik), 8)
    got = L._load_balance_loss(torch.from_numpy(gates),
                               torch.from_numpy(ik), 8)
    assert_close(_np(got), _np(want), TOL)


def _moe_io(arch, S, seed=0, **replace):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **replace)
    jp = JL.init_moe(jax.random.key(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    return jcfg, configs.ModelConfig(**dataclasses.asdict(jcfg)), jp, \
        _carry(jp), x


def _run_both(monkeypatch, jcfg, cfg, jp, p, x, dtype):
    """Both packages' ``moe_apply`` on x in ``dtype``, each routing
    call's experts recorded: (y, aux, experts) for each side."""
    jrec, trec = Experts(jax.lax.top_k), Experts(L._top_k)
    monkeypatch.setattr(jax.lax, "top_k", jrec)
    monkeypatch.setattr(L, "_top_k", trec)
    wy, waux = JL.moe_apply(jp, jnp.asarray(x).astype(JDT[dtype]), jcfg)
    gy, gaux = L.moe_apply(p, torch.from_numpy(x).to(TDT[dtype]), cfg)
    monkeypatch.undo()
    return (wy, waux, jrec.calls), (gy, gaux, trec.calls)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grouped", [False, True], ids=["single", "groups"])
def test_moe_apply_matches_reference(arch, dtype, grouped, monkeypatch):
    """y, aux and every group's chosen experts at the default capacity
    (1.25), where some expert overflows and tokens are dropped.
    Grouped: ``MOE_GROUP`` patched to 16 on both sides, 64 tokens in 4
    groups, each with its own capacity, aux their mean."""
    S = 32 if grouped else 8
    jcfg, cfg, jp, p, x = _moe_io(arch, S, seed=0)
    if grouped:
        monkeypatch.setattr(JL, "MOE_GROUP", 16)
        monkeypatch.setattr(L, "MOE_GROUP", 16)
    (wy, waux, wex), (gy, gaux, gex) = _run_both(
        monkeypatch, jcfg, cfg, jp, p, x, dtype)
    assert gy.dtype == TDT[dtype] and gy.shape == x.shape
    assert len(gex) == len(wex) == (4 if grouped else 1)
    for g, w in zip(gex, wex):
        np.testing.assert_array_equal(g, w)
    T = 16 if grouped else 2 * S
    cap = int(cfg.moe_capacity * cfg.topk * T / cfg.n_experts)
    assert max(np.bincount(e.ravel()).max() for e in gex) > cap, \
        "no expert overflowed: the drop path went untested"
    assert_close(_np(gy), _np(wy), TDT_TOL[dtype])
    assert_close(_np(gaux), _np(waux), TDT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_planted_ties_pick_the_reference_experts(dtype, monkeypatch):
    """Router columns 1 and 2 equal (and 0 and 3): every token's gates
    tie exactly in pairs, in fp32 and in bf16.  The experts, their
    order within each token (which decides the queue positions and so
    the drops at capacity 1.25) and y are the reference's."""
    jcfg, cfg, jp, p, x = _moe_io("grok-1-314b", 16, seed=2)
    r = np.asarray(jp["router"]).copy()
    r[:, 2], r[:, 3] = r[:, 1], r[:, 0]
    jp = dict(jp, router=jnp.asarray(r))
    p = dict(p, router=torch.from_numpy(r))
    (wy, waux, wex), (gy, gaux, gex) = _run_both(
        monkeypatch, jcfg, cfg, jp, p, x, dtype)
    np.testing.assert_array_equal(gex[0], wex[0])
    # every token picked one tied pair, its lower expert first
    assert set(map(tuple, gex[0].tolist())) <= {(0, 3), (1, 2)}
    assert_close(_np(gy), _np(wy), TDT_TOL[dtype])
    assert_close(_np(gaux), _np(waux), TDT_TOL[dtype])


# ---------------------------- the models ----------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_model_matches_reference(arch):
    """fp32 logits at 2e-5, the loss (cross entropy + 0.01 aux summed
    over the blocks) at 2e-5 and every gradient leaf (same paths) at
    1e-4, at the default capacity."""
    jcfg, cfg, jparams, params = _pair(arch)
    toks = _tokens(cfg, 2, 16, seed=0)
    labels = _tokens(cfg, 2, 16, seed=1)
    want = jax.jit(lambda p, t: jlm.forward(p, jcfg, t, dtype=jnp.float32))(
        jparams, jnp.asarray(toks))
    got = lm.forward(params, cfg, torch.from_numpy(toks),
                     dtype=torch.float32)
    assert_close(_np(got[0]), _np(want[0]), TOL)
    assert_close(_np(got[1]), _np(want[1]), TOL)
    assert float(got[1]) > 0
    b = {"tokens": toks, "labels": labels}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jlm.loss_fn(p, jcfg, bb, dtype=jnp.float32)))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = train_step._value_and_grad(
        lambda p, bb: lm.loss_fn(p, cfg, bb, dtype=torch.float32), params,
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert_close(_np(loss), _np(jloss), TOL)
    got = list(leaves_with_path(grads))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert any("['moe']['gate']" in p for p, _ in got)
    if cfg.dense_residual:
        assert any("['mlp']['down']" in p for p, _ in got)
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert_close(_np(g), _np(w), GRAD_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_own_forward(arch):
    """Token by token through the cache, the last position's logits
    against the full forward's, fp32, at the no-drop capacity."""
    _, cfg, _, params = _pair(arch, seed=1)
    cfg = dataclasses.replace(cfg, moe_capacity=float(cfg.n_experts))
    tokens = torch.from_numpy(_tokens(cfg, 2, 8, seed=3))
    full, _ = lm.forward(params, cfg, tokens, dtype=torch.float32)
    cache = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for t in range(8):
        last, cache = lm.decode_step(params, cfg, tokens[:, t:t + 1], cache,
                                     dtype=torch.float32)
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_step_matches_reference(arch):
    """A 3-token prefill then 3 single-token steps at the default
    capacity: each step's logits (fp32, 2e-5) and the caches against
    the reference's."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2)
    tokens = _tokens(cfg, 2, 6, seed=4)
    jstep = jax.jit(lambda p, c, tok: jlm.decode_step(p, jcfg, tok, c,
                                                      dtype=jnp.float32))
    jc = jlm.init_cache(jcfg, 2, 6, dtype=jnp.float32)
    tc = lm.init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    for t0, t1 in ((0, 3), (3, 4), (4, 5), (5, 6)):
        want, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t0:t1]))
        got, tc = lm.decode_step(params, cfg,
                                 torch.from_numpy(tokens[:, t0:t1]), tc,
                                 dtype=torch.float32)
        assert_close(_np(got), _np(want), TOL)
    for (path, g), (_, w) in zip(leaves_with_path(tc),
                                 jax.tree_util.tree_leaves_with_path(jc)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        assert_close(_np(g), _np(w), TOL)


# ------------------------------- CLIs -------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_train_cli_trains_moe(arch, tmp_path, capsys):
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16", "--ckpt",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={arch.split('-')[0]}" in out
    assert "step     1 loss" in out and out.rstrip().endswith("done")


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_lm_serves_moe(arch, capsys):
    serve.main(["--workload", "lm", "--arch", arch, "--smoke", "--device",
                "cpu", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("seq 0: [") and lines[1].startswith("seq 1:")
    assert len(eval(lines[0].split(": ", 1)[1])) == 4
    assert lines[-1].startswith("8 tokens in ") and "tok/s" in lines[-1]
