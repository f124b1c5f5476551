"""The port's recurrent blocks (``models.layers``: the RG-LRU's
``_rg_lru`` and ``rec_apply``, the chunkwise mLSTM, the sLSTM; their
caches and ``models.lm``'s rec, mlstm and slstm blocks) against the JAX
package's, on the CPU, at recurrentgemma-2b's and xlstm-1.3b's smoke
configs.

Both sides run on the SAME weights: the reference draws them and
``convert.tree_from_reference`` carries them across.  Tolerances, each
``rtol = tol`` and ``atol = tol`` times the largest entry compared
(``torch_parity.assert_close``): fp32 layers, states, logits and
losses 2e-5; fp32 gradients 1e-4; bf16 2e-2; the port's decode
against its own forward 2e-3 (tests/test_models_smoke.py's bound).
The reference's layers run under ``jax.jit`` (the config static): its
eager scans compile every primitive on first use, seconds a call.
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
RECURRENT = ["recurrentgemma-2b", "xlstm-1.3b"]
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


def _port_cfg(jcfg):
    return configs.ModelConfig(**dataclasses.asdict(jcfg))


def _pair(arch, seed=0):
    jcfg = jconfigs.get_smoke(arch)
    jparams = jlm.init(jcfg, jax.random.key(seed))
    return jcfg, _port_cfg(jcfg), jparams, _carry(jparams)


def _x(cfg, B, S, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def _same_states(got: dict, want: dict, tol, dtypes=True):
    assert sorted(got) == sorted(want)
    for k in got:
        if dtypes:
            assert str(got[k].dtype).removeprefix("torch.") \
                == str(want[k].dtype), k
        assert_close(_np(got[k]), _np(want[k]), tol)


# ------------------------------ RG-LRU ------------------------------

@pytest.mark.parametrize("S", [1, 7, 1000])
def test_linear_scan_matches_a_sequential_loop(S):
    """The doubling scan against h[t] = a[t] h[t-1] + b[t] step by step,
    in fp64, with a near 1 (long memory) and near 0."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 3)) ** 0.01
    a[:, :, 2] = rng.uniform(0.0, 0.1, (2, S))
    b = rng.standard_normal((2, S, 3))
    want = np.zeros_like(b)
    h = np.zeros((2, 3))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = L._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [False, True], ids=["zero", "carried"])
def test_rg_lru_matches_reference(dtype, h0):
    """h (in x's dtype) and the last state (fp32), from zero and from a
    carried state."""
    rng = np.random.default_rng(2)
    x, ig, rg = (rng.standard_normal((2, 12, 16)).astype(np.float32)
                 for _ in range(3))
    lam = rng.uniform(0.9, 0.999, 16).astype(np.float32)
    h = rng.standard_normal((2, 16)).astype(np.float32) if h0 else None
    jd, td = JDT[dtype], TDT[dtype]
    want, wlast = jax.jit(JL._rg_lru)(
        *(jnp.asarray(t).astype(jd) for t in (x, ig, rg)), jnp.asarray(lam),
        None if h is None else jnp.asarray(h))
    got, glast = L._rg_lru(*(torch.from_numpy(t).to(td)
                             for t in (x, ig, rg)),
                           torch.from_numpy(lam),
                           None if h is None else torch.from_numpy(h))
    assert got.dtype == td and glast.dtype == torch.float32
    assert_close(_np(got), _np(want), TDT_TOL[dtype])
    assert_close(_np(glast), _np(wlast), TDT_TOL[dtype])


def _rec_pair(seed=0):
    jcfg = jconfigs.get_smoke("recurrentgemma-2b")
    jp = JL.init_rec(jax.random.key(seed), jcfg)
    return jcfg, _port_cfg(jcfg), jp, _carry(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rec_apply_matches_reference(dtype):
    """Without a cache, then through one: a 5-token prefill and three
    single steps, y and the states (h, conv) after each.  The reference
    allocates conv in bf16 and returns it in the compute dtype; the
    port holds it in fp32 (the same values: every bf16 value is an fp32
    one), so the dtypes agree from the first fp32 step on."""
    jcfg, cfg, jp, p = _rec_pair()
    x = _x(cfg, 2, 8, seed=3)
    jd, td = JDT[dtype], TDT[dtype]
    rec_apply = jax.jit(JL.rec_apply, static_argnums=2)
    want, _ = rec_apply(jp, jnp.asarray(x).astype(jd), jcfg)
    got, none = L.rec_apply(p, torch.from_numpy(x).to(td), cfg)
    assert none is None and got.dtype == td
    assert_close(_np(got), _np(want), TDT_TOL[dtype])
    jc = JL.init_rec_cache(jcfg, 2)
    tc = L.init_rec_cache(cfg, 2)
    for t0, t1 in ((0, 5), (5, 6), (6, 7), (7, 8)):
        want, jc = rec_apply(jp, jnp.asarray(x[:, t0:t1]).astype(jd),
                             jcfg, cache=jc)
        got, out = L.rec_apply(p, torch.from_numpy(x[:, t0:t1]).to(td),
                               cfg, cache=tc)
        assert out is tc
        assert_close(_np(got), _np(want), TDT_TOL[dtype])
        _same_states(tc, jc, TDT_TOL[dtype], dtypes=dtype == "float32")


# ------------------------------ xLSTM ------------------------------

def _mlstm_io(seed=0, S=24):
    jcfg = jconfigs.get_smoke("xlstm-1.3b")
    jp = JL.init_mlstm(jax.random.key(seed), jcfg)
    return jcfg, _port_cfg(jcfg), jp, _carry(jp), _x(jcfg, 2, S, seed + 5)


def test_mlstm_chunk_scan_matches_reference(monkeypatch):
    """``MLSTM_CHUNK`` patched to 8 on both sides: 24 steps in three
    chunks from a carried (C, n), h and the final state at 2e-5; the
    port's gradients through its checkpointed chunks against
    ``jax.grad`` of the reference's (1e-4)."""
    monkeypatch.setattr(JL, "MLSTM_CHUNK", 8)
    monkeypatch.setattr(L, "MLSTM_CHUNK", 8)
    rng = np.random.default_rng(4)
    B, S, H, hd = 2, 24, 2, 8
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    li, lf = (np.log(1 / (1 + np.exp(-rng.standard_normal((B, S, H)) - 2)))
              .astype(np.float32) for _ in range(2))
    C0 = (0.1 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    n0 = np.abs(rng.standard_normal((B, H, hd))).astype(np.float32)
    args = (q, k, v, li, lf, C0, n0)
    wh, (wC, wn) = JL._mlstm_chunk_scan(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    gh, (gC, gn) = L._mlstm_chunk_scan(*targs)
    for g, w in ((gh, wh), (gC, wC), (gn, wn)):
        assert_close(_np(g), _np(w), TOL)
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    wgrads = jax.grad(lambda *a: jnp.sum(JL._mlstm_chunk_scan(*a)[0] * dy),
                      argnums=tuple(range(7)))(*map(jnp.asarray, args))
    ggrads = torch.autograd.grad(gh, targs, torch.from_numpy(dy))
    for g, w in zip(ggrads, wgrads):
        assert_close(_np(g), _np(w), GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_apply_matches_reference(dtype):
    """Without a cache, then a 4-token prefill and two single steps
    through one: y and (C, n) after each."""
    jcfg, cfg, jp, p, x = _mlstm_io(S=6)
    jd, td = JDT[dtype], TDT[dtype]
    mlstm_apply = jax.jit(JL.mlstm_apply, static_argnums=2)
    want, _ = mlstm_apply(jp, jnp.asarray(x).astype(jd), jcfg)
    got, _ = L.mlstm_apply(p, torch.from_numpy(x).to(td), cfg)
    assert_close(_np(got), _np(want), TDT_TOL[dtype])
    jc = JL.init_mlstm_cache(jcfg, 2)
    tc = L.init_mlstm_cache(cfg, 2)
    for t0, t1 in ((0, 4), (4, 5), (5, 6)):
        want, jc = mlstm_apply(jp, jnp.asarray(x[:, t0:t1]).astype(jd),
                               jcfg, cache=jc)
        got, out = L.mlstm_apply(p, torch.from_numpy(x[:, t0:t1]).to(td),
                                 cfg, cache=tc)
        assert out is tc
        assert_close(_np(got), _np(want), TDT_TOL[dtype])
        _same_states(tc, jc, TDT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_apply_matches_reference(dtype):
    """Without a cache, then a 4-token prefill and two single steps
    through one: y and (c, n, h, m) after each (m starts at -1e30)."""
    jcfg = jconfigs.get_smoke("xlstm-1.3b")
    jp = JL.init_slstm(jax.random.key(1), jcfg)
    cfg, p = _port_cfg(jcfg), _carry(jp)
    x = _x(cfg, 2, 6, seed=6)
    jd, td = JDT[dtype], TDT[dtype]
    slstm_apply = jax.jit(JL.slstm_apply, static_argnums=2)
    want, _ = slstm_apply(jp, jnp.asarray(x).astype(jd), jcfg)
    got, _ = L.slstm_apply(p, torch.from_numpy(x).to(td), cfg)
    assert_close(_np(got), _np(want), TDT_TOL[dtype])
    jc = JL.init_slstm_cache(jcfg, 2)
    tc = L.init_slstm_cache(cfg, 2)
    _same_states(tc, jc, 0.0)
    for t0, t1 in ((0, 4), (4, 5), (5, 6)):
        want, jc = slstm_apply(jp, jnp.asarray(x[:, t0:t1]).astype(jd),
                               jcfg, cache=jc)
        got, out = L.slstm_apply(p, torch.from_numpy(x[:, t0:t1]).to(td),
                                 cfg, cache=tc)
        assert out is tc
        assert_close(_np(got), _np(want), TDT_TOL[dtype])
        _same_states(tc, jc, TDT_TOL[dtype])


# ---------------------------- the models ----------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_model_matches_reference(arch):
    """fp32 logits and loss at 2e-5, every gradient leaf (same paths)
    at 1e-4."""
    jcfg, cfg, jparams, params = _pair(arch)
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, 16)),
         "labels": rng.integers(0, cfg.vocab, (2, 16))}
    want, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, t,
                                               dtype=jnp.float32))(
        jparams, jnp.asarray(b["tokens"]))
    got, aux = lm.forward(params, cfg, torch.from_numpy(b["tokens"]),
                          dtype=torch.float32)
    assert float(aux) == 0.0
    assert_close(_np(got), _np(want), TOL)
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
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert_close(_np(g), _np(w), GRAD_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_matches_own_forward(arch):
    """Token by token through the caches, the last position's logits
    against the full forward's, fp32."""
    _, cfg, _, params = _pair(arch, seed=1)
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)))
    full, _ = lm.forward(params, cfg, tokens, dtype=torch.float32)
    cache = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for t in range(8):
        last, cache = lm.decode_step(params, cfg, tokens[:, t:t + 1], cache,
                                     dtype=torch.float32)
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_step_matches_reference(arch):
    """A 3-token prefill then 3 single-token steps: each step's logits
    (fp32, 2e-5); after the first step every cache leaf's dtype and
    values, and after the last its values, against the reference's."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 6))
    jstep = jax.jit(lambda p, c, tok: jlm.decode_step(p, jcfg, tok, c,
                                                      dtype=jnp.float32))
    jc = jlm.init_cache(jcfg, 2, 6, dtype=jnp.float32)
    tc = lm.init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    for i, (t0, t1) in enumerate(((0, 3), (3, 4), (4, 5), (5, 6))):
        want, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t0:t1]))
        got, tc = lm.decode_step(params, cfg,
                                 torch.from_numpy(tokens[:, t0:t1]), tc,
                                 dtype=torch.float32)
        assert_close(_np(got), _np(want), TOL)
        wl = jax.tree_util.tree_leaves_with_path(jc)
        gl = list(leaves_with_path(tc))
        assert [p for p, _ in gl] == [jax.tree_util.keystr(p)
                                      for p, _ in wl]
        for (path, g), (_, w) in zip(gl, wl):
            if i == 0:
                assert str(g.dtype).removeprefix("torch.") \
                    == str(w.dtype), path
            assert_close(_np(g), _np(w), TOL)


# ------------------------------- CLIs -------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_train_cli_trains_recurrent(arch, tmp_path, capsys):
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16", "--optimizer",
                "kfac_ca", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "opt=kfac_ca" in out
    assert "step     1 loss" in out and out.rstrip().endswith("done")


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_cli_lm_serves_recurrent(arch, capsys):
    serve.main(["--workload", "lm", "--arch", arch, "--smoke", "--device",
                "cpu", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("seq 0: [") and lines[1].startswith("seq 1:")
    assert len(eval(lines[0].split(": ", 1)[1])) == 4
    assert lines[-1].startswith("8 tokens in ") and "tok/s" in lines[-1]
