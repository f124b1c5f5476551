"""The port's encoder-decoder (``models.whisper``; ``train.serve_step``'s
enc-dec decode fn, ``train.train_step`` and the training CLI on it)
against the JAX package's, on the CPU, at whisper-tiny's smoke config.

Both sides run on the SAME weights: the reference draws them and
``convert.tree_from_reference`` carries them across (its ``enc`` and
``dec`` stacks as they are).  The reference's whole-model calls run
under ``jax.jit``.  Tolerances, each ``rtol = tol`` and ``atol = tol``
times the largest entry compared (``torch_parity.assert_close``): fp32
2e-5; fp32 gradients, parameters and optimizer state after a step
1e-4; bf16 2e-2; the port's decode against its own full decode 2e-3
(tests/test_models_smoke.py's bound).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import whisper as jw
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.data import synthetic
from repro_torch.launch import train
from repro_torch.models import whisper
from repro_torch.optim.tree import leaves_with_path
from repro_torch.train import serve_step, train_step
from torch_parity import assert_close

TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
DECODE_TOL = 2e-3
ARCH = "whisper-tiny"
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


def _pair(seed=0):
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = jw.init(jcfg, jax.random.key(seed))
    return (jcfg, configs.ModelConfig(**dataclasses.asdict(jcfg)), jparams,
            _carry(jparams))


def _inputs(cfg, B=2, S=8, seed=5):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)) \
        .astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, (B, S))


def _same_tree(got, want, tol):
    g = list(leaves_with_path(got))
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == np.shape(b), path
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        assert_close(_np(a), _np(b), tol)


# ------------------------------ pieces ------------------------------

def test_sinusoid_matches_reference():
    pos = np.array([0, 1, 7, 63, 1499])
    want = jw._sinusoid_at(jnp.asarray(pos), 64)
    got = whisper._sinusoid_at(torch.from_numpy(pos), 64)
    assert_close(_np(got), _np(want), TOL)
    assert_close(_np(whisper._sinusoid(12, 384)), _np(jw._sinusoid(12, 384)),
                 TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    """The encoder's states (bidirectional attention, the norms at
    ``rmsnorm``'s default eps) in the compute dtype."""
    jcfg, cfg, jp, p = _pair()
    frames, _ = _inputs(cfg)
    want = jax.jit(lambda pp, f: jw.encode(pp, jcfg, f, JDT[dtype]))(
        jp, jnp.asarray(frames))
    got = whisper.encode(p, cfg, torch.from_numpy(frames), TDT[dtype])
    assert got.dtype == TDT[dtype] and got.shape == frames.shape
    assert_close(_np(got), _np(want), TDT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attend_matches_reference(dtype):
    """One decoder layer's cross-attention over K/V computed from the
    encoder states (``_enc_kv``, every layer's)."""
    jcfg, cfg, jp, p = _pair(seed=1)
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, cfg.enc_frames, cfg.d_model)) \
        .astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jd, td = JDT[dtype], TDT[dtype]
    wK, wV = jw._enc_kv(jp, jcfg, jnp.asarray(enc).astype(jd))
    kv = whisper._enc_kv(p, cfg, torch.from_numpy(enc).to(td))
    assert len(kv) == cfg.n_layers
    for layer, (K, V) in enumerate(kv):
        assert_close(_np(K), _np(wK[layer]), TDT_TOL[dtype])
        assert_close(_np(V), _np(wV[layer]), TDT_TOL[dtype])
    jx = jax.tree.map(lambda a: a[1], jp["dec"]["xattn"])
    want = jw._cross_attend(jx, jnp.asarray(x).astype(jd),
                            (wK[1], wV[1]), jcfg)
    got = whisper._cross_attend(_carry(jx), torch.from_numpy(x).to(td),
                                kv[1], cfg)
    assert_close(_np(got), _np(want), TDT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference(dtype):
    """The full-sequence decoder's logits (padded vocab masked) on the
    same encoder states."""
    jcfg, cfg, jp, p = _pair(seed=2)
    frames, tokens = _inputs(cfg, seed=3)
    enc = np.array(jax.jit(lambda pp, f: jw.encode(pp, jcfg, f,
                                                   jnp.float32))(
        jp, jnp.asarray(frames)))
    want, _ = jax.jit(lambda pp, t, e: jw.decode(pp, jcfg, t, e,
                                                 dtype=JDT[dtype]))(
        jp, jnp.asarray(tokens), jnp.asarray(enc))
    got, cache = whisper.decode(p, cfg, torch.from_numpy(tokens),
                                torch.from_numpy(enc), dtype=TDT[dtype])
    assert cache is None and got.shape == (2, 8, cfg.vocab_padded)
    assert_close(_np(got), _np(want), TDT_TOL[dtype])
    last, _ = whisper.decode(p, cfg, torch.from_numpy(tokens),
                             torch.from_numpy(enc), dtype=TDT[dtype],
                             last_only=True)
    assert_close(_np(last[:, 0]), _np(want)[:, -1], TDT_TOL[dtype])


# ---------------------------- the model ----------------------------

def test_loss_and_grads_match_reference():
    """fp32 loss at 2e-5 and every gradient leaf (same paths, the
    encoder's and the decoder's stacks) at 1e-4; each layer under
    ``torch.utils.checkpoint``, as the reference's under
    ``jax.checkpoint``."""
    jcfg, cfg, jp, p = _pair()
    frames, tokens = _inputs(cfg, S=16, seed=0)
    labels = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    b = {"frames": frames, "tokens": tokens, "labels": labels}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda pp, bb: jw.loss_fn(pp, jcfg, bb, dtype=jnp.float32)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = train_step._value_and_grad(
        lambda pp, bb: whisper.loss_fn(pp, cfg, bb, dtype=torch.float32), p,
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert_close(_np(loss), _np(jloss), TOL)
    _same_tree(grads, jgrads, GRAD_TOL)


def test_decode_matches_own_full_decode():
    """Token by token through the self-attention cache, the last
    position's logits against the full decode's, fp32."""
    _, cfg, _, p = _pair(seed=2)
    frames, tokens = _inputs(cfg, seed=5)
    enc = whisper.encode(p, cfg, torch.from_numpy(frames), torch.float32)
    tokens = torch.from_numpy(tokens)
    full, _ = whisper.decode(p, cfg, tokens, enc, dtype=torch.float32)
    cache = whisper.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    for t in range(8):
        last, cache = whisper.decode(p, cfg, tokens[:, t:t + 1], enc,
                                     cache=cache, dtype=torch.float32)
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    assert cache["self"]["attn"]["pos"].tolist() == [8] * cfg.n_layers


def test_decode_step_matches_reference():
    """A 3-token prefill then 3 single-token steps through the cache:
    each step's logits (fp32, 2e-5) and the cache (written in place,
    the same tensors each step) against the reference's."""
    jcfg, cfg, jp, p = _pair(seed=3)
    frames, tokens = _inputs(cfg, S=6, seed=6)
    enc = np.array(jax.jit(lambda pp, f: jw.encode(pp, jcfg, f,
                                                   jnp.float32))(
        jp, jnp.asarray(frames)))
    jstep = jax.jit(lambda pp, c, t, e: jw.decode(pp, jcfg, t, e, cache=c,
                                                  dtype=jnp.float32))
    jc = jw.init_cache(jcfg, 2, 6, dtype=jnp.float32)
    tc = whisper.init_cache(cfg, 2, 6, torch.float32, device="cpu")
    ptrs = [t.data_ptr() for _, t in leaves_with_path(tc)]
    for t0, t1 in ((0, 3), (3, 4), (4, 5), (5, 6)):
        want, jc = jstep(jp, jc, jnp.asarray(tokens[:, t0:t1]),
                         jnp.asarray(enc))
        got, out = whisper.decode(p, cfg, torch.from_numpy(tokens[:, t0:t1]),
                                  torch.from_numpy(enc), cache=tc,
                                  dtype=torch.float32)
        assert out is tc and not got.requires_grad
        assert_close(_np(got), _np(want), TOL)
    assert [t.data_ptr() for _, t in leaves_with_path(tc)] == ptrs
    _same_tree(tc, jc, TOL)


def test_make_decode_fn_takes_the_encoder_states():
    """The enc-dec signature (params, cache, tokens, enc_states), in
    the compute dtype of the serving default (bf16)."""
    _, cfg, _, p = _pair()
    frames, tokens = _inputs(cfg)
    fn = serve_step.make_decode_fn(cfg)
    enc = whisper.encode(p, cfg, torch.from_numpy(frames))
    cache = whisper.init_cache(cfg, 2, 4, device="cpu")
    logits, cache = fn(p, cache, torch.from_numpy(tokens[:, :1]), enc)
    assert logits.shape == (2, 1, cfg.vocab_padded)
    assert logits.dtype == torch.bfloat16
    assert int(cache["self"]["attn"]["pos"][0]) == 1


def test_adamw_train_step_matches_reference():
    """One ``make_train_step`` step with adamw (lr 1e-3) on the same
    batch (frames, tokens, labels): loss 2e-5, parameters and optimizer
    state 1e-4, the step counter exact."""
    jcfg, cfg, jp, p = _pair(seed=4)
    jopt = importlib.import_module("repro.optim").get("adamw", lr=1e-3)
    opt = importlib.import_module("repro_torch.optim").get("adamw", lr=1e-3)
    js = jopt.init(jp)
    s = _carry(js)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jstep = jax.jit(jts.make_train_step(jcfg, mesh, jopt, remat=False,
                                        dtype=jnp.float32))
    step = train_step.make_train_step(cfg, opt, remat=False,
                                      dtype=torch.float32)
    frames, tokens = _inputs(cfg, S=16, seed=7)
    labels = np.random.default_rng(8).integers(0, cfg.vocab, (2, 16))
    b = {"frames": frames, "tokens": tokens, "labels": labels}
    jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    p, s, m = step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
    assert_close(_np(m["loss"]), _np(jm["loss"]), TOL)
    _same_tree(p, jp, GRAD_TOL)
    _same_tree(s, js, GRAD_TOL)
    assert int(s["step"]) == int(js["step"]) == 1


def test_init_cache_matches_reference():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    want = jw.init_cache(jcfg, 2, 6)
    got = whisper.init_cache(cfg, 2, 6, device="cpu")
    _same_tree(got, want, 0.0)


# ------------------------------- CLI -------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "kfac_ca"])
def test_train_cli_trains_whisper(optimizer, tmp_path, capsys):
    """Two steps on the synthetic stream, whose batches carry the
    encoder's frames."""
    cfg = configs.get_smoke(ARCH)
    assert "frames" in synthetic.host_batch(cfg, 16, 2, step=0)
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16", "--optimizer",
                optimizer, "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=whisper-smoke" in out and f"opt={optimizer}" in out
    assert "step     1 loss" in out and out.rstrip().endswith("done")
