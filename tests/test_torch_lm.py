"""The port's dense LM (``repro_torch.configs``, ``models.layers``,
``models.lm``, ``train.serve_step``) against the JAX package's, on the
CPU.

Both sides run on the SAME weights: the reference's ``init`` draws
them and ``convert.tree_from_reference`` carries them across, so every
comparison is of the computation alone.  The reference's whole-model
calls run under ``jax.jit`` (its eager ``lax.scan`` compiles per call).

Tolerances, each ``rtol = tol`` and ``atol = tol`` times the largest
entry compared (``torch_parity.assert_close``): fp32 layers, logits
and losses 2e-5; fp32 gradients 1e-4; bf16 2e-2; the port's decode
against its own forward 2e-3 (the reference's bound for its own,
tests/test_models_smoke.py); greedy tokens and the int8 quantizer
exact.
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.train import serve_step as jss
from repro_torch import configs, convert
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim.tree import leaves, leaves_with_path
from repro_torch.train import serve_step as ss
from repro_torch.train import train_step
from torch_parity import assert_close

TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
DECODE_TOL = 2e-3
DENSE = ["qwen3-1.7b", "granite-8b", "smollm-360m", "llama3-405b",
         "qwen2-vl-72b"]
# the other families, held against the reference in
# tests/test_torch_moe.py, test_torch_recurrent.py, test_torch_whisper.py
FAMILIES = ["grok-1-314b", "arctic-480b", "recurrentgemma-2b", "xlstm-1.3b",
            "whisper-tiny"]
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


def _pair(arch, seed=0, **replace):
    """(reference config, port config, reference params, port params):
    the smoke config, its weights drawn by the reference."""
    jcfg = jconfigs.get_smoke(arch)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
    jparams = jlm.init(jcfg, jax.random.key(seed))
    return jcfg, _port_cfg(jcfg), jparams, _carry(jparams)


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
         "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.embed_inputs:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)) \
            .astype(np.float32)
        del b["tokens"]
    return b


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ------------------------------ configs ------------------------------

PROPS = ("head_dim", "vocab_padded", "sub_quadratic", "param_count",
         "active_param_count", "flop_param_count", "enc_param_count")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    """Every field and property of the full and the smoke config."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        got, want = get(arch), jget(arch)
        assert type(got).__module__ == "repro_torch.configs"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in PROPS:
            assert getattr(got, prop) == getattr(want, prop), prop


def test_shapes_and_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.cells() == jconfigs.cells()
    for arch in configs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            assert configs.shape_applicable(configs.get(arch), shape) \
                == jconfigs.shape_applicable(jconfigs.get(arch),
                                             jconfigs.SHAPES[name])


# ------------------------------ layers ------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = JL.rmsnorm({"w": jnp.asarray(w)},
                      jnp.asarray(x).astype(JDT[dtype]), 1e-6)
    got = L.rmsnorm({"w": torch.from_numpy(w)},
                    torch.from_numpy(x).to(TDT[dtype]), 1e-6)
    assert got.dtype == TDT[dtype]
    assert_close(_np(got), _np(want), TDT_TOL[dtype])


@pytest.mark.parametrize("mrope", [None, (4, 6, 6), (16, 24, 24)])
def test_apply_rope_matches_reference(mrope):
    """Plain RoPE and M-RoPE: the qwen2-vl smoke sections (which
    overrun head_dim / 2 = 8 slots: both sides slice alike) and the
    full model's at head_dim 128."""
    hd = 128 if mrope == (16, 24, 24) else 16
    rng = np.random.default_rng(1)
    B, S, H = 2, 12, 3
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, B, S)) if mrope \
        else np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, mrope)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       mrope)
    assert_close(_np(got), _np(want), TOL)


def _attn_pair(arch="qwen3-1.7b", seed=0):
    jcfg = jconfigs.get_smoke(arch)
    jp = JL.init_attn(jax.random.key(seed), jcfg)
    return jcfg, _port_cfg(jcfg), jp, _carry(jp)


def _attn_io(cfg, B, S, seed=2):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    return x, pos


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_apply_full_matches_reference(arch, dtype):
    """Materialized scores, with (qwen3) and without (granite) qk norm."""
    jcfg, cfg, jp, p = _attn_pair(arch)
    x, pos = _attn_io(cfg, 2, 24)
    want, _ = JL.attn_apply(jp, jnp.asarray(x).astype(JDT[dtype]), jcfg,
                            positions=jnp.asarray(pos))
    got, cache = L.attn_apply(p, torch.from_numpy(x).to(TDT[dtype]), cfg,
                              positions=torch.from_numpy(pos))
    assert cache is None and got.dtype == TDT[dtype]
    assert_close(_np(got), _np(want), TDT_TOL[dtype])


def test_attn_apply_chunked_matches_reference(monkeypatch):
    """ATTN_CHUNK patched to 16 on both sides: S = 48 takes the
    online-softmax loop, which agrees with the port's full path too."""
    jcfg, cfg, jp, p = _attn_pair("granite-8b")
    x, pos = _attn_io(cfg, 2, 48)
    full, _ = L.attn_apply(p, torch.from_numpy(x), cfg,
                           positions=torch.from_numpy(pos))
    monkeypatch.setattr(JL, "ATTN_CHUNK", 16)
    monkeypatch.setattr(L, "ATTN_CHUNK", 16)
    want, _ = JL.attn_apply(jp, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos))
    with mock.patch.object(L, "_attend_full",
                           side_effect=AssertionError("full path taken")):
        got, _ = L.attn_apply(p, torch.from_numpy(x), cfg,
                              positions=torch.from_numpy(pos))
    assert_close(_np(got), _np(want), TOL)
    assert_close(_np(got), _np(full), 1e-4)


@pytest.mark.parametrize("window", [0, 24])
def test_attend_chunked_and_full_match_reference(window):
    """The two attention cores, causal, with and without a local
    window, on the same q, k, v (GQA: 4 heads over 2 groups)."""
    rng = np.random.default_rng(0)
    B, S, H, G, hd = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (H, G, G))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = JL._attend_full(jq, jk, jv, causal=True, window=window)
    got = L._attend_full(tq, tk, tv, causal=True, window=window)
    assert_close(_np(got), _np(want), TOL)
    want = JL._attend_chunked(jq, jk, jv, causal=True, window=window,
                              q_chunk=16, kv_chunk=16)
    got = L._attend_chunked(tq, tk, tv, causal=True, window=window,
                            q_chunk=16, kv_chunk=16)
    assert_close(_np(got), _np(want), TOL)


def test_attend_chunked_gradients_match_full():
    """With gradients on, each chunk pair's scores are recomputed in
    the backward pass; q, k, v's gradients equal the full path's
    (fp32, 1e-4)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, h, 8))
                                .astype(np.float32)).requires_grad_(True)
               for h in (4, 2, 2))
    dy = torch.from_numpy(rng.standard_normal((2, 32, 4, 8))
                          .astype(np.float32))
    grads = []
    for fn, kw in ((L._attend_full, {}),
                   (L._attend_chunked, dict(q_chunk=8, kv_chunk=8))):
        out = fn(q, k, v, causal=True, window=12, **kw)
        grads.append(torch.autograd.grad(out, (q, k, v), dy))
    for got, want in zip(*grads[::-1]):
        assert_close(_np(got), _np(want), GRAD_TOL)


def test_attn_cache_prefill_window_and_ring_match_reference():
    """The cache paths: a windowed cache of capacity 8 filled by a
    12-token prefill (S >= cap keeps the trailing 8), then 6 one-token
    steps through the ring buffer; and a plain cache appended in blocks
    of 5 and 1.  Every output and cache leaf against the reference."""
    jcfg, cfg, jp, p = _attn_pair("qwen3-1.7b")
    x, _ = _attn_io(cfg, 2, 18, seed=3)
    for window, cap, blocks in ((8, 8, (12, 1, 1, 1, 1, 1, 1)),
                                (0, 18, (5, 1, 1, 5, 6))):
        jc = JL.init_attn_cache(jcfg, 2, cap, jnp.float32, window=window)
        tc = L.init_attn_cache(cfg, 2, cap, torch.float32, window=window)
        t0 = 0
        for S in blocks:
            pos = np.broadcast_to(np.arange(t0, t0 + S)[None], (2, S)).copy()
            xs = x[:, t0:t0 + S]
            want, jc = JL.attn_apply(jp, jnp.asarray(xs), jcfg,
                                     positions=jnp.asarray(pos), cache=jc,
                                     window=window)
            got, tc = L.attn_apply(p, torch.from_numpy(xs), cfg,
                                   positions=torch.from_numpy(pos),
                                   cache=tc, window=window)
            assert_close(_np(got), _np(want), TOL)
            for key in ("k", "v"):
                assert_close(_np(tc[key]), _np(jc[key]), TOL)
            assert int(tc["pos"]) == int(jc["pos"]) == t0 + S
            assert tc["pos"].ndim == 0
            t0 += S


def test_kv_quant_and_dequant_match_reference():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 7, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                              # amax at the 1e-6 floor
    jq, js = JL._kv_quant(jnp.asarray(x))
    tq, ts = L._kv_quant(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        L._kv_dequant(tq, ts, torch.float32).numpy(),
        np.asarray(JL._kv_dequant(jq, js, jnp.float32)))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply_matches_reference(gated):
    jp = JL.init_mlp(jax.random.key(4), 64, 96, gated=gated)
    x = np.random.default_rng(6).standard_normal((2, 5, 64)) \
        .astype(np.float32)
    want = JL.mlp_apply(jp, jnp.asarray(x))
    got = L.mlp_apply(_carry(jp), torch.from_numpy(x))
    assert_close(_np(got), _np(want), TOL)


# ---------------------------- the model ----------------------------

# the dense smoke configs and one with a trailing unit (pattern of two
# attention blocks over 3 layers: params["tail"] is a list of one)
MODELS = [(a, {}) for a in DENSE] + [
    ("qwen3-1.7b", {"block_pattern": ("attn", "attn"), "n_layers": 3})]
MODEL_IDS = DENSE + ["qwen3-tail"]


@pytest.mark.parametrize("arch,replace", MODELS, ids=MODEL_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, replace, dtype):
    jcfg, cfg, jparams, params = _pair(arch, **replace)
    b = _batch(cfg)
    fwd = jax.jit(lambda p, bb: jlm.forward(
        p, jcfg, bb.get("tokens"), embeds=bb.get("embeds"),
        dtype=JDT[dtype])[0])
    want = fwd(jparams, _jbatch(b))
    tb = _tbatch(b)
    got, aux = lm.forward(params, cfg, tb.get("tokens"),
                          embeds=tb.get("embeds"), dtype=TDT[dtype])
    assert got.shape == (2, 16, cfg.vocab_padded) and float(aux) == 0.0
    assert_close(_np(got), _np(want), TDT_TOL[dtype])
    last, _ = lm.forward(params, cfg, tb.get("tokens"),
                         embeds=tb.get("embeds"), dtype=TDT[dtype],
                         last_only=True)
    assert_close(_np(last[:, 0]), _np(want)[:, -1], TDT_TOL[dtype])


@pytest.mark.parametrize("arch,replace", MODELS, ids=MODEL_IDS)
def test_loss_and_grads_match_reference(arch, replace):
    """fp32 loss at 2e-5 and every gradient leaf (same paths) at 1e-4."""
    jcfg, cfg, jparams, params = _pair(arch, **replace)
    b = _batch(cfg, seed=1)
    vg = jax.jit(jax.value_and_grad(
        lambda p, bb: jlm.loss_fn(p, jcfg, bb, dtype=jnp.float32)))
    jloss, jgrads = vg(jparams, _jbatch(b))
    loss, grads = train_step._value_and_grad(
        lambda p, bb: lm.loss_fn(p, cfg, bb, dtype=torch.float32),
        params, _tbatch(b))
    assert_close(_np(loss), _np(jloss), TOL)
    got = list(leaves_with_path(grads))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p)
                                   for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert_close(_np(g), _np(w), GRAD_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_init_tree_matches_reference_at_full_size(arch):
    """Paths, shapes and dtypes of the full config's tree against the
    reference's ``jax.eval_shape(lm.init)``; the port's on the meta
    device, so nothing is allocated."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.key(0)))
    want = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)]
    tree = lm.init(cfg, 0, device="meta")
    got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in leaves_with_path(tree)]
    assert got == want
    assert all(t.is_meta for _, t in leaves_with_path(tree))


def test_init_draws_at_the_reference_scales():
    cfg = configs.get_smoke("granite-8b")
    a = lm.init(cfg, 7, device="cpu")
    b = lm.init(cfg, 7, device="cpu")
    c = lm.init(cfg, 8, device="cpu")
    assert torch.equal(a["units"]["b0"]["attn"]["wq"],
                       b["units"]["b0"]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    assert abs(a["embed"].std().item() - 0.02) < 2e-3
    assert abs(a["head"].std().item() - 0.02) < 2e-3
    wq = a["units"]["b0"]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.1 * \
        cfg.d_model ** -0.5
    assert torch.equal(a["ln_f"]["w"], torch.ones(cfg.d_model))
    # the two units of the stack are independent draws
    assert not torch.equal(wq[0], wq[1])


# ------------------------------ decode ------------------------------

def _decode_inputs(cfg, B=2, S=8, seed=3):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return None, rng.standard_normal((B, S, cfg.d_model)) \
            .astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, S)), None


def _step_inputs(tokens, embeds, t):
    tok = None if tokens is None else tokens[:, t:t + 1]
    emb = None if embeds is None else embeds[:, t:t + 1]
    return tok, emb


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_own_forward(arch):
    """Token by token through the cache, the last position's logits
    against the full forward's, fp32, rtol = atol = 2e-3."""
    _, cfg, _, params = _pair(arch, seed=1)
    tokens, embeds = _decode_inputs(cfg)
    tt = None if tokens is None else torch.from_numpy(tokens)
    te = None if embeds is None else torch.from_numpy(embeds)
    full, _ = lm.forward(params, cfg, tt, embeds=te, dtype=torch.float32)
    cache = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for t in range(8):
        tok, emb = _step_inputs(tt, te, t)
        last, cache = lm.decode_step(params, cfg, tok, cache, embeds=emb,
                                     dtype=torch.float32)
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    assert cache["units"]["b0"]["attn"]["pos"].tolist() == \
        [8] * cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "xlstm-1.3b"])
def test_decode_writes_the_cache_in_place(arch):
    """A decode step writes into the caller's cache: the same tensors
    come back, none copied.  Attention: K/V written where the step's
    positions are and nowhere else, the position advanced.  RG-LRU
    (h, conv) and xLSTM (mLSTM C, n; sLSTM c, n, h, m): every state
    moved off its initial value."""
    _, cfg, _, params = _pair(arch)
    cache = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    before = {p: t.clone() for p, t in leaves_with_path(cache)}
    ptrs = [t.data_ptr() for t in leaves(cache)]
    tokens = torch.zeros((2, 3), dtype=torch.long)
    _, out = lm.decode_step(params, cfg, tokens, cache, dtype=torch.float32)
    assert out is cache and [t.data_ptr() for t in leaves(out)] == ptrs
    for i, kind in enumerate(cfg.block_pattern):
        block = cache["units"][f"b{i}"]
        if kind == "attn":
            attn = block["attn"]
            assert attn["pos"].tolist() == [3] * len(attn["pos"])
            for kv in (attn["k"], attn["v"]):
                assert kv[:, :, :3].abs().amax(dim=(1, 3, 4)).gt(0).all()
                assert not kv[:, :, 3:].any()
    moved = [p for p, t in leaves_with_path(cache)
             if not torch.equal(t, before[p])]
    assert moved == list(before)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(arch):
    """A 3-token prefill then 5 single-token steps: each step's logits
    (fp32, 2e-5) and the caches against the reference's."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2)
    tokens, embeds = _decode_inputs(cfg)
    jstep = jax.jit(lambda p, c, tok, emb: jlm.decode_step(
        p, jcfg, tok, c, embeds=emb, dtype=jnp.float32))
    jc = jlm.init_cache(jcfg, 2, 8, dtype=jnp.float32)
    tc = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for t0, t1 in ((0, 3),) + tuple((t, t + 1) for t in range(3, 8)):
        tok = None if tokens is None else tokens[:, t0:t1]
        emb = None if embeds is None else embeds[:, t0:t1]
        want, jc = jstep(jparams, jc, None if tok is None
                         else jnp.asarray(tok),
                         None if emb is None else jnp.asarray(emb))
        got, tc = lm.decode_step(
            params, cfg, None if tok is None else torch.from_numpy(tok),
            tc, embeds=None if emb is None else torch.from_numpy(emb),
            dtype=torch.float32)
        assert_close(_np(got), _np(want), TOL)
    for (path, g), (_, w) in zip(
            leaves_with_path(tc),
            jax.tree_util.tree_leaves_with_path(jc)):
        assert_close(_np(g), _np(w), TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_matches_reference(arch, monkeypatch):
    """fp32 on both sides (each package's decode_step and init_cache
    patched to fp32 in this process): the same tokens."""
    jcfg, cfg, jparams, params = _pair(arch, seed=4)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, (2, 5))
    decode_step, init_cache = jlm.decode_step, jlm.init_cache
    jstep = jax.jit(lambda p, tok, c: decode_step(p, jcfg, tok, c,
                                                  dtype=jnp.float32))
    monkeypatch.setattr(jlm, "decode_step",
                        lambda p, cfg_, tok, c: jstep(p, tok, c))
    monkeypatch.setattr(jlm, "init_cache", lambda cfg_, b, s: init_cache(
        cfg_, b, s, dtype=jnp.float32))
    want = np.asarray(jss.greedy_generate(jcfg, jparams,
                                          jnp.asarray(prompt), 6, 10))
    t_step, t_cache = lm.decode_step, lm.init_cache
    monkeypatch.setattr(lm, "decode_step", lambda *a, **k: t_step(
        *a, **k, dtype=torch.float32))
    monkeypatch.setattr(lm, "init_cache", lambda *a, **k: t_cache(
        *a, torch.float32, **k))
    got = ss.greedy_generate(cfg, params, torch.from_numpy(prompt), 6, 10)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_feeds_embeds_one_a_position():
    """An ``embed_inputs`` config: the prompt's embeddings to the
    prefill, then one a decode step, the same tokens as the decode fn
    driven by hand."""
    _, cfg, _, params = _pair("qwen2-vl-72b")
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4)))
    embeds = torch.from_numpy(
        rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32))
    got = ss.greedy_generate(cfg, params, prompt, 4, 7, embeds=embeds)
    decode = ss.make_decode_fn(cfg)
    cache = lm.init_cache(cfg, 2, 7, device="cpu")
    logits, cache = decode(params, cache, prompt, embeds[:, :4])
    want = [torch.argmax(logits[:, -1:], dim=-1)]
    for t in range(4, 7):
        logits, cache = decode(params, cache, want[-1], embeds[:, t:t + 1])
        want.append(torch.argmax(logits[:, -1:], dim=-1))
    assert torch.equal(got, torch.cat(want, dim=1))


def test_greedy_generate_refuses_cache_overflow():
    _, cfg, _, params = _pair("qwen3-1.7b")
    prompt = torch.zeros((1, 6), dtype=torch.long)
    with pytest.raises(ValueError, match="cache positions"):
        ss.greedy_generate(cfg, params, prompt, 5, 9)
    assert ss.greedy_generate(cfg, params, prompt, 5, 10).shape == (1, 5)


def test_make_decode_fn_signatures():
    for arch in ("qwen3-1.7b", "qwen2-vl-72b"):
        _, cfg, _, params = _pair(arch)
        fn = ss.make_decode_fn(cfg)
        cache = lm.init_cache(cfg, 1, 4, device="cpu")
        args = (torch.zeros((1, 1), dtype=torch.long),)
        if cfg.embed_inputs:
            args += (torch.zeros((1, 1, cfg.d_model)),)
        logits, cache = fn(params, cache, *args)
        assert logits.shape == (1, 1, cfg.vocab_padded)


def test_int8_cache_decode_close_to_fp():
    """The int8 cache (per-position, per-head f16 scales) decodes within
    0.1 in log-probabilities of the fp32 cache, its K/V stored int8."""
    _, cfg, _, params = _pair("granite-8b", seed=1)
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, 12)))
    cfp = lm.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    cq = lm.init_cache(cfg, 2, 12, dtype=torch.int8, device="cpu")
    assert cq["units"]["b0"]["attn"]["k"].dtype == torch.int8
    for t in range(12):
        lfp, cfp = lm.decode_step(params, cfg, tokens[:, t:t + 1], cfp,
                                  dtype=torch.float32)
        lq, cq = lm.decode_step(params, cfg, tokens[:, t:t + 1], cq,
                                dtype=torch.float32)
    assert cq["units"]["b0"]["attn"]["k"].dtype == torch.int8
    lp = torch.log_softmax(lfp[:, 0].double(), -1)
    lqq = torch.log_softmax(lq[:, 0].double(), -1)
    assert (lp - lqq).abs().max().item() < 0.1


def test_padded_vocab_is_masked():
    """A vocab that is not a multiple of 256: the padded logits are
    -1e30, as the reference's."""
    jcfg, cfg, jparams, params = _pair("smollm-360m", vocab=250)
    assert cfg.vocab_padded == 256
    tok = torch.zeros((1, 3), dtype=torch.long)
    got, _ = lm.forward(params, cfg, tok, dtype=torch.float32)
    want, _ = jlm.forward(jparams, jcfg, jnp.zeros((1, 3), jnp.int32),
                          dtype=jnp.float32)
    assert (got[..., 250:] == -1e30).all()
    assert_close(_np(got), _np(want), TOL)


# ------------------------- the other families -------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_builds_and_runs_through_the_entry_points(arch):
    """The full config's tree on the meta device against the
    reference's ``jax.eval_shape`` of its ``init`` (paths, shapes,
    dtypes); the smoke config's decode cache against the reference's
    (paths and shapes; the RG-LRU's conv state fp32, see
    ``layers.init_rec_cache``); ``loss_for`` the model's loss, and
    ``make_decode_fn`` a step through the cache."""
    from repro.models import whisper as jwhisper
    from repro_torch.models import whisper
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    model, jmodel = (whisper, jwhisper) if cfg.enc_dec else (lm, jlm)
    shapes = jax.eval_shape(lambda: jmodel.init(jcfg, jax.random.key(0)))
    want = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)]
    tree = model.init(cfg, 0, device="meta")
    got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in leaves_with_path(tree)]
    assert got == want
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jc = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: jmodel.init_cache(jcfg, 2, 4)))
    cache = model.init_cache(cfg, 2, 4, device="cpu")
    assert [(p, tuple(t.shape)) for p, t in leaves_with_path(cache)] == \
        [(jax.tree_util.keystr(p), tuple(s.shape)) for p, s in jc]
    assert train_step.loss_for(cfg) is model.loss_fn
    params = model.init(cfg, 0, device="cpu")
    args = (torch.zeros((2, 1), dtype=torch.long),)
    if cfg.enc_dec:
        args += (torch.zeros((2, cfg.enc_frames, cfg.d_model)),)
    logits, out = ss.make_decode_fn(cfg)(params, cache, *args)
    assert out is cache and logits.shape == (2, 1, cfg.vocab_padded)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase11_tree_is_the_models():
    """chip_smoke.py's phase 11 takes ``lm.init(...)["units"]`` of
    qwen3-1.7b at 2 layers: the layout its hand-built tree had (every
    matrix and its shape; the norms now under the reference's "w"), so
    K-FAC's eligible tensors and Kronecker orders (KFAC_ORDERS) stay."""
    import importlib
    kfac_ca = importlib.import_module("repro_torch.optim.kfac_ca")
    cs = _chip_smoke()
    u, d, hd, f = cs.KFAC_UNITS, 2048, 128, 6144
    hq, hkv = 16 * hd, 8 * hd
    want = {"['units']['b0']['ln1']['w']": (u, d),
            "['units']['b0']['ln2']['w']": (u, d),
            "['units']['b0']['attn']['wq']": (u, d, hq),
            "['units']['b0']['attn']['wk']": (u, d, hkv),
            "['units']['b0']['attn']['wv']": (u, d, hkv),
            "['units']['b0']['attn']['wo']": (u, hq, d),
            "['units']['b0']['attn']['qn']['w']": (u, hd),
            "['units']['b0']['attn']['kn']['w']": (u, hd),
            "['units']['b0']['mlp']['gate']": (u, d, f),
            "['units']['b0']['mlp']['up']": (u, d, f),
            "['units']['b0']['mlp']['down']": (u, f, d)}
    params = cs.kfac_params("meta", None)
    got = {p: tuple(t.shape) for p, t in leaves_with_path(params)}
    assert got == want
    state = kfac_ca.kfac_ca().init(params)
    assert kfac_ca._kron_order_counts(state) == cs.KFAC_ORDERS
    # the tree is the reference's, unit for unit
    jcfg = dataclasses.replace(jconfigs.get("qwen3-1.7b"),
                               n_layers=cs.KFAC_UNITS)
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.key(0)))
    ref = {jax.tree_util.keystr(p): tuple(s.shape)
           for p, s in jax.tree_util.tree_leaves_with_path(shapes)
           if jax.tree_util.keystr(p).startswith("['units']")}
    assert got == ref
