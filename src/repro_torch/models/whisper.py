"""Whisper-style encoder-decoder backbone, audio family (the counterpart
of ``repro.models.whisper``).

The conv/mel frontend is a stub, as in the reference: the encoder
consumes precomputed frame embeddings (B, enc_frames, D).  Sinusoidal
positions on the encoder, a causal decoder with cross-attention.  The
encoder's and the decoder's layers are stacked over axis 0
(``params["enc"]``, ``params["dec"]``), the reference's tree leaf for
leaf.  Decode caches: a per-layer self-attention cache, stacked over
layers and written in place as ``models.lm``'s; the cross-attention
K/V are computed from the encoder states on every call, as the
reference computes them.  The norms use ``rmsnorm``'s default eps, as
the reference's do, whatever ``cfg.norm_eps`` says.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import (_generator, _mask_padded_vocab,
                                   _unstack)


def _sinusoid_at(positions, d, dtype=torch.float32):
    """Sinusoidal embeddings (len(positions), d) at the given
    positions (a device tensor: no host sync)."""
    pos = positions[:, None].to(torch.float32)
    i = torch.arange(d // 2, device=positions.device)[None, :] \
        .to(torch.float32)
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid(S, d, dtype=torch.float32, device=None):
    return _sinusoid_at(torch.arange(S, device=device), d, dtype)


def _init_xattn(gen, cfg: ModelConfig, *, lead=(), device="cpu"):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(lead=lead, device=device)
    return {"wq": L._dense_init(gen, (d, cfg.n_heads * hd), **kw),
            "wk": L._dense_init(gen, (d, cfg.n_kv * hd), **kw),
            "wv": L._dense_init(gen, (d, cfg.n_kv * hd), **kw),
            "wo": L._dense_init(gen, (cfg.n_heads * hd, d), **kw)}


def init(cfg: ModelConfig, key=0, *, device="cuda") -> dict:
    """The parameter tree, fp32, drawn from ``key`` (an int seed or a
    ``torch.Generator`` on ``device``) at the reference's scales; the
    encoder's ``n_enc_layers`` and the decoder's ``n_layers`` layers
    each stacked over axis 0.  ``device="meta"`` gives the shapes
    without memory."""
    gen = _generator(key, device)
    d = cfg.d_model
    enc = dict(lead=(cfg.n_enc_layers,), device=device)
    dec = dict(lead=(cfg.n_layers,), device=device)
    return {
        "embed": L._normal(gen, (cfg.vocab_padded, d), 0.02, device),
        "enc": {"ln1": L.init_rmsnorm(d, **enc),
                "attn": L.init_attn(gen, cfg, **enc),
                "ln2": L.init_rmsnorm(d, **enc),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, gated=False, **enc)},
        "dec": {"ln1": L.init_rmsnorm(d, **dec),
                "attn": L.init_attn(gen, cfg, **dec),
                "lnx": L.init_rmsnorm(d, **dec),
                "xattn": _init_xattn(gen, cfg, **dec),
                "ln2": L.init_rmsnorm(d, **dec),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, gated=False, **dec)},
        "ln_enc": L.init_rmsnorm(d, device=device),
        "ln_f": L.init_rmsnorm(d, device=device),
    }


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    when gradients are taken (the reference's ``jax.checkpoint`` of
    each layer in a full-sequence pass)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params, cfg: ModelConfig, frames, dtype=torch.bfloat16):
    """frames: (B, enc_frames, D) stub embeddings -> encoder states."""
    B, S, d = frames.shape
    x = frames.to(dtype) + _sinusoid(S, d, dtype, frames.device)[None]
    pos = torch.arange(S, device=frames.device)[None].expand(B, S)

    def layer(x, p):
        h, _ = L.attn_apply(p["attn"], L.rmsnorm(p["ln1"], x), cfg,
                            positions=pos, causal=False)
        x = x + h
        return x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x))

    for p in _unstack(params["enc"], cfg.n_enc_layers):
        x = _remat(layer, x, p)
    return L.rmsnorm(params["ln_enc"], x)


def _cross_attend(p, x, enc_kv, cfg: ModelConfig):
    B, S, d = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    K, V = enc_kv
    s = L._gqa_scores(q, K.to(q.dtype)) / math.sqrt(hd)
    w = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    o = L._gqa_out(w, V.to(q.dtype))
    return o.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(x.dtype)


def _enc_kv(params, cfg: ModelConfig, enc_states):
    """Each decoder layer's cross-attention K/V from the encoder
    states: a list of (K, V), each (B, S_enc, n_kv, hd)."""
    B, S, d = enc_states.shape
    hd = cfg.head_dim
    out = []
    for p in _unstack(params["dec"]["xattn"], cfg.n_layers):
        K = (enc_states @ p["wk"].to(enc_states.dtype)) \
            .reshape(B, S, cfg.n_kv, hd)
        V = (enc_states @ p["wv"].to(enc_states.dtype)) \
            .reshape(B, S, cfg.n_kv, hd)
        out.append((K, V))
    return out


def decode(params, cfg: ModelConfig, tokens, enc_states, *, cache=None,
           dtype=torch.bfloat16, last_only: bool = False):
    """Decoder forward, full-sequence (cache=None) or a decode step of
    S >= 1 tokens through ``cache`` (``init_cache``'s), which is written
    in place (K/V at its position, the position advanced) and returned.
    A step with a cache takes no gradients.  Returns (logits, cache)."""
    if cache is not None:
        with torch.no_grad():
            return _decode(params, cfg, tokens, enc_states, cache, dtype,
                           last_only)
    return _decode(params, cfg, tokens, enc_states, None, dtype, last_only)


def _decode(params, cfg, tokens, enc_states, cache, dtype, last_only):
    B, S = tokens.shape
    x = params["embed"][tokens].to(dtype)
    dev = x.device
    if cache is None:
        pos0 = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        pos0 = cache["self"]["attn"]["pos"].reshape(-1)[0]
    at = pos0 + torch.arange(S, device=dev)
    x = x + _sinusoid_at(at, x.shape[-1], dtype)[None]
    pos = at[None].expand(B, S)
    enc_kv = _enc_kv(params, cfg, enc_states)

    def layer(x, p, K, V, c):
        h, _ = L.attn_apply(p["attn"], L.rmsnorm(p["ln1"], x), cfg,
                            positions=pos, cache=c)
        x = x + h
        x = x + _cross_attend(p["xattn"], L.rmsnorm(p["lnx"], x), (K, V),
                              cfg)
        return x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x))

    ps = _unstack(params["dec"], cfg.n_layers)
    if cache is None:
        # remat per decoder layer: cross-attention weights (B, H, S,
        # enc_frames) would otherwise be kept for every layer
        for p, (K, V) in zip(ps, enc_kv):
            x = _remat(lambda x, p, K, V: layer(x, p, K, V, None), x, p, K,
                       V)
    else:
        cs = _unstack(cache["self"], cfg.n_layers)
        for p, (K, V), c in zip(ps, enc_kv, cs):
            x = layer(x, p, K, V, c["attn"])
    x = L.rmsnorm(params["ln_f"], x)
    if last_only:
        x = x[:, -1:]
    logits = x @ params["embed"].T.to(x.dtype)
    return _mask_padded_vocab(logits, cfg), cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device="cuda") -> dict:
    """The decoder's self-attention caches, stacked over its layers."""
    return {"self": {"attn": L.init_attn_cache(
        cfg, batch, max_seq, dtype, lead=(cfg.n_layers,), device=device)}}


def loss_fn(params, cfg: ModelConfig, batch, dtype=torch.bfloat16, **_):
    """Next-token cross entropy in fp32, the mean over every position.
    batch: frames (B, enc_frames, D), tokens and labels (B, S)."""
    enc = encode(params, cfg, batch["frames"], dtype)
    logits, _ = decode(params, cfg, batch["tokens"], enc, dtype=dtype)
    labels = batch["labels"].long()
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None])[..., 0]
    return (lse - ll).mean()
