"""Building blocks of the dense decoder (the counterpart of
``repro.models.layers``, its dense part).

Functional style: ``init_*`` returns a dict of fp32 tensors, ``*_apply``
consumes it and casts each weight to the activations' dtype at its use.
Attention is plain PyTorch, as the reference's is plain jnp: einsum
scores, a masked fp32 softmax, and above ``ATTN_CHUNK`` positions the
online-softmax loop over chunks.  The decode cache keeps its position
as a 0-d device tensor and is written through an index tensor, so a
decode step never waits on the host.

MoE, RG-LRU, mLSTM and sLSTM blocks are not ported yet (ROADMAP A15e-g;
``models.lm`` refuses them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig


def _normal(gen, shape, scale, device):
    """``randn(shape) * scale`` in fp32 drawn from ``gen``; on the meta
    device, the shape alone (no draw)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


def _dense_init(gen, shape, scale=None, *, lead=(), device="cpu"):
    """A (d_in, d_out) weight at 1/sqrt(d_in), or ``scale``; ``lead``
    stacks independent draws in front (units of a layer stack)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return _normal(gen, tuple(lead) + tuple(shape), scale, device)


# ------------------------------ norms ------------------------------

def init_rmsnorm(d, *, lead=(), device="cpu"):
    return {"w": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                            device=device)}


def rmsnorm(p, x, eps=1e-6):
    """Computed in fp32, cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    v = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(dt) * p["w"].to(dt)


# ------------------------------ RoPE ------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float, mrope_sections=None):
    """x: (B, S, H, hd); positions: (B, S) or (3, B, S) for M-RoPE.

    M-RoPE (qwen2-vl): the head_dim/2 frequency slots are split into
    (t, h, w) sections, each rotated by its own position stream."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    if mrope_sections is None:
        if positions.ndim == 3:
            positions = positions[0]
        ang = positions[..., None].to(torch.float32) * freqs  # (B,S,hd/2)
    else:
        if positions.ndim != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions")
        secs = []
        off = 0
        for i, sec in enumerate(mrope_sections):
            secs.append(positions[i][..., None].to(torch.float32)
                        * freqs[off:off + sec])
            off += sec
        ang = torch.cat(secs, dim=-1)                     # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------- attention ----------------------------

def init_attn(gen, cfg: ModelConfig, *, lead=(), device="cpu"):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(lead=lead, device=device)
    p = {
        "wq": _dense_init(gen, (d, cfg.n_heads * hd), **kw),
        "wk": _dense_init(gen, (d, cfg.n_kv * hd), **kw),
        "wv": _dense_init(gen, (d, cfg.n_kv * hd), **kw),
        "wo": _dense_init(gen, (cfg.n_heads * hd, d), **kw),
    }
    if cfg.qk_norm:
        p["qn"] = init_rmsnorm(hd, **kw)
        p["kn"] = init_rmsnorm(hd, **kw)
    return p


def _gqa_scores(q, k):
    """q: (B,Sq,H,hd), k: (B,Sk,G,hd) -> (B, G, H/G, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    G = k.shape[2]
    qg = q.reshape(B, Sq, G, H // G, hd)
    return torch.einsum("bsgrd,btgd->bgrst", qg, k)


def _gqa_out(w, v):
    """w: (B,G,R,Sq,Sk), v: (B,Sk,G,hd) -> (B,Sq,H,hd)."""
    B, G, R, Sq, Sk = w.shape
    o = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return o.reshape(B, Sq, G * R, o.shape[-1])


def _attend_full(q, k, v, *, causal: bool, window: int,
                 q0: int = 0, k0: int = 0):
    """Small/seq-bounded attention on materialized scores."""
    hd = q.shape[-1]
    s = _gqa_scores(q, k) / math.sqrt(hd)
    Sq, Sk = q.shape[1], k.shape[1]
    iq = (q0 + torch.arange(Sq, device=q.device))[:, None]
    ik = (k0 + torch.arange(Sk, device=q.device))[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ik <= iq
    if window:
        mask &= ik > iq - window
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return _gqa_out(w, v)


def _attend_chunked(q, k, v, *, causal: bool, window: int,
                    q_chunk: int, kv_chunk: int):
    """Online-softmax attention: a loop over kv chunks inside a loop
    over q chunks.  Live memory is O(q_chunk * kv_chunk) per head; with
    gradients on, each chunk pair's scores are recomputed in the
    backward pass instead of kept (the reference's checkpointed scan
    body)."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    nq = S // q_chunk
    nk = S // kv_chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    def body(m, l, acc, qch, kch, vch, q0, k0):
        s = _gqa_scores(qch, kch).to(torch.float32) * scale
        iq = (q0 + torch.arange(q_chunk, device=dev))[:, None]
        ik = (k0 + torch.arange(kv_chunk, device=dev))[None, :]
        msk = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            msk &= ik <= iq
        if window:
            msk &= ik > iq - window
        s = torch.where(msk, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * corr + p.sum(dim=-1)
        o = _gqa_out(p.to(qch.dtype), vch).to(torch.float32)
        corr_o = corr.permute(0, 3, 1, 2).reshape(B, q_chunk, H)
        return m_new, l_new, acc * corr_o[..., None] + o

    outs = []
    for qi in range(nq):
        qch = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((B, G, H // G, q_chunk), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, G, H // G, q_chunk), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, q_chunk, H, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kch = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vch = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            args = (m, l, acc, qch, kch, vch, qi * q_chunk, ki * kv_chunk)
            m, l, acc = checkpoint(body, *args, use_reentrant=False) \
                if remat else body(*args)
        ln = l.permute(0, 3, 1, 2).reshape(B, q_chunk, H)
        outs.append((acc / torch.clamp(ln[..., None], min=1e-30))
                    .to(qch.dtype))
    return torch.cat(outs, dim=1)


ATTN_CHUNK = 1024


def attn_apply(p, x, cfg: ModelConfig, *, positions, cache=None,
               window: int = 0, causal: bool = True, norm_eps=1e-6):
    """Returns (y, cache).  cache = dict(k, v, pos) for decode: this
    step's K/V are written into it in place and its position advanced,
    so a decode step moves no copy of the cache (the decode loop owns
    it, as the reference's jitted step donates its buffers)."""
    B, S, d = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, cfg.n_kv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, cfg.n_kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q, norm_eps)
        k = rmsnorm(p["kn"], k, norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if cache is not None:
        # write this step's k/v at cache["pos"] in place, attend to
        # the cache.
        pos = cache["pos"]
        cap = cache["k"].shape[1]
        ring = bool(window) and cap <= window and S == 1
        quant = "k_scale" in cache
        if quant:
            kq, ks = _kv_quant(k)
            vq, vs = _kv_quant(v)
        else:
            kq, vq = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        K, V = cache["k"], cache["v"]
        writes = [(K, kq), (V, vq)]
        if quant:
            Ks, Vs = cache["k_scale"], cache["v_scale"]
            writes += [(Ks, ks), (Vs, vs)]
        if S >= cap:
            # prefill block >= cache capacity (windowed caches): keep
            # only the trailing `cap` positions.
            for dst, src in writes:
                dst.copy_(src[:, S - cap:])
        else:
            at = (pos % cap) if ring else pos
            idx = at.long() + torch.arange(S, device=x.device)
            for dst, src in writes:
                dst.index_copy_(1, idx, src)
        if S > ATTN_CHUNK and S % ATTN_CHUNK == 0:
            # chunked prefill: attends within the incoming block
            # (prefill-from-scratch: no earlier cache content).
            o = _attend_chunked(q, k, v, causal=causal, window=window,
                                q_chunk=ATTN_CHUNK, kv_chunk=ATTN_CHUNK)
        else:
            Sk = K.shape[1]
            Kd = _kv_dequant(K, Ks, q.dtype) if quant else K.to(q.dtype)
            Vd = _kv_dequant(V, Vs, q.dtype) if quant else V.to(q.dtype)
            s = _gqa_scores(q, Kd) / math.sqrt(hd)
            ik = torch.arange(Sk, device=x.device)[None, :]
            iq = pos + torch.arange(S, device=x.device)[:, None]
            if ring:
                # ring buffer: slot j holds absolute position
                # pos - ((slot - j) mod cap); valid if >= 0.
                slot = pos % cap
                aj = pos - torch.remainder(slot - ik, cap)
                msk = (aj >= 0) & (aj > iq - window)
            else:
                msk = ik <= iq
                if window:
                    msk &= ik > iq - window
            s = torch.where(msk, s, -1e30)
            w = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
            o = _gqa_out(w, Vd)
        pos.add_(S)
        new_cache = cache
    else:
        if S > ATTN_CHUNK and S % ATTN_CHUNK == 0:
            o = _attend_chunked(q, k, v, causal=causal, window=window,
                                q_chunk=ATTN_CHUNK, kv_chunk=ATTN_CHUNK)
        else:
            o = _attend_full(q, k, v, causal=causal, window=window)
        new_cache = None
    y = o.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(x.dtype)
    return y, new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, window: int = 0, *, lead=(),
                    device="cpu"):
    """dtype=torch.int8 enables the quantized cache: K/V stored int8 with
    per-(position, kv-head) f16 scales, half the bytes a decode step
    reads."""
    s = min(max_seq, window) if window else max_seq
    hd = cfg.head_dim
    lead = tuple(lead)
    shape = lead + (batch, s, cfg.n_kv, hd)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "pos": torch.zeros(lead, dtype=torch.int32, device=device)}
    if dtype == torch.int8:
        c["k_scale"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float16,
                                   device=device)
        c["v_scale"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float16,
                                   device=device)
    return c


def _kv_quant(x):
    """(B, S, G, hd) -> int8 values + per-(pos, head) f16 scale."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _kv_dequant(q, scale, dtype):
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


# ------------------------------- MLP -------------------------------

def init_mlp(gen, d, f, gated=True, *, lead=(), device="cpu"):
    kw = dict(lead=lead, device=device)
    if gated:
        return {"gate": _dense_init(gen, (d, f), **kw),
                "up": _dense_init(gen, (d, f), **kw),
                "down": _dense_init(gen, (f, d), **kw)}
    return {"up": _dense_init(gen, (d, f), **kw),
            "down": _dense_init(gen, (f, d), **kw)}


def mlp_apply(p, x):
    if "gate" in p:
        h = F.silu(x @ p["gate"].to(x.dtype)) * (x @ p["up"].to(x.dtype))
    else:
        h = F.gelu(x @ p["up"].to(x.dtype), approximate="tanh")
    return h @ p["down"].to(x.dtype)
