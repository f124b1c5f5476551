"""Building blocks shared by all architectures (the counterpart of
``repro.models.layers``).

Functional style: ``init_*`` returns a dict of fp32 tensors, ``*_apply``
consumes it and casts each weight to the activations' dtype at its use.
Everything is plain PyTorch, as the reference's is plain jnp: attention
(einsum scores, a masked fp32 softmax, and above ``ATTN_CHUNK``
positions the online-softmax loop over chunks), the MoE's dense
dispatch, the RG-LRU's scan, the chunkwise mLSTM and the sLSTM's loop
over time.  A decode cache is the caller's and is written in place:
the attention cache keeps its position as a 0-d device tensor and is
written through an index tensor, the recurrent states are ``copy_``'d
over, so a decode step never waits on the host and moves no copy of
the cache.
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
                       device=device).mul_(scale)


def _uniform(gen, shape, lo, hi, device):
    """Uniform on [lo, hi) in fp32 drawn from ``gen`` (meta: shape only)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device).mul_(hi - lo).add_(lo)


def _one_hot(idx, n: int, dtype):
    """``idx``'s one-hot rows over ``n`` classes in ``dtype``, by
    comparison (``F.one_hot`` checks its input's range on the host,
    which a CUDA tensor pays for with a sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


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


# ------------------------------- MoE -------------------------------

def init_moe(gen, cfg: ModelConfig, *, lead=(), device="cpu"):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    kw = dict(lead=lead, device=device)
    scale = 1.0 / math.sqrt(d)
    return {"router": _dense_init(gen, (d, e), **kw),
            "gate": _dense_init(gen, (e, d, f), scale, **kw),
            "up": _dense_init(gen, (e, d, f), scale, **kw),
            "down": _dense_init(gen, (e, f, d), 1.0 / math.sqrt(f), **kw)}


MOE_GROUP = 4096


def _top_k(gates, k: int):
    """The ``k`` largest gates of each row and their experts, the lower
    expert first among equal gates, as ``jax.lax.top_k`` orders them
    (``torch.topk`` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, x, cfg: ModelConfig, capacity_factor: float | None = None):
    """Token-choice top-k routing with capacity (GShard-style dense
    dispatch).  Returns (y, aux), aux the load-balancing loss.

    Above ``MOE_GROUP`` tokens (when it divides them) the tokens are
    routed in groups of ``MOE_GROUP``, each with its own capacity, and
    aux is the groups' mean: the (T, e, cap) dispatch tensor is
    quadratic in the tokens routed together.  The weights are cast to
    the activations' dtype once for all groups."""
    w = {k: v.to(x.dtype) for k, v in p.items()}
    B, S, d = x.shape
    T = B * S
    if T > MOE_GROUP and T % MOE_GROUP == 0:
        ys, auxs = zip(*(_moe_group(w, g, cfg, capacity_factor)
                         for g in x.reshape(T // MOE_GROUP, MOE_GROUP, d)))
        return torch.stack(ys).reshape(B, S, d), torch.stack(auxs).mean()
    y, aux = _moe_group(w, x.reshape(T, d), cfg, capacity_factor)
    return y.reshape(B, S, d), aux


def _moe_group(w, xt, cfg: ModelConfig, capacity_factor):
    """One group's routing: xt (T, d) -> (y (T, d), aux)."""
    T = xt.shape[0]
    e, topk = cfg.n_experts, cfg.topk
    logits = (xt @ w["router"]).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)                # (T, e)
    gk, ik = _top_k(gates, topk)                         # (T, topk)
    gk = gk / torch.clamp(gk.sum(-1, keepdim=True), min=1e-9)

    cf = capacity_factor if capacity_factor is not None \
        else cfg.moe_capacity
    cap = int(cf * topk * T / e)
    cap = max(min(cap, T * topk), 1)
    # position of each (token, slot) within its expert's queue, counted
    # over the token-major (T * topk) rows: it decides who is dropped
    flat = _one_hot(ik, e, torch.int64).reshape(T * topk, e)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(-1).reshape(T, topk)
    keep = pos < cap
    # dispatch (T, topk, e, cap): expert one-hot x queue-slot one-hot
    slot = _one_hot(torch.where(keep, pos, cap), cap + 1,
                    xt.dtype)[..., :cap]                 # (T, topk, cap)
    disp4 = _one_hot(ik, e, xt.dtype)[..., None] * slot[..., None, :]
    comb = (disp4 * gk.to(xt.dtype)[..., None, None]).sum(1)
    disp = disp4.sum(1)                                  # (T, e, cap)
    xin = torch.einsum("tec,td->ecd", disp, xt)          # (e, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, w["gate"])) \
        * torch.einsum("ecd,edf->ecf", xin, w["up"])
    out = torch.einsum("ecf,efd->ecd", h, w["down"])
    y = torch.einsum("tec,ecd->td", comb, out)
    return y, _load_balance_loss(gates, ik, e)


def _load_balance_loss(gates, ik, e: int):
    """Switch-style auxiliary load-balancing loss."""
    T = gates.shape[0]
    me = gates.mean(dim=0)                               # mean gate
    ce = _one_hot(ik.reshape(-1), e, torch.float32).sum(0) \
        / (T * ik.shape[-1])                             # routed share
    return e * torch.sum(me * ce)


# --------------------------- RG-LRU (hybrid) ---------------------------

def init_rec(gen, cfg: ModelConfig, *, lead=(), device="cpu"):
    d, w = cfg.d_model, cfg.conv_width
    kw = dict(lead=lead, device=device)
    lead = tuple(lead)
    return {
        "in_x": _dense_init(gen, (d, d), **kw),
        "in_g": _dense_init(gen, (d, d), **kw),
        "conv_w": _dense_init(gen, (w, d), **kw),
        "conv_b": torch.zeros(lead + (d,), dtype=torch.float32,
                              device=device),
        "lam": _uniform(gen, lead + (d,), 0.9, 0.999, device),
        "w_ig": _dense_init(gen, (d, d), **kw),      # input gate
        "w_rg": _dense_init(gen, (d, d), **kw),      # recurrence gate
        "out": _dense_init(gen, (d, d), **kw),
    }


_RG_C = 8.0


def _linear_scan(a, b):
    """h[t] = a[t] h[t-1] + b[t] along axis 1 from h[-1] = 0, for
    0 <= a <= 1: ceil(log2 S) doubling passes (Hillis-Steele) of the
    reference's associative combine, each element folding in the
    prefix ``off`` steps back.  Every partial product of a stays in
    [0, 1], so nothing overflows however long S is."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _rg_lru(x, ig, rg, lam, h0=None):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * x_t), in fp32.
    x/ig/rg: (B, S, D); lam: (D,); h0: (B, D) carried state.  Returns
    h in x's dtype and the last state in fp32."""
    log_a = -_RG_C * F.softplus(-torch.log(lam / (1 - lam))) \
        * torch.sigmoid(rg)
    a = torch.exp(log_a.to(torch.float32))
    gated = (torch.sigmoid(ig) * x).to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                       b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rec_apply(p, x, cfg: ModelConfig, cache=None):
    """RecurrentGemma recurrent block.  Returns (y, cache); cache =
    dict(h, conv) for decode, its states written over in place."""
    B, S, d = x.shape
    xb = x @ p["in_x"].to(x.dtype)
    gb = F.gelu(x @ p["in_g"].to(x.dtype), approximate="tanh")
    w = p["conv_w"].shape[0]
    if cache is not None:
        xpad = torch.cat([cache["conv"].to(xb.dtype), xb], dim=1)
    else:
        xpad = F.pad(xb, (0, 0, w - 1, 0))
    conv_w = p["conv_w"].to(xb.dtype)
    xc = sum(xpad[:, i:i + S] * conv_w[i] for i in range(w)) \
        + p["conv_b"].to(xb.dtype)
    ig = xc @ p["w_ig"].to(x.dtype)
    rg = xc @ p["w_rg"].to(x.dtype)
    h0 = cache["h"] if cache is not None else None
    h, h_last = _rg_lru(xc, ig, rg, p["lam"], h0)
    y = (h * gb) @ p["out"].to(x.dtype)
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(xpad[:, -(w - 1):])
    return y, cache


def init_rec_cache(cfg: ModelConfig, batch: int, *, lead=(), device="cpu"):
    """The conv state is held in fp32: the reference allocates it in
    bf16 and its step returns it in the compute dtype, so from the first
    fp32 step on it holds fp32 values; fp32 also holds every bf16 value
    exactly, so a step here reads what the reference's reads at either
    dtype."""
    d, w = cfg.d_model, cfg.conv_width
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, d), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, w - 1, d),
                                dtype=torch.float32, device=device)}


# ------------------------------ mLSTM ------------------------------

def init_mlstm(gen, cfg: ModelConfig, *, lead=(), device="cpu"):
    d, H = cfg.d_model, cfg.n_heads
    kw = dict(lead=lead, device=device)
    return {
        "wq": _dense_init(gen, (d, d), **kw),
        "wk": _dense_init(gen, (d, d), **kw),
        "wv": _dense_init(gen, (d, d), **kw),
        "wi": _dense_init(gen, (d, H), **kw),
        "wf": _dense_init(gen, (d, H), **kw),
        "wg": _dense_init(gen, (d, d), **kw),       # output gate (silu)
        "out": _dense_init(gen, (d, d), **kw),
    }


MLSTM_CHUNK = 1024


def _mlstm_chunk(C, n, qi, ki, vi, lii, lfi, scale: float):
    """One chunk of c steps: the carried state's contribution, the
    (c x c) parallel form within the chunk, and the state after it."""
    c = qi.shape[1]
    dev = qi.device
    Fc = torch.cumsum(lfi, dim=1)                        # (B,c,H)
    dq = torch.exp(Fc)[..., None]                        # carry's decay
    h_inter = torch.einsum("bthd,bhde->bthe", qi * dq * scale, C)
    n_inter = torch.einsum("bthd,bhd->bth", qi * dq * scale, n)
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + lii[:, None, :, :]
    causal = (torch.arange(c, device=dev)[None, :]
              <= torch.arange(c, device=dev)[:, None])[None, :, :, None]
    # masked before exp: no entry above the diagonal can overflow
    w = torch.exp(torch.where(causal, dmat, -math.inf))  # (B,tq,tk,H)
    s = torch.einsum("bthd,bshd->btsh", qi, ki) * scale
    sw = s * w
    h_intra = torch.einsum("btsh,bshd->bthd", sw, vi)
    n_intra = sw.sum(dim=2)
    h_num = h_inter + h_intra
    n_den = torch.abs(n_inter + n_intra)
    h = h_num / torch.clamp(n_den, min=1.0)[..., None]
    ftot = Fc[:, -1]                                     # (B,H)
    dk = torch.exp(ftot[:, None] - Fc + lii)             # (B,c,H)
    C = C * torch.exp(ftot)[..., None, None] \
        + torch.einsum("bshd,bshe->bhde", ki * dk[..., None], vi)
    n = n * torch.exp(ftot)[..., None] + (ki * dk[..., None]).sum(dim=1)
    return C, n, h


def _mlstm_chunk_scan(q, k, v, li, lf, C0, n0):
    """Chunkwise-parallel mLSTM.  q,k,v: (B,S,H,hd); li/lf: (B,S,H) log
    input/forget gates.  Carries (C, n) across chunks of
    ``MLSTM_CHUNK`` steps; with gradients on, each chunk's (c x c) gate
    matrix is recomputed in the backward pass instead of kept (the
    reference's checkpointed scan body).  Returns h (B,S,H,hd) and the
    final state."""
    B, S, H, hd = q.shape
    c = min(MLSTM_CHUNK, S)
    if S % c:
        raise ValueError(f"{S} steps do not split into chunks of {c}")
    scale = 1.0 / math.sqrt(hd)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, li, lf, C0, n0))
    C, n, hs = C0, n0, []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        args = (C, n, q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl],
                scale)
        C, n, h = checkpoint(_mlstm_chunk, *args, use_reentrant=False) \
            if remat else _mlstm_chunk(*args)
        hs.append(h)
    return torch.cat(hs, dim=1), (C, n)


def mlstm_apply(p, x, cfg: ModelConfig, cache=None):
    """Returns (y, cache); cache = dict(C, n), written over in place."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, H, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, H, hd)
    li = F.logsigmoid(x @ p["wi"].to(x.dtype)).to(torch.float32)
    lf = F.logsigmoid(x @ p["wf"].to(x.dtype)).to(torch.float32)
    if cache is not None:
        C0, n0 = cache["C"], cache["n"]
    else:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    h, (C, n) = _mlstm_chunk_scan(qf, kf, vf, li, lf, C0, n0)
    h = h.to(x.dtype).reshape(B, S, d)
    g = F.silu(x @ p["wg"].to(x.dtype))
    y = (h * g) @ p["out"].to(x.dtype)
    if cache is not None:
        cache["C"].copy_(C)
        cache["n"].copy_(n)
    return y, cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, lead=(),
                     device="cpu"):
    H = cfg.n_heads
    hd = cfg.d_model // H
    lead = tuple(lead)
    return {"C": torch.zeros(lead + (batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros(lead + (batch, H, hd), dtype=torch.float32,
                             device=device)}


# ------------------------------ sLSTM ------------------------------

def init_slstm(gen, cfg: ModelConfig, *, lead=(), device="cpu"):
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    kw = dict(lead=lead, device=device)
    return {
        "wx": _dense_init(gen, (d, 4 * d), **kw),
        "r": _dense_init(gen, (H, hd, 4 * hd), 1.0 / math.sqrt(hd), **kw),
        "out": _dense_init(gen, (d, d), **kw),
    }


def slstm_apply(p, x, cfg: ModelConfig, cache=None):
    """sLSTM with exponential gating and per-head recurrent mixing: a
    sequential loop over time (inherently recurrent), as the
    reference's scan.  Returns (y, cache); cache = dict(c, n, h, m),
    written over in place."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    zx = (x @ p["wx"].to(x.dtype)).reshape(B, S, H, 4 * hd) \
        .to(torch.float32)
    R = p["r"].to(torch.float32)
    if cache is not None:
        c, n, h, m = (cache[k] for k in ("c", "n", "h", "m"))
    else:
        c = n = h = torch.zeros((B, H, hd), dtype=torch.float32,
                                device=x.device)
        m = torch.full((B, H, hd), -1e30, dtype=torch.float32,
                       device=x.device)
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h, R)
        zi, zf, zz, zo = torch.chunk(zx[:, t] + rec, 4, dim=-1)
        m_new = torch.maximum(zf + m, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(zf + m - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype) \
        @ p["out"].to(x.dtype)
    if cache is not None:
        for k, t in zip(("c", "n", "h", "m"), (c, n, h, m)):
            cache[k].copy_(t)
    return y, cache


def init_slstm_cache(cfg: ModelConfig, batch: int, *, lead=(),
                     device="cpu"):
    H = cfg.n_heads
    hd = cfg.d_model // H
    shape = tuple(lead) + (batch, H, hd)
    z = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **z), "n": torch.zeros(shape, **z),
            "h": torch.zeros(shape, **z),
            "m": torch.full(shape, -1e30, **z)}
