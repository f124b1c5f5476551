"""The decoder-only LM covering the dense / MoE / hybrid / SSM /
VLM-backbone families (the counterpart of ``repro.models.lm``).

Layers are organized as repeating *units* (cfg.block_pattern) whose
parameters are stacked over axis 0, as the reference stacks them for
its scan: ``params["units"]["b{i}"]`` holds every unit's block i, and a
non-full trailing unit is the list ``params["tail"]``.  The tree is the
reference's leaf for leaf (paths, shapes, fp32), so a tree carried
across (``convert.tree_from_reference``), a checkpoint in the shared
format, and ``optim.kfac_ca``'s batching over the stacked units all
line up.  The stack is a loop over units on views of each stacked leaf
(one ``unbind`` a leaf), so gradients land on the stacked leaf;
``remat=True`` recomputes a unit's activations in the backward pass
(``torch.utils.checkpoint``).

Decode caches are stacked over units the same way, and a decode step
writes each unit's K/V and recurrent states through its view of the
stacked cache in place: nothing is copied or re-stacked.  The
encoder-decoder (whisper) is ``models.whisper``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.models import layers as L
from repro_torch.optim.tree import tree_map


# ----------------------------- layout -----------------------------

def pattern_layout(cfg: ModelConfig):
    pat = tuple(cfg.block_pattern)
    n_units, tail = divmod(cfg.n_layers, len(pat))
    return pat, n_units, tail


# ------------------------------ init ------------------------------

def _init_block(gen, kind: str, cfg: ModelConfig, *, lead=(),
                device="cpu"):
    d = cfg.d_model
    kw = dict(lead=lead, device=device)
    if kind == "attn":
        p = {"ln1": L.init_rmsnorm(d, **kw),
             "attn": L.init_attn(gen, cfg, **kw),
             "ln2": L.init_rmsnorm(d, **kw)}
        if cfg.n_experts:
            p["moe"] = L.init_moe(gen, cfg, **kw)
            if cfg.dense_residual:
                p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, **kw)
        elif cfg.d_ff:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, **kw)
        return p
    if kind == "rec":
        return {"ln1": L.init_rmsnorm(d, **kw),
                "rec": L.init_rec(gen, cfg, **kw),
                "ln2": L.init_rmsnorm(d, **kw),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, **kw)}
    if kind == "mlstm":
        return {"ln1": L.init_rmsnorm(d, **kw),
                "mix": L.init_mlstm(gen, cfg, **kw)}
    if kind == "slstm":
        return {"ln1": L.init_rmsnorm(d, **kw),
                "mix": L.init_slstm(gen, cfg, **kw)}
    raise ValueError(kind)


def _generator(key, device) -> torch.Generator | None:
    """``key``: an int seed or a ``torch.Generator`` on ``device``."""
    if isinstance(key, torch.Generator):
        return key
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(key))


def init(cfg: ModelConfig, key=0, *, device="cuda") -> dict:
    """The parameter tree, fp32, drawn from ``key`` (an int seed or a
    ``torch.Generator`` on ``device``) at the reference's scales: the
    embedding (and an untied head) 0.02, dense weights 1/sqrt(fan_in)
    (an expert's 1/sqrt(d_model), its down projection
    1/sqrt(moe_d_ff)), the RG-LRU's ``lam`` uniform on [0.9, 0.999),
    norms ones.  ``device="meta"`` gives the shapes without memory."""
    gen = _generator(key, device)
    pat, n_units, tail = pattern_layout(cfg)
    vp = cfg.vocab_padded
    params: dict = {"embed": L._normal(gen, (vp, cfg.d_model), 0.02,
                                       device)}
    if not cfg.tie_embeddings:
        params["head"] = L._normal(gen, (cfg.d_model, vp), 0.02, device)
    params["ln_f"] = L.init_rmsnorm(cfg.d_model, device=device)
    if n_units:
        params["units"] = {f"b{i}": _init_block(gen, kind, cfg,
                                                lead=(n_units,),
                                                device=device)
                           for i, kind in enumerate(pat)}
    if tail:
        params["tail"] = [_init_block(gen, pat[i], cfg, device=device)
                          for i in range(tail)]
    return params


# ------------------------------ blocks ------------------------------

def _block_apply(kind: str, p, x, cfg: ModelConfig, *, positions,
                 cache=None):
    """Returns (x, aux); a cache is written in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "attn":
        window = cfg.local_window if cfg.family == "hybrid" else 0
        h, _ = L.attn_apply(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                            cfg, positions=positions,
                            cache=cache["attn"] if cache else None,
                            window=window, norm_eps=cfg.norm_eps)
        x = x + h
        hin = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if cfg.n_experts:
            y, aux = L.moe_apply(p["moe"], hin, cfg)
            if cfg.dense_residual:
                y = y + L.mlp_apply(p["mlp"], hin)
            x = x + y
        elif cfg.d_ff:
            x = x + L.mlp_apply(p["mlp"], hin)
    elif kind == "rec":
        h, _ = L.rec_apply(p["rec"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                           cfg, cache=cache["rec"] if cache else None)
        x = x + h
        x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    elif kind in ("mlstm", "slstm"):
        apply = L.mlstm_apply if kind == "mlstm" else L.slstm_apply
        h, _ = apply(p["mix"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                     cache=cache["mix"] if cache else None)
        x = x + h
    else:
        raise ValueError(kind)
    return x, aux


def _init_block_cache(kind: str, cfg: ModelConfig, batch: int,
                      max_seq: int, dtype, *, lead=(), device="cpu"):
    kw = dict(lead=lead, device=device)
    if kind == "attn":
        window = cfg.local_window if cfg.family == "hybrid" else 0
        return {"attn": L.init_attn_cache(cfg, batch, max_seq, dtype,
                                          window=window, **kw)}
    if kind == "rec":
        return {"rec": L.init_rec_cache(cfg, batch, **kw)}
    if kind == "mlstm":
        return {"mix": L.init_mlstm_cache(cfg, batch, **kw)}
    if kind == "slstm":
        return {"mix": L.init_slstm_cache(cfg, batch, **kw)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device="cuda") -> dict:
    pat, n_units, tail = pattern_layout(cfg)
    cache: dict = {}
    if n_units:
        cache["units"] = {f"b{i}": _init_block_cache(
            kind, cfg, batch, max_seq, dtype, lead=(n_units,),
            device=device) for i, kind in enumerate(pat)}
    if tail:
        cache["tail"] = [
            _init_block_cache(pat[i], cfg, batch, max_seq, dtype,
                              device=device) for i in range(tail)]
    return cache


# ----------------------------- forward -----------------------------

def _unstack(tree, n: int) -> list:
    """The ``n`` per-unit trees of a tree stacked over axis 0: views
    from one ``unbind`` per leaf, whose backward stacks the units'
    gradients into the stacked leaf once (indexing each unit apart
    would add a zero-filled stack-sized gradient per unit)."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    is_part = lambda t: isinstance(t, tuple)  # noqa: E731
    return [tree_map(lambda t: t[u], parts, is_leaf=is_part)
            for u in range(n)]


def _run_stack(params, cfg, x, positions, cache=None, remat=False):
    """Apply all layers; returns (x, cache, aux_sum).  A cache is
    written in place (through the per-unit views of its stacked
    leaves) and returned."""
    pat, n_units, tail = pattern_layout(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ucache = cache.get("units") if cache else None

    def unit(x, up, uc):
        aux_sum = None
        for i, kind in enumerate(pat):
            bc = uc[f"b{i}"] if uc is not None else None
            x, aux = _block_apply(kind, up[f"b{i}"], x, cfg,
                                  positions=positions, cache=bc)
            aux_sum = aux if aux_sum is None else aux_sum + aux
        return x, aux_sum

    ups = _unstack(params["units"], n_units) if n_units else []
    ucs = _unstack(ucache, n_units) if ucache is not None \
        else [None] * n_units
    for up, uc in zip(ups, ucs):
        if remat and uc is None:
            x, aux = checkpoint(lambda x, up: unit(x, up, None), x, up,
                                use_reentrant=False)
        else:
            x, aux = unit(x, up, uc)
        aux_total = aux_total + aux

    for i in range(tail):
        bc = cache["tail"][i] if cache else None
        x, aux = _block_apply(pat[i], params["tail"][i], x, cfg,
                              positions=positions, cache=bc)
        aux_total = aux_total + aux

    return x, cache or None, aux_total


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _embed(params, tokens, embeds, dtype):
    if embeds is None:
        return params["embed"][tokens].to(dtype)
    return embeds.to(dtype)


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            positions=None, remat: bool = False, dtype=torch.bfloat16,
            last_only: bool = False):
    """Full-sequence forward (train / prefill).  Returns (logits, aux).

    tokens: (B, S) integers, or embeds: (B, S, D) for stub-frontend
    archs.  positions: (B, S) or (3, B, S) for M-RoPE; defaults to
    arange.  last_only: emit logits only for the final position."""
    x = _embed(params, tokens, embeds, dtype)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if cfg.mrope_sections:
            positions = positions[None].expand(3, B, S)
    x, _, aux = _run_stack(params, cfg, x, positions, remat=remat)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = x @ _head(params, cfg).to(x.dtype)
    return _mask_padded_vocab(logits, cfg), aux


def _mask_padded_vocab(logits, cfg):
    """Padded vocab rows (see configs.vocab_padded) get -1e30 logits so
    softmax/argmax ignore them."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    valid = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
    return torch.where(valid, logits, -1e30)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens, cache, *, embeds=None,
                dtype=torch.bfloat16):
    """Decode S >= 1 tokens: tokens (B, S) + caches -> (logits, cache).
    Prefill is a decode step with S = the prompt length.  The cache is
    the caller's, written in place (K/V at its position, the position
    advanced) and returned.  Nothing here waits on the host: the
    position is read from the cache on the device."""
    x = _embed(params, tokens, embeds, dtype)
    B, S = x.shape[:2]
    pos = _decode_positions(cfg, cache, B, S)
    x, cache, _ = _run_stack(params, cfg, x, pos, cache=cache)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = _mask_padded_vocab(x @ _head(params, cfg).to(x.dtype), cfg)
    return logits, cache


def _decode_positions(cfg, cache, B, S):
    """Absolute positions of the S incoming tokens, from the first
    attention cache's position (zero if there is none)."""
    pos0 = _find_attn_pos(cache)
    device = next(iter(_cache_leaves(cache))).device
    if pos0 is None:
        pos0 = torch.zeros((), dtype=torch.int32, device=device)
    p = (pos0 + torch.arange(S, device=device))[None].expand(B, S)
    if cfg.mrope_sections:
        p = p[None].expand(3, B, S)
    return p


def _cache_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _cache_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _cache_leaves(v)
    else:
        yield tree


def _find_attn_pos(tree):
    if isinstance(tree, dict):
        if "pos" in tree and not isinstance(tree["pos"], dict):
            p = tree["pos"]
            # stacked over units: take the first
            return p.reshape(-1)[0] if p.ndim else p
        for v in tree.values():
            r = _find_attn_pos(v)
            if r is not None:
                return r
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            r = _find_attn_pos(v)
            if r is not None:
                return r
    return None


# ------------------------------ loss ------------------------------

def loss_fn(params, cfg: ModelConfig, batch, *, remat=False,
            dtype=torch.bfloat16, aux_weight: float = 0.01):
    """Next-token cross entropy in fp32 (+ the MoE aux loss, summed over
    the blocks; zero without experts).  batch: dict with tokens (B, S) and labels (B, S) (already
    shifted), optional embeds and mask.  The label's logit is gathered,
    where the reference reduces a one-hot mask for its partitioner."""
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          embeds=batch.get("embeds"), remat=remat,
                          dtype=dtype)
    labels = batch["labels"].long()
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss = ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * aux
