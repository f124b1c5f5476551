"""Serving an LM: batched prefill + greedy decode with KV caches, on one
device or on a mesh of ranks (the counterpart of
``repro.train.serve_step``).

``lm.decode_step`` handles S >= 1 uniformly (the attention cache path
appends a block of S tokens at the current position with intra-block
causal masking), so prefill IS a decode step with S = prompt length:
one code path, no cache-format skew between prefill and decode.  The
steady decode loop queues device work only: the cache position stays a
device tensor and each token is the argmax on the device.

``jit_decode_step`` runs the decode step on a named mesh
(``launch.mesh``), nothing compiled (the name is the reference's): each
rank stores its pieces of the parameters and caches
(``models.sharding``'s ``param_specs`` and ``cache_specs``), gathers
the parameters whole and each cache leaf over every axis but the
data-parallel ones, decodes its own rows of the batch, and writes its
pieces of the cache back in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import lm, whisper
from repro_torch.models import sharding as shard_rules
from repro_torch.models.sharding import NamedSharding, P
from repro_torch.optim.tree import tree_map


def make_decode_fn(cfg: ModelConfig, dtype=torch.bfloat16):
    """Returns a decode fn with the exact positional signature for the
    config: (params, cache, tokens[, embeds | enc_states]); ``dtype``
    the compute dtype."""
    if cfg.enc_dec:
        def fn(params, cache, tokens, enc_states):
            return whisper.decode(params, cfg, tokens, enc_states,
                                  cache=cache, dtype=dtype)
        return fn
    if cfg.embed_inputs:
        def fn(params, cache, tokens, embeds):
            return lm.decode_step(params, cfg, tokens, cache,
                                  embeds=embeds, dtype=dtype)
        return fn

    def fn(params, cache, tokens):
        return lm.decode_step(params, cfg, tokens, cache, dtype=dtype)
    return fn


def serve_shardings(cfg: ModelConfig, mesh, params, cache):
    """(params, cache) trees of ``NamedSharding``."""
    return (shard_rules.param_shardings(cfg, params, mesh),
            shard_rules.named(shard_rules.cache_specs(cfg, cache, mesh),
                              mesh))


def jit_decode_step(cfg: ModelConfig, mesh, params, cache,
                    batch_size: int, dtype=torch.bfloat16):
    """The decode step on ``mesh``, with :func:`make_decode_fn`'s
    positional signature: ``(params, cache, tokens[, embeds |
    enc_states]) -> (logits, cache)``.  ``params`` and ``cache`` are
    this rank's pieces (``sharding.shard`` under
    :func:`serve_shardings`); ``tokens`` (B, S) and the extra input
    (B, ..., D) this rank's rows, ``P(dp)`` pieces of the batch
    (whole where ``batch_size`` does not divide the data-parallel
    axes); ``logits`` this rank's rows.  The cache is written in place
    and returned.  Here ``params`` and ``cache`` give the global shapes
    (meta tensors will do).  Collective: every rank of the mesh calls
    the step."""
    ps, cs = serve_shardings(cfg, mesh, params, cache)
    dp = shard_rules.dp_axes(mesh)
    fn = make_decode_fn(cfg, dtype)

    def write_back(piece, work, sh):
        if work is not piece:
            piece.copy_(work[shard_rules.local_slices(
                work.shape, sh.spec, sh.mesh, keep=dp)])

    def step(params, cache, tokens, *extra):
        full = shard_rules.gather(params, ps)
        work = shard_rules.gather(cache, cs, keep=dp)
        logits, work = fn(full, work, tokens, *extra)
        tree_map(write_back, cache, work, cs)
        return logits, cache

    return step


def rows(mesh, batch_size: int) -> NamedSharding:
    """The sharding of a batch's rows on ``mesh`` (tokens, embeds,
    logits): over the data-parallel axes where they divide
    ``batch_size``, else whole."""
    dp = shard_rules.dp_axes(mesh)
    return NamedSharding(mesh, P(dp if dp and batch_size % mesh.size(dp)
                                 == 0 else None))


def greedy_generate(cfg: ModelConfig, params, prompt, max_new: int,
                    max_seq: int, *, embeds=None):
    """Prefill then greedy decode of a decoder-only model on
    ``prompt``'s device: (B, max_new) tokens.  ``embeds`` (B, >= S +
    max_new - 1, D): the stub frontend's inputs of an ``embed_inputs``
    config, one a position, the prompt's first."""
    B, S = prompt.shape
    # Cache capacity check: prefill appends S positions, then each of
    # the max_new - 1 decode steps appends one more (the final token is
    # returned without re-entering the cache).  Past max_seq the cache
    # write would run off its end, so overflow is an error up front.
    if S + max_new - 1 > max_seq:
        raise ValueError(
            f"prompt ({S} tokens) + max_new ({max_new}) needs "
            f"{S + max_new - 1} cache positions but max_seq={max_seq}; "
            f"raise max_seq or shorten the request")

    def at(t, n):
        return None if embeds is None else embeds[:, t:t + n]

    cache = lm.init_cache(cfg, B, max_seq, device=prompt.device)
    logits, cache = lm.decode_step(params, cfg, prompt, cache,
                                   embeds=at(0, S))
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for t in range(max_new - 1):
        logits, cache = lm.decode_step(params, cfg, tok, cache,
                                       embeds=at(S + t, 1))
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1)
