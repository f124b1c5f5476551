"""Serving an LM: batched prefill + greedy decode with KV caches (the
counterpart of ``repro.train.serve_step``, one device).

``lm.decode_step`` handles S >= 1 uniformly (the attention cache path
appends a block of S tokens at the current position with intra-block
causal masking), so prefill IS a decode step with S = prompt length:
one code path, no cache-format skew between prefill and decode.  The
steady decode loop queues device work only: the cache position stays a
device tensor and each token is the argmax on the device.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import lm, whisper


def make_decode_fn(cfg: ModelConfig):
    """Returns a decode fn with the exact positional signature for the
    config: (params, cache, tokens[, embeds | enc_states])."""
    if cfg.enc_dec:
        def fn(params, cache, tokens, enc_states):
            return whisper.decode(params, cfg, tokens, enc_states,
                                  cache=cache)
        return fn
    if cfg.embed_inputs:
        def fn(params, cache, tokens, embeds):
            return lm.decode_step(params, cfg, tokens, cache,
                                  embeds=embeds)
        return fn

    def fn(params, cache, tokens):
        return lm.decode_step(params, cfg, tokens, cache)
    return fn


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
