"""The model zoo's dense family (the counterpart of ``repro.models``):
pytree-functional decoder-only LMs whose blocks are all attention with
a dense MLP.

Entry points:
    lm.init(cfg, key, device=...)       parameter tree (fp32)
    lm.forward(params, cfg, tokens)     logits (train/prefill)
    lm.decode_step(params, cfg, ...)    decode with caches
    lm.init_cache(cfg, batch, seq)      decode caches
"""
