"""The model zoo (the counterpart of ``repro.models``): pytree-functional
implementations of the ten architectures (dense / MoE / hybrid-recurrent
/ SSM / VLM-backbone / enc-dec audio backbone), and the rules that
place their parameters, caches and batches on a mesh of ranks.

Entry points:
    lm.init(cfg, key, device=...)       parameter tree (fp32)
    lm.forward(params, cfg, tokens)     logits (train/prefill)
    lm.decode_step(params, cfg, ...)    decode with caches
    lm.init_cache(cfg, batch, seq)      decode caches
    whisper.init / encode / decode / init_cache / loss_fn
                                        the encoder-decoder
    sharding.param_specs / cache_specs / batch_specs, shard, gather
                                        the sharding rules
"""
