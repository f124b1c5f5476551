"""The train step on one device: loss, gradients (summed over
microbatches), the optimizer's update (the counterpart of
``repro.train.train_step``; its sharding specs, ``jit_train_step`` and
the cross-pod gradient compression wait for ROADMAP A15h).
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import lm, whisper
from repro_torch.optim.adamw import Optimizer
from repro_torch.optim.tree import leaves, tree_map


def loss_for(cfg: ModelConfig):
    return whisper.loss_fn if cfg.enc_dec else lm.loss_fn


def _value_and_grad(loss_of, params, batch):
    """(loss, grads): grads a tree like ``params`` (zeros where a leaf
    does not reach the loss)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_of(live, batch)
        flat = leaves(live)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(gs, flat))
    return loss.detach(), tree_map(lambda _: next(it), live)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    microbatches: int = 1, remat: bool = True,
                    dtype=torch.bfloat16, compress_grads: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on the parameters' device (the batch is moved there).  With
    ``microbatches > 1`` the batch is split along its first axis and
    the loss and gradients are the microbatches' means, summed in order
    as the reference's scan sums them.  ``metrics`` holds the
    optimizer's and ``loss``, all device tensors."""
    if compress_grads:
        raise NotImplementedError(
            "compress_grads needs a multi-pod 'pod' axis: cross-pod "
            "gradient compression is not ported yet (ROADMAP A15h)")
    loss_fn = loss_for(cfg)

    def loss_of(p, b):
        if cfg.enc_dec:     # each layer is rematerialized regardless
            return loss_fn(p, cfg, b, dtype=dtype)
        return loss_fn(p, cfg, b, remat=remat, dtype=dtype)

    def step_fn(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = {k: v.to(device, non_blocking=True)
                 for k, v in batch.items()}
        if microbatches > 1:
            def part(x, i):
                bsz = x.shape[0]
                if bsz % microbatches:
                    raise ValueError(f"batch {bsz} does not split into "
                                     f"{microbatches} microbatches")
                m = bsz // microbatches
                return x[i * m:(i + 1) * m]

            lsum = gsum = None
            for i in range(microbatches):
                mb = {k: part(v, i) for k, v in batch.items()}
                loss, g = _value_and_grad(loss_of, params, mb)
                lsum = loss if lsum is None else lsum + loss
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
            loss = lsum / microbatches
            grads = tree_map(lambda g: g / microbatches, gsum)
        else:
            loss, grads = _value_and_grad(loss_of, params, batch)

        with torch.no_grad():
            new_params, new_opt, metrics = optimizer.update(
                grads, opt_state, params)
        return new_params, new_opt, dict(metrics, loss=loss)

    return step_fn
