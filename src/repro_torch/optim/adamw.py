"""AdamW on nested dicts of tensors, as an (init, update) pair (the
counterpart of ``repro.optim.adamw``).

State is tensors on the parameters' device, the step count included,
so ``update`` queues device work and never waits for it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.precision import as_torch_dtype
from repro_torch.optim.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    # (grads, state, params) -> (new_params, new_state, metrics)
    update: Callable
    # the parameters ``update`` needs whole, judged on the whole
    # parameter; it updates every other leaf elementwise given the whole
    # gradient's global norm (``update(..., gnorm=)``), so the sharded
    # train step hands it those as this rank's shards (ZeRO)
    needs_whole: Callable = lambda p: True


def global_norm(tree) -> torch.Tensor:
    """The 2-norm of all leaves together, in fp32."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        raise ValueError("global_norm of a tree without leaves")
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm, norm=None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm; ``norm``: the norm, where ``grads`` is a piece of the tree it
    was taken of."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _first_device(tree) -> torch.device:
    found = leaves(tree)
    return found[0].device if found else torch.device("cpu")


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          clip_norm=1.0, moment_dtype=torch.float32):
    """lr may be a float or a schedule fn(step) -> lr.  ``update(grads,
    state, params, gnorm=None)``: ``gnorm`` is the global norm of the
    whole gradient, where ``grads``, ``state`` and ``params`` are one
    rank's shards of their trees (the rest of the update is
    elementwise)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    moment_dtype = as_torch_dtype(moment_dtype)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)  # noqa: E731
        return {"m": tree_map(zeros, params),
                "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params))}

    def update(grads, state, params, gnorm=None):
        step = state["step"] + 1
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, gnorm)
        elif gnorm is None:
            gnorm = global_norm(grads)
        lr_t = lr_fn(step)
        bc1 = 1 - torch.pow(b1, step.to(torch.float32))
        bc2 = 1 - torch.pow(b2, step.to(torch.float32))

        def upd(p, g, m, v):
            gf = g.to(moment_dtype)
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            mh = m2 / bc1
            vh = v2 / bc2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * \
                p.to(moment_dtype)
            return (p - lr_t * delta.to(p.dtype)).to(p.dtype), m2, v2

        out = tree_map(upd, params, grads, state["m"], state["v"])
        is_t = lambda t: isinstance(t, tuple)  # noqa: E731
        new_params = tree_map(lambda t: t[0], out, is_leaf=is_t)
        new_m = tree_map(lambda t: t[1], out, is_leaf=is_t)
        new_v = tree_map(lambda t: t[2], out, is_leaf=is_t)
        return new_params, {"m": new_m, "v": new_v, "step": step}, \
            {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update, needs_whole=lambda p: False)
