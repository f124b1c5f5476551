"""The train step: loss, gradients (summed over microbatches), the
optimizer's update, on one device or on a mesh of ranks (the
counterpart of ``repro.train.train_step``).

``make_train_step`` is the one-device step.  ``jit_train_step`` runs
the same step on a named mesh (``launch.mesh``), nothing compiled: the
name is the reference's, whose ``jax.jit`` with explicit shardings it
stands for.  Each rank stores only its pieces of the parameters, the
optimizer state and the batch, as ``models.sharding``'s rules and
:func:`opt_state_specs` place them, and each step

  * gathers every parameter whole (``all_gather`` over the axes of each
    split dimension) and the batch's sequence where ``fsdp_all`` split
    it over "model" (causal attention needs all of it);
  * computes the loss and gradients on whole tensors, microbatch by
    microbatch.  The batch's M microbatches are the reference's (rows
    [i B/M, (i+1) B/M)), each computed as one device computes it, so
    that an MoE's routing (capacity, aux loss) sees its microbatch's
    tokens.  Where the data-parallel size D divides M, each data rank
    computes the M/D microbatches its rows hold and the loss and
    gradients are averaged over the data-parallel axes (the backward
    of the gathers: the reduce-scatter the reference's partitioner
    derives, here an all-reduce and a slice); otherwise every rank
    computes every microbatch.  Ranks along "model" repeat their rows'
    compute;
  * updates: the optimizer gets whole the parameters it needs whole
    (``Optimizer.needs_whole``: none for ``adamw``, the preconditioned
    ones for ``kfac_ca``, whose Kronecker factors match no parameter
    shape and are replicated), with their gathered state, and every
    other leaf as this rank's shards of parameter, gradient and state,
    with the whole gradient's global norm (ZeRO); every rank computes
    the same update of the whole leaves and keeps its shards of it.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import comm
from repro_torch.models import lm, whisper
from repro_torch.models import sharding as shard_rules
from repro_torch.models.sharding import P
from repro_torch.optim.adamw import Optimizer, global_norm
from repro_torch.optim.tree import leaves, leaves_with_keys, tree_map, \
    tree_map_with_keys
from repro_torch.train import compress


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


def _grads_fn(cfg: ModelConfig, microbatches: int, remat: bool, dtype):
    """``(params, batch) -> (loss, grads)`` on the batch's rows: with
    ``microbatches > 1`` the rows split along the first axis and the loss
    and gradients are the microbatches' means, summed in order as the
    reference's scan sums them."""
    loss_fn = loss_for(cfg)

    def loss_of(p, b):
        if cfg.enc_dec:     # each layer is rematerialized regardless
            return loss_fn(p, cfg, b, dtype=dtype)
        return loss_fn(p, cfg, b, remat=remat, dtype=dtype)

    def grads_of(params, batch):
        if microbatches == 1:
            return _value_and_grad(loss_of, params, batch)

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
            if gsum is None:
                gsum = g
            else:                   # in place: one gradient tree held
                for a, b in zip(leaves(gsum), leaves(g)):
                    a.add_(b)
            del g
        for a in leaves(gsum):
            a.div_(microbatches)
        return lsum / microbatches, gsum
    return grads_of


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    microbatches: int = 1, remat: bool = True,
                    dtype=torch.bfloat16, compress_grads: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on the parameters' device (the batch is moved there).  With
    ``microbatches > 1`` the batch is split along its first axis (see
    :func:`_grads_fn`).  ``metrics`` holds the optimizer's and
    ``loss``, all device tensors.  ``compress_grads`` marks the
    gradients for the cross-pod reduction, which one device does not
    have: they are used as they are, as the reference's step uses them
    on a mesh without a "pod" axis."""
    grads_of = _grads_fn(cfg, microbatches, remat, dtype)

    def step_fn(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = {k: v.to(device, non_blocking=True)
                 for k, v in batch.items()}
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            new_params, new_opt, metrics = optimizer.update(
                grads, opt_state, params)
        return new_params, new_opt, dict(metrics, loss=loss)

    return step_fn


# ------------------------ optimizer state specs ------------------------

def _mirrored(opt_shapes, params, ptree, default):
    """For each optimizer state leaf, ``ptree``'s value at the parameter
    it mirrors (the longest path suffix naming a parameter of the same
    shape), or ``default``."""
    pdict = {keys: tuple(leaf.shape)
             for keys, leaf in leaves_with_keys(params)}
    vdict = dict(leaves_with_keys(ptree))

    def lookup(key, leaf):
        for i in range(len(key)):
            suf = key[i:]
            if suf in pdict and pdict[suf] == tuple(leaf.shape):
                return vdict[suf]
        return default

    return tree_map_with_keys(lookup, opt_shapes)


def opt_state_specs(opt_shapes, params, pspecs):
    """Specs for the optimizer state: leaves mirroring a parameter
    (same path suffix and shape) inherit its spec (FSDP'd optimizer
    state = ZeRO); everything else is replicated."""
    return _mirrored(opt_shapes, params, pspecs, P())


def shardings_for(cfg: ModelConfig, mesh, params, opt_shapes, batch,
                  mode: str = "2d"):
    """(params, opt_state, batch) trees of ``NamedSharding``."""
    pspecs = shard_rules.param_specs(cfg, params, mesh, mode)
    ospecs = opt_state_specs(opt_shapes, params, pspecs)
    bspecs = shard_rules.batch_specs(batch, mesh, mode)
    return tuple(shard_rules.named(s, mesh) for s in (pspecs, ospecs,
                                                      bspecs))


def _dp_mean(x, mesh, dp):
    """The mean of ``x`` over the data-parallel axes (collective)."""
    with comm.on_mesh(mesh):
        return comm.psum(x, dp) / mesh.size(dp)


def jit_train_step(cfg: ModelConfig, mesh, optimizer: Optimizer, params,
                   opt_shapes, batch, shard_mode: str = "2d", *,
                   microbatches: int = 1, remat: bool = True,
                   dtype=torch.bfloat16, compress_grads: bool = False):
    """The step on ``mesh`` (see the module's docstring):
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    every argument and result this rank's pieces (``sharding.shard``
    under :func:`shardings_for`), the metrics whole and equal on every
    rank.  ``params``, ``opt_shapes`` and ``batch`` give the global
    shapes (meta tensors will do).  Collective: every rank of the mesh
    calls the step.  ``compress_grads`` on a mesh with a "pod" axis
    passes the gradients through ``compress.tag_for_compression``, the
    identity, as the reference's jitted step does."""
    ps, os_, bs = shardings_for(cfg, mesh, params, opt_shapes, batch,
                                shard_mode)
    dp = shard_rules.dp_axes(mesh)
    n_dp = mesh.size(dp)
    B = leaves(batch)[0].shape[0]
    split = n_dp > 1 and B % n_dp == 0 and microbatches % n_dp == 0
    grads_of = _grads_fn(cfg, microbatches // n_dp if split
                         else microbatches, remat, dtype)
    tag = compress_grads and "pod" in mesh.axis_names
    whole_p = tree_map(optimizer.needs_whole, params)
    whole_s = _mirrored(opt_shapes, params, whole_p, False)

    def cut(tree, shardings, whole):
        """The whole leaves (``whole`` True) cut to this rank's pieces."""
        return tree_map(lambda t, sh, w: shard_rules.piece(t, sh) if w
                        else t, tree, shardings, whole)

    def step_fn(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = shard_rules.gather(
            {k: v.to(device, non_blocking=True) for k, v in batch.items()},
            bs, keep=dp if split else ())
        full = shard_rules.gather(params, ps)
        loss, grads = grads_of(full, batch)
        params = tree_map(lambda p, f, w: f if w else p, params, full,
                          whole_p)
        del full
        with torch.no_grad():
            if split:
                loss = _dp_mean(loss.reshape(1), mesh, dp)[0]
                for g in leaves(grads):        # one leaf's copy at a time
                    g.copy_(_dp_mean(g, mesh, dp))
            if tag:
                grads = compress.tag_for_compression(grads)
            gnorm = global_norm(grads)
            grads = tree_map(lambda g, sh, w: g if w
                             else shard_rules.piece(g, sh),
                             grads, ps, whole_p)
            opt_state = tree_map(lambda s, sh, w: shard_rules.whole(s, sh)
                                 if w else s, opt_state, os_, whole_s)
            new_params, new_opt, metrics = optimizer.update(
                grads, opt_state, params, gnorm=gnorm)
        return cut(new_params, ps, whole_p), cut(new_opt, os_, whole_s), \
            dict(metrics, loss=loss)

    return step_fn
