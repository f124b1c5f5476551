"""Sharding rules: parameter / cache / batch partition specs, and the
pieces of a tensor that the ranks of a mesh store under them (the
counterpart of ``repro.models.sharding``).

Layout on the production mesh (pod, data, model), as the reference
lays it out:

  * DP over ("pod", "data") for activations and the gradient reduction.
  * FSDP (ZeRO-3): parameters, gradients and optimizer state sharded
    over "data" on their first non-TP dimension.
  * TP: attention heads / FFN width over "model".
  * EP: MoE expert dimension over "model" when the experts divide it,
    else TP on the expert FFN width (grok's 8 experts on a 16-way axis).
  * KV caches: batch over DP, sequence over "model".

Every rule degrades gracefully: a dimension that does not divide its
mesh axes is replicated instead (``_fit``), so odd vocabularies
(whisper's 51865) and head counts (smollm's 15) still place.

A spec (:class:`P`) has one entry per tensor dimension: None, an axis
name, or a tuple of names (that dimension split over their product,
row-major in the tuple's order).  Here the rules say only where the
pieces are *stored*: :func:`shard` cuts a rank's piece of a whole
tensor and :func:`gather` puts the whole tensor back together with
``all_gather``s over each split dimension's axes.  The sharded steps
(``train.train_step.jit_train_step``, ``train.serve_step.
jit_decode_step``) gather on use and compute on whole tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import comm
from repro_torch.optim.tree import tree_map, tree_map_with_keys


class P:
    """A partition spec: one entry per leading tensor dimension (None,
    an axis name or a tuple of names); dimensions past its entries are
    replicated.  ``jax.sharding.PartitionSpec`` without JAX, entries
    normalized as it normalizes them (a tuple of one name is the name,
    an empty tuple None), and not a tuple, so that a tree of specs has
    them as its leaves."""

    __slots__ = ("_dims",)

    def __init__(self, *dims):
        self._dims = tuple(
            (d[0] if len(d) == 1 else tuple(d) or None)
            if isinstance(d, (tuple, list)) else d for d in dims)

    def __iter__(self):
        return iter(self._dims)

    def __len__(self):
        return len(self._dims)

    def __getitem__(self, i):
        return self._dims[i]

    def __eq__(self, other):
        return isinstance(other, P) and self._dims == other._dims

    def __hash__(self):
        return hash(self._dims)

    def __repr__(self):
        return f"P{self._dims!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: comm.Mesh
    spec: P


def dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axis):
    return math.prod(mesh.shape[a] for a in _axes(axis))


def _fit(mesh, shape, dims):
    """Null out spec dims that don't divide the dimension size."""
    out = []
    for size, d in zip(shape, dims):
        out.append(d if d and size % _axis_size(mesh, d) == 0 else None)
    return P(*out)


# --------------------------- parameter rules ---------------------------

def _leaf_spec(mesh, names, leaf, fsdp="data", tp="model"):
    name = names[-1]
    parent = names[-2] if len(names) > 1 else None
    nd = leaf.ndim
    stacked = ("units" in names or "enc" in names or "dec" in names)
    base = nd - 1 if stacked else nd

    def spec(*dims):
        dims = (None,) * (nd - len(dims)) + tuple(dims)  # leading stack dims
        return _fit(mesh, leaf.shape, dims)

    if name == "embed":
        # vocab over TP (logits and their gradients stay vocab-sharded
        # in the reference's partitioned program)
        return spec(tp, None)
    if name == "head":
        return spec(None, tp)
    if name in ("wq", "wk", "wv", "gate", "up", "wg", "wx", "in_x", "in_g",
                "w_ig", "w_rg", "wi", "wf"):
        if parent in ("moe",) or base == 3:
            # (E, D, F): EP over the expert dim when it divides the
            # model axis; otherwise TP on the FFN width
            E = leaf.shape[-3]
            if tp and E % _axis_size(mesh, tp) == 0:
                return spec(tp, fsdp, None)
            return spec(None, fsdp, tp)
        return spec(fsdp, tp)
    if name in ("wo", "down", "out"):
        if parent in ("moe",) or base == 3:
            E = leaf.shape[-3]
            if tp and E % _axis_size(mesh, tp) == 0:
                return spec(tp, None, fsdp)
            return spec(None, tp, fsdp)
        return spec(tp, fsdp)
    if name == "router":
        return spec(fsdp, None)
    if name == "r":                            # sLSTM recurrent (H, hd, 4hd)
        return spec(None, None, tp)
    if name == "conv_w":
        return spec(None, tp)
    # norms, biases, lambdas, scalars: replicate
    return P(*([None] * nd))


def roles(mesh, mode: str = "2d"):
    """Map sharding mode -> (fsdp_axes, tp_axis).

    "2d" (default): FSDP over "data", TP over "model".
    "fsdp_all": pure ZeRO-3, parameters sharded over data x model, no
        tensor parallelism; activations take the model axis as sequence
        parallelism (see batch_specs)."""
    if mode == "2d":
        return "data", "model"
    if mode == "fsdp_all":
        return ("data", "model"), None
    raise ValueError(mode)


def param_specs(cfg: ModelConfig, params, mesh, mode: str = "2d"):
    """A tree of :class:`P` matching ``params`` (meta tensors will do)."""
    fsdp, tp = roles(mesh, mode)
    return tree_map_with_keys(
        lambda keys, leaf: _leaf_spec(mesh, keys, leaf, fsdp=fsdp, tp=tp),
        params)


def named(specs, mesh):
    """A tree of specs as :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def param_shardings(cfg, params, mesh, mode: str = "2d"):
    return named(param_specs(cfg, params, mesh, mode), mesh)


# ----------------------------- cache rules -----------------------------

def _cache_leaf_spec(mesh, names, leaf, tp="model"):
    name = names[-1]
    dp = dp_axes(mesh)
    nd = leaf.ndim
    stacked = "units" in names or "self" in names
    lead = 1 if stacked else 0

    def spec(*dims):
        dims = (None,) * lead + tuple(dims)
        dims = dims + (None,) * (nd - len(dims))
        return _fit(mesh, leaf.shape, dims)

    if name in ("k", "v", "k_scale", "v_scale"):
        return spec(dp, tp)           # (B, S, G, ...): batch DP, seq TP
    if name == "C":                   # mLSTM (B, H, hd, hd)
        return spec(dp, None, tp)
    if name in ("n", "h", "c", "m"):  # recurrent states (B, ...)
        return spec(dp)
    if name == "conv":                # (B, w-1, D)
        return spec(dp, None, tp)
    if name == "pos":
        return P(*([None] * nd))
    return spec(dp)


def cache_specs(cfg: ModelConfig, cache, mesh):
    return tree_map_with_keys(
        lambda keys, leaf: _cache_leaf_spec(mesh, keys, leaf), cache)


# ----------------------------- batch rules -----------------------------

def batch_specs(batch, mesh, mode: str = "2d"):
    dp = dp_axes(mesh)
    seq_axis = "model" if mode == "fsdp_all" else None

    def one(keys, leaf):
        nd = leaf.ndim
        dims = (dp, seq_axis) + (None,) * (nd - 2) if nd >= 2 \
            else (dp,)
        return _fit(mesh, leaf.shape, dims[:nd])

    return tree_map_with_keys(one, batch)


def data_split(mesh, global_batch: int) -> tuple:
    """(this rank's index, count) of the equal row blocks a global batch
    splits into over the DP axes: (0, 1) where the batch does not
    divide them and every rank holds it whole (``_fit``)."""
    dp = dp_axes(mesh)
    n = _axis_size(mesh, dp)
    if not dp or global_batch % n:
        return 0, 1
    return mesh.index(dp), n


# ------------------------------- pieces -------------------------------

def _split(spec: P, nd: int, keep: tuple):
    """(dim, axes) for each dimension that ``spec`` splits over axes
    outside ``keep``."""
    out = []
    for d, entry in enumerate(tuple(spec)[:nd]):
        axes = _axes(entry)
        if not axes or set(axes) <= set(keep):
            continue
        if set(axes) & set(keep):
            raise ValueError(f"spec {spec} mixes the kept axes {keep} with "
                             f"others on dimension {d}")
        out.append((d, axes))
    return out


def local_slices(shape, spec: P, mesh, keep: tuple = ()) -> tuple:
    """The slices that cut this rank's piece of a whole tensor of
    ``shape`` (dimensions split over ``keep`` axes left whole)."""
    out = [slice(None)] * len(shape)
    for d, axes in _split(spec, len(shape), keep):
        n = mesh.size(axes)
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {axes} ({n} ranks)")
        w = shape[d] // n
        i = mesh.index(axes)
        out[d] = slice(i * w, (i + 1) * w)
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of the piece of a ``shape`` tensor a rank stores."""
    return tuple(len(range(*s.indices(n))) for s, n in zip(
        local_slices(shape, spec, mesh), shape))


def piece(t: torch.Tensor, sh: NamedSharding, keep: tuple = ()):
    """This rank's piece of the whole tensor ``t``: a copy of its slice
    (so that the whole tensor can be freed), or ``t`` itself where the
    spec splits nothing."""
    cut = local_slices(t.shape, sh.spec, sh.mesh, keep)
    if all(s == slice(None) for s in cut):
        return t
    return t[cut].clone()


def shard(tree, shardings, keep: tuple = ()):
    """Each leaf's piece (:func:`piece`) under the matching
    :class:`NamedSharding` of ``shardings`` (a tree of ``tree``'s
    structure down to its leaves).  Local: no collective."""
    return tree_map(lambda t, s: piece(t, s, keep), tree, shardings)


def whole(t: torch.Tensor, sh: NamedSharding, keep: tuple = ()):
    """The whole tensor from this rank's piece ``t``: an ``all_gather``
    over the axes of each dimension the spec splits (those of ``keep``
    left split).  Collective: every rank of the mesh calls it, on the
    same leaves in the same order."""
    with comm.on_mesh(sh.mesh):
        for d, axes in _split(sh.spec, t.ndim, keep):
            t = comm.all_gather(t, axes, axis=d, tiled=True)
    return t


def gather(tree, shardings, keep: tuple = ()):
    """:func:`whole` of every leaf (collective)."""
    return tree_map(lambda t, s: whole(t, s, keep), tree, shardings)
