"""Seeded Kronecker-factor statistics of a configuration, made on the
device in the layout of ``kfac_ca``'s ``state["kron"]``.

K-FAC keeps, for every eligible 2-D weight W of shape (r, c) (the port
stores a linear layer as x @ W), the EMAs A = E[G G^T] (order r) and
B = E[G^T G] (order c).  A stacked weight of the LM (one per layer,
leading axis the layer) has stacked factors (layers, r, r) and
(layers, c, c).  Here each factor is the Gram matrix of a seeded random
batch of ``samples`` x order rows whose features have variances
decaying as (1 + j) ** -decay, in a random order of features: a
decaying spectrum without the model's weights.

Only the shapes come from the configuration; no weight is made.
"""

from __future__ import annotations

import torch

# (block, weight) in the LM's parameter tree and the weight's shape from
# the configuration's sizes, in the port's (input, output) layout
_WEIGHTS = (
    ("attn", "wq", lambda c: (c["hidden_size"], c["num_attention_heads"]
                              * head_dim(c))),
    ("attn", "wk", lambda c: (c["hidden_size"], c["num_key_value_heads"]
                              * head_dim(c))),
    ("attn", "wv", lambda c: (c["hidden_size"], c["num_key_value_heads"]
                              * head_dim(c))),
    ("attn", "wo", lambda c: (c["num_attention_heads"] * head_dim(c),
                              c["hidden_size"])),
    ("mlp", "gate", lambda c: (c["hidden_size"], c["intermediate_size"])),
    ("mlp", "up", lambda c: (c["hidden_size"], c["intermediate_size"])),
    ("mlp", "down", lambda c: (c["intermediate_size"], c["hidden_size"])),
)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] \
        // cfg["num_attention_heads"]


def eligible(shape, kfac: dict) -> bool:
    """kfac_ca's rule: both sides within [min_dim, max_dim]."""
    return all(kfac["min_dim"] <= s <= kfac["max_dim"] for s in shape)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one (seed, stream) pair: the run's
    seed and a fixed stream number per use, so two uses of one seed
    never share draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return g


def gram_stack(layers: int, order: int, gen, *, samples: int,
               decay: float, device, chunk_bytes: int = 1 << 31):
    """(layers, order, order) fp32 Gram matrices G^T G / t of seeded
    (t, order) batches, t = samples * order, feature j's variance
    (1 + j) ** -decay in a random order per matrix.  A few layers a
    call, so the batch held at once stays under ``chunk_bytes``."""
    t = samples * order
    out = torch.empty((layers, order, order), device=device)
    var = torch.arange(1, order + 1, device=device,
                       dtype=torch.float32).pow(-decay)
    per = max(1, chunk_bytes // (t * order * 4))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    # the batches are data: their Gram products may run on the tensor
    # cores, and the result is symmetrised, as a Gram matrix is
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for l0 in range(0, layers, per):
            m = min(per, layers - l0)
            perm = torch.rand((m, order), generator=gen,
                              device=device).argsort(-1)
            scale = var.sqrt()[perm]                       # (m, order)
            G = torch.randn((m, t, order), generator=gen, device=device)
            G.mul_(scale[:, None, :])
            M = torch.bmm(G.transpose(1, 2), G).div_(t)
            del G
            out[l0:l0 + m] = (M + M.transpose(1, 2)).mul_(0.5)
            del M
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def make_state(cfg: dict, seed: int, stream: int, device) -> dict:
    """A ``kfac_ca`` state holding only ``"kron"``: for every eligible
    weight its (A, B) factor stacks over the configuration's layers,
    drawn from ``(seed, stream)``; every other leaf is the empty tuple
    that ``kfac_ca.init`` gives an ineligible weight."""
    gen = generator(seed, stream, device)
    st = cfg["statistics"]
    layers = cfg["num_hidden_layers"]
    kron: dict = {}
    for block, name, shape_of in _WEIGHTS:
        shape = shape_of(cfg)
        leaf = ()
        if eligible(shape, cfg["kfac"]):
            leaf = tuple(gram_stack(layers, d, gen, samples=st["samples"],
                                    decay=st["decay"], device=device)
                         for d in shape)
        kron.setdefault(block, {})[name] = leaf
    return {"kron": {"units": {"b0": kron}}}


def weight_groups(cfg: dict) -> dict:
    """{(a, b): [(block, name), ...]}: the eligible weights grouped by
    their shape taken either way round, a <= b.  Every factor of order
    d in a group preconditions a gradient a + b - d wide, so banking a
    group on its own gives banks whose factors all take one width."""
    out: dict = {}
    for block, name, shape_of in _WEIGHTS:
        shape = shape_of(cfg)
        if eligible(shape, cfg["kfac"]):
            out.setdefault(tuple(sorted(shape)), []).append((block, name))
    return out


def substate(state: dict, weights) -> dict:
    """The state with only ``weights`` = [(block, name), ...] eligible:
    every other leaf the empty tuple of an ineligible weight."""
    keep = set(weights)
    kron = {block: {name: (leaf if (block, name) in keep else ())
                    for name, leaf in ws.items()}
            for block, ws in state["kron"]["units"]["b0"].items()}
    return {"kron": {"units": {"b0": kron}}}


def path_of(block: str, name: str) -> str:
    """A weight's path as ``kfac_ca``'s manifest spells it."""
    return f"['units']['b0']['{block}']['{name}']"


def factor_index(state: dict) -> dict:
    """{(path, side, layer): M} for every factor of a state, ``side``
    "A" (order r) or "B" (order c): the tags ``factor_banks_from_state``
    puts in its manifest."""
    out = {}
    for block, weights in state["kron"]["units"]["b0"].items():
        for name, leaf in weights.items():
            if not leaf:
                continue
            for side, M in zip(("A", "B"), leaf):
                for u in range(M.shape[0]):
                    out[(path_of(block, name), side, u)] = M[u]
    return out
