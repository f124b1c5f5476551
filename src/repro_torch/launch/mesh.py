"""Meshes of ranks for the LM's sharded steps (the counterpart of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module starts no
process group.  Each mesh spans the whole world of ranks (one process
a rank, ``torch.distributed`` initialized by a launcher,
``core.world.spawn_ranks`` or the caller), ranks numbered row-major
over the axes as ``jax.make_mesh`` orders its devices; a mesh of one
rank needs no process group.  Any other shape and names, such as the
("pipe",) and ("pod",) meshes of the pipeline and compression, is
``core.comm.make_named_mesh``'s; ``core.comm.abstract_mesh`` names
axes without ranks, for the sharding rules alone.
"""

from __future__ import annotations

import math

from repro_torch.core import comm

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def world_size() -> int:
    """The ranks of the initialized world (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         timeout=None) -> comm.Mesh:
    """Single pod: 16 x 16 = 256 ranks ("data", "model").  Multi-pod:
    2 x 16 x 16 = 512 ranks with a leading "pod" axis.  Raises in a
    world of another size."""
    shape, axes = PRODUCTION[multi_pod]
    need = math.prod(shape)
    if world_size() != need:
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod production "
            f"mesh {shape} {axes} needs a world of {need} ranks, this one "
            f"has {world_size()}")
    return comm.make_named_mesh(shape, axes, timeout)


def make_debug_mesh(n_data: int = 2, n_model: int = 4,
                    timeout=None) -> comm.Mesh:
    """Small ("data", "model") mesh for the sharded selfchecks."""
    return comm.make_named_mesh((n_data, n_model), ("data", "model"),
                                timeout)


def from_flag(kind: str) -> comm.Mesh:
    """The mesh the CLIs' ``--mesh`` names over the world of n ranks:
    "debug" is ``make_debug_mesh(max(n // 4, 1), min(4, n))``, as the
    reference builds it over its devices; "single" and "multi" the
    production meshes (RuntimeError in a world of another size)."""
    if kind == "debug":
        n = world_size()
        return make_debug_mesh(max(n // 4, 1), min(4, n))
    return make_production_mesh(multi_pod=kind == "multi")
