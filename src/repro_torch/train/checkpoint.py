"""Checkpoints with a manifest and async save (the counterpart of
``repro.train.checkpoint``, in its on-disk format).

Format: ``step_%08d/host0.npz`` holding every leaf as a NumPy array,
keyed by its tree path joined by "/" (dict keys, list and tuple
indices), plus ``manifest.json`` (step, keys, shapes, dtypes, time).
A checkpoint is *complete* only once its manifest is written (the npz
is fsynced and renamed first), so a crash mid-save never yields a
restorable-but-corrupt state; ``latest_step`` only ever returns
complete checkpoints.  Either package restores the other's checkpoints
bit for bit.  bfloat16 leaves are stored as their uint16 bits.

Sharded state (each rank holding its pieces, ``models.sharding``):
``save(..., shardings=)`` gathers every leaf whole and rank 0 writes
the same format; ``restore(..., shardings=)`` cuts each rank's piece
for a target mesh, which may have another shape than the one that
saved (elastic resharding).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.models import sharding as shard_rules
from repro_torch.optim.tree import leaves_with_keys, tree_map


def _key(keys) -> str:
    return "/".join(str(k) for k in keys)


def _to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy()
    return t.numpy().copy()


def _flatten(tree) -> dict:
    return {_key(keys): _to_numpy(leaf)
            for keys, leaf in leaves_with_keys(tree)}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def save(ckpt_dir: str, step: int, state: dict, *, blocking: bool = True,
         shardings=None):
    """state: a nested container of tensors (params, opt_state, ...).
    With ``blocking=False`` the copy to the host and the write run on a
    thread, which is returned; the state must not be modified in place
    until it has been joined.  ``shardings``: a matching tree of
    ``NamedSharding`` when ``state`` holds this rank's pieces; every
    rank of the mesh calls ``save``, the leaves are gathered whole,
    rank 0 writes (the others return None), and a blocking save
    returns once the checkpoint is complete on every rank."""
    writer = True
    if shardings is not None:
        state = shard_rules.gather(state, shardings)
        writer = _rank() == 0
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")

    def _write():
        os.makedirs(path, exist_ok=True)
        arrays = _flatten(state)
        tmp = os.path.join(path, "host0.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, "host0.npz"))
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "time": time.time(),
        }
        mtmp = os.path.join(path, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(path, "manifest.json"))

    if blocking:
        if writer:
            _write()
        if shardings is not None:
            _barrier()
        return None
    if not writer:
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def latest_step(ckpt_dir: str) -> int | None:
    """Largest step with a COMPLETE manifest."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            s = int(d.split("_")[1])
            best = s if best is None or s > best else best
    return best


def restore(ckpt_dir: str, step: int, like, *, shardings=None,
            device=None):
    """Restore into the structure of ``like`` (a nested container of
    tensors, meta tensors included, of the global shapes): each leaf
    comes back with the stored dtype and bits, on ``device`` (default:
    the like leaf's, the CPU for a meta leaf).  ``shardings``: a
    matching tree of ``NamedSharding`` for the TARGET mesh; each leaf
    then comes back as this rank's piece (elastic reshard-on-load).
    Returns (tree, step)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "host0.npz"))
    arrays = iter([data[_key(keys)] for keys, _ in leaves_with_keys(like)])

    def load(leaf, sh):
        arr = next(arrays)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape} for a "
                             f"leaf of shape {tuple(leaf.shape)}")
        t = torch.from_numpy(arr.copy())
        if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            t = t.view(torch.bfloat16)
        if sh is not None:
            t = shard_rules.piece(t, sh)
        dev = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else leaf.device)
        return t.to(dev)

    if shardings is None:
        return tree_map(lambda leaf: load(leaf, None), like), \
            manifest["step"]
    return tree_map(load, like, shardings), manifest["step"]
