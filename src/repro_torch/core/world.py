"""Worlds of ranks for the p > 1 grids: one process per rank.

* :func:`spawn` starts p = p1 * p1 * p2 processes with the spawn start
  method (a parent holding a CUDA context cannot fork), which meet in a
  gloo world through a file in a new temporary directory (no TCP port),
  each on one device, and runs an importable ``target(grid, *args)`` in
  every rank: the selfchecks, the CLI's ``--p1``/``--p2`` without
  torchrun, the chip smoke run's distributed phases.
  :func:`spawn_ranks` starts n such processes and runs
  ``target(device, *args)``, which builds its own named meshes
  (``comm.make_named_mesh``): the LM's sharded steps.
* :func:`join` is the other way in: a process that torchrun (or any
  launcher) started with ``WORLD_SIZE``, ``RANK`` and a rendezvous in
  its environment joins that world and builds its grid
  (:func:`join_world` joins it and returns the rank's device).

Every collective of the world and of the mesh's groups waits at most
:data:`TIMEOUT_S`, so a rank that dies makes the others fail, not hang.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback

import torch

# a collective that waits longer than this fails its rank
TIMEOUT_S = 120


def launched() -> bool:
    """Whether a launcher (torchrun) put this process in a world: its
    environment names the world's size and this process's rank."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def join(p1: int, p2: int, device=None):
    """Join the world a launcher started (:func:`launched`) and return
    this rank's p1 x p1 x p2 grid, on :func:`join_world`'s device."""
    from repro_torch.core import grid as gridlib
    world = int(os.environ["WORLD_SIZE"])
    if world != p1 * p1 * p2:
        raise RuntimeError(f"a {p1} x {p1} x {p2} grid needs "
                           f"{p1 * p1 * p2} ranks, the launcher started "
                           f"{world}")
    device = join_world(device)
    return gridlib.make_trsm_mesh(p1, p2, device=device,
                                  timeout=datetime.timedelta(
                                      seconds=TIMEOUT_S))


def join_world(device=None) -> str:
    """Join the world a launcher started (:func:`launched`), unless this
    process has joined it already, and return this rank's device.  NCCL
    where each rank has a card of its own (the rank's
    ``LOCAL_RANK``-th; ``device`` unset and at least as many cards as
    ranks on the node), else gloo with every rank on ``device``
    (default ``cuda:0``).  Without a card it runs on the CPU only where
    ``device`` asks for it."""
    import torch.distributed as dist
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (the CLI's "
                           "--device cpu) to run the ranks on the CPU")
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    own_card = device is None and torch.cuda.is_available() \
        and torch.cuda.device_count() >= int(
            os.environ.get("LOCAL_WORLD_SIZE", world))
    if own_card:
        device = f"cuda:{local}"
        torch.cuda.set_device(device)
    elif device is None:
        device = "cuda:0"
    if not dist.is_initialized():
        dist.init_process_group("nccl" if own_card else "gloo",
                                timeout=datetime.timedelta(
                                    seconds=TIMEOUT_S))
    return device


def _rank_main(rank, grid, device, tmp, target, args, log_dir):
    def note(stage):
        if log_dir is not None:
            print(f"rank {rank} pid {os.getpid()}: {stage} at "
                  f"{time.time():.3f}", flush=True)

    if log_dir is not None:
        # this rank's output, gloo's and the traceback of a failure included
        log = os.open(os.path.join(log_dir, f"rank{rank}.log"),
                      os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(log, 1)
        os.dup2(log, 2)
        os.close(log)
    import torch.distributed as dist
    from repro_torch.core import grid as gridlib
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    note("started")
    try:
        world = grid if isinstance(grid, int) else \
            grid[0] * grid[0] * grid[1]
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
            world_size=world, timeout=timeout)
        note("joined the world")
        try:
            if isinstance(grid, int):   # the target builds its meshes
                result = target(device, *args)
            else:
                result = target(gridlib.make_trsm_mesh(
                    *grid, device=device, timeout=timeout), *args)
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
            note("ran the target")
            dist.barrier()
        finally:
            dist.destroy_process_group()
        note("left the world")
    except BaseException:
        traceback.print_exc()
        raise
    # the result is written and the world is gone: exit at once.  In the
    # interpreter's teardown gloo's threads have aborted a rank whose
    # every collective had finished ("terminate called without an
    # active exception", SIGABRT), failing a run that had passed
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(p1: int, p2: int, device, target, *args, log_dir=None) -> list:
    """Run ``target(grid, *args)`` in each rank of a p1 x p1 x p2 grid:
    p processes started by the spawn method (a parent holding a CUDA
    context cannot fork), a gloo world that meets through a file in a
    new temporary directory, every rank on ``device``, every collective
    bounded by :data:`TIMEOUT_S`.  ``target`` must be importable by
    name.  Returns the ranks' results (picklable), in rank order; a rank
    that raises makes this raise.  With ``log_dir``, rank r writes its
    standard output and error to ``log_dir/rank<r>.log``."""
    return _spawn((p1, p2), p1 * p1 * p2, device, target, args, log_dir)


def spawn_ranks(n: int, device, target, *args, log_dir=None) -> list:
    """:func:`spawn` for a world of ``n`` ranks that builds no grid:
    each rank runs ``target(device, *args)`` and makes the named meshes
    it needs (``comm.make_named_mesh``) over the world."""
    return _spawn(n, n, device, target, args, log_dir)


def _spawn(grid, p: int, device, target, args, log_dir) -> list:
    import torch.multiprocessing as mp
    from repro_torch.core.world import _rank_main
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(grid, device, tmp, target, args, log_dir),
                           nprocs=p, join=True, start_method="spawn")
        out = []
        for r in range(p):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
