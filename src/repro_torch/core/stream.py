"""The leader's descriptor stream of an ``AsyncSolveServer`` over p > 1
ranks (DESIGN.md Sec. 13).

An async server decides on a clock: its queues, admission verdicts,
wave composition, deadlines, sheds and the Autoscaler's replans all
depend on when things happen, so the ranks of a grid cannot each
decide.  Rank 0, the *leader*, takes every submit and makes every
decision; every other rank, a *follower*, applies what the leader
broadcasts (``AsyncSolveServer.follow``), so each collective solve runs
on the same natural B in every rank.  The broadcast runs on a gloo
group of its own over every rank, created collectively with the server
(:class:`ControlStream`), so a control message never interleaves with a
solve's collectives on the mesh's groups.  A message is one of:

* ``WAVE`` — per dispatch unit its key and, per slot, the (seq, width)
  of each request, then the RHS blocks as one packed tensor per unit;
* ``MUTATE`` — an admit, replace or evict of the fleet or bank the
  server leads, or a fleet's ``apply_plan`` (an Autoscaler's replan),
  made on the leader while it leads, with the factor (:func:`mutation`
  marks the methods; the server's ``guard`` streams them);
* ``IDLE`` — a heartbeat when nothing went out for half the group's
  timeout, so an idle follower's receive does not time out;
* ``STOP`` — the leader's ``stop()``: the followers return.

Each message also carries the fleet's LRU bookkeeping since the one
before (its clock, lookup counts and the slots a submit touched): the
follower applies it first, so its next reclaim evicts the slot the
leader's does.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import math
import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.core import errors as _errors

LEADER = 0
WAVE, MUTATE, IDLE, STOP = "wave", "mutate", "idle", "stop"
# a gloo group made without a timeout waits this long
_DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


class ControlStream:
    """One rank's end of the leader's broadcast: a gloo group over every
    rank (``new_group``: collective, so every rank makes it, in the
    same order), with the mesh's collective timeout.  ``send`` (the
    leader) and ``recv`` (a follower) move one message each, as two
    broadcasts: its sizes, then its pickled header and its tensors'
    bytes in one buffer.  Counts what went through: messages by kind,
    bytes and seconds spent in the broadcasts."""

    def __init__(self, mesh):
        timeout = mesh.timeout or _DEFAULT_TIMEOUT
        self.group = dist.new_group(backend="gloo", timeout=timeout)
        self.leader = mesh.rank == LEADER
        self.heartbeat_s = timeout.total_seconds() / 2
        self.closed = False
        self.messages: dict = {}
        self.bytes = 0
        self.seconds = 0.0
        self._last = time.monotonic()

    def send(self, kind: str, head: dict, tensors=()) -> None:
        parts = [t.detach().to("cpu").contiguous() for t in tensors]
        header = pickle.dumps((kind, head, [
            (tuple(p.shape), str(p.dtype).removeprefix("torch."),
             not t.is_cpu) for p, t in zip(parts, tensors)]))
        buf = torch.cat([torch.frombuffer(bytearray(header),
                                          dtype=torch.uint8)]
                        + [t.reshape(-1).view(torch.uint8) for t in parts])
        self._move(torch.tensor([len(header), buf.numel()],
                                dtype=torch.int64), buf, kind)

    def recv(self) -> tuple:
        """(kind, head, tensors): each tensor on the CPU and a flag
        saying whether the leader's lay on a device."""
        sizes = torch.empty(2, dtype=torch.int64)
        t0 = time.perf_counter()
        dist.broadcast(sizes, LEADER, group=self.group)
        buf = torch.empty(int(sizes[1]), dtype=torch.uint8)
        self.seconds += time.perf_counter() - t0
        self._move(None, buf, None)
        n_head = int(sizes[0])
        kind, head, specs = pickle.loads(buf[:n_head].numpy().tobytes())
        tensors, off = [], n_head
        for shape, dtype, on_device in specs:
            dtype = getattr(torch, dtype)
            nbytes = math.prod(shape) * dtype.itemsize
            tensors.append((buf[off:off + nbytes].clone().view(dtype)
                            .reshape(shape), on_device))
            off += nbytes
        self.messages[kind] = self.messages.get(kind, 0) + 1
        return kind, head, tensors

    def _move(self, sizes, buf, kind) -> None:
        t0 = time.perf_counter()
        if sizes is not None:
            dist.broadcast(sizes, LEADER, group=self.group)
        dist.broadcast(buf, LEADER, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.bytes += buf.numel() + 16
        if kind is not None:
            self.messages[kind] = self.messages.get(kind, 0) + 1
        self._last = time.monotonic()

    def heartbeat_due(self) -> bool:
        return time.monotonic() - self._last > self.heartbeat_s


def mutation(*, check: str | None = None, lock: str | None = None,
             streamable: bool = True, local: tuple = ()):
    """Mark a public mutation of a ``FactorBank`` or ``SolverFleet``.

    Without a server (``owner._relay`` None) the method runs as it is,
    under the owner's lock named ``lock``.  While a p > 1
    ``AsyncSolveServer`` leads the owner, the call goes through the
    server's ``guard(owner, kind, args, kwargs, check=, lock=)``: on the
    leader it runs the owner's ``check`` method (every argument check
    the body makes, so a bad argument raises before anything is
    streamed), streams the call and runs it; on a follower it refuses
    the call.  ``local`` names keyword arguments that stay on the
    caller's rank (a callback).  A mutation that is not ``streamable``
    (a rank's own cyclic piece) is refused while a server leads."""
    def wrap(fn):
        kind = fn.__name__

        @functools.wraps(fn)
        def run(owner, *args, **kwargs):
            held = getattr(owner, lock) if lock is not None \
                else contextlib.nullcontext()
            relay = owner._relay
            if relay is None:
                with held:
                    return fn(owner, *args, **kwargs)
            if not streamable:
                raise _errors.ServingError(
                    f"{type(owner).__name__}.{kind} takes this rank's own "
                    f"piece, which the leader cannot stream: stop the "
                    f"server, then call it on every rank")

            def checked():
                if check is not None:
                    getattr(owner, check)(*args, **kwargs)

            sent = {k: v for k, v in kwargs.items() if k not in local}
            with relay.guard(owner, kind, args, sent, check=checked,
                             lock=held):
                return fn(owner, *args, **kwargs)
        return run
    return wrap
