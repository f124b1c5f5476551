"""Collectives on ``torch.distributed`` with the reference's cost
accounting (the counterpart of ``repro.core.comm``).

One process runs each rank of the p1 x p1 x p2 mesh ("x", "y", "z").
The port's counterpart of a ``shard_map`` body is a plain function on
this rank's local piece, run in every rank; it names mesh axes as the
reference does, and :func:`on_mesh` binds those names to the
:class:`Mesh` of the program being run.

Every wrapper (a) issues the collective on the axis's process group
and (b), when a :class:`CostTrace` is active, records the paper's
alpha-beta-gamma cost of the call from static shapes (Sec. II-C1
closed forms), once, where the call starts.  Recording happens during
a real run: a program's trace is the costs of the collectives it ran.

Cost conventions (paper Sec. II-C1, words = elements):
    allgather(n_total, p):      S = log p,   W = n_total * 1_p
    reduce-scatter(n_total, p): S = log p,   W = n_total * 1_p, F = n_total * 1_p
    allreduce(n, p):            S = 2 log p, W = 2 n * 1_p,     F = n * 1_p
    bcast(n, p):                S = 2 log p, W = 2 n * 1_p
    all-to-all(n_local, p):     S = log p,   W = n_local * log(p) / 2
    point-to-point (permute):   S = 1,       W = n_local

Axes of size 1 run no collective but are recorded all the same (their
S, W and F are 0 and the call counts in ``by_op``), as in the
reference.

:func:`vmapped` plays ``jax.vmap``'s part for collectives: inside it,
``axis`` arguments name per-example dimensions (leading batch
dimensions are skipped) and costs are priced per example, which is
what the reference records for a vmapped body.

Staging: a gloo group exchanges host memory.  On a gloo group a CUDA
tensor is copied to the host, exchanged and copied back, and
:attr:`Mesh.staged_bytes` counts both copies; on an NCCL group nothing
is staged.  Where ranks share one card (NCCL refuses two ranks on one
GPU), every kernel still runs on the card and only the exchange goes
through the host.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import inspect
import itertools
import math
from typing import Sequence

import torch
import torch.distributed as dist

MESH_AXES = ("x", "y", "z")


def _lg(p: float) -> float:
    return math.log2(max(p, 1.0))


def _ind(p: float) -> float:
    return 1.0 if p > 1 else 0.0


# ------------------------------ cost records ------------------------------

@dataclasses.dataclass
class Record:
    op: str
    axis: str
    p: int
    words: float      # payload measure used by the closed form (see op)
    s: float          # latency contribution (messages)
    w: float          # bandwidth contribution (words)
    f: float          # flop contribution
    mult: float       # loop multiplier in effect
    label: str = ""   # the enclosing :func:`labelled` scope ("" outside)


@dataclasses.dataclass
class CostTrace:
    records: list[Record] = dataclasses.field(default_factory=list)

    @property
    def s(self) -> float:
        return sum(r.s * r.mult for r in self.records)

    @property
    def w(self) -> float:
        return sum(r.w * r.mult for r in self.records)

    @property
    def f(self) -> float:
        return sum(r.f * r.mult for r in self.records)

    def by_op(self) -> dict:
        out: dict[str, dict] = {}
        for r in self.records:
            d = out.setdefault(r.op, dict(count=0.0, s=0.0, w=0.0, f=0.0))
            d["count"] += r.mult
            d["s"] += r.s * r.mult
            d["w"] += r.w * r.mult
            d["f"] += r.f * r.mult
        return out

    def summary(self) -> dict:
        return dict(s=self.s, w=self.w, f=self.f)

    def part(self, label: str = "") -> "CostTrace":
        """The records made inside :func:`labelled` scope ``label`` ("":
        those made outside every labelled scope)."""
        return CostTrace([r for r in self.records if r.label == label])


_ACTIVE: contextvars.ContextVar[CostTrace | None] = \
    contextvars.ContextVar("repro_torch_comm_trace", default=None)
_MULT: contextvars.ContextVar[float] = \
    contextvars.ContextVar("repro_torch_comm_mult", default=1.0)
_LEAD: contextvars.ContextVar[int] = \
    contextvars.ContextVar("repro_torch_comm_lead", default=0)
_MESH: contextvars.ContextVar["Mesh | None"] = \
    contextvars.ContextVar("repro_torch_comm_mesh", default=None)
_LABEL: contextvars.ContextVar[str] = \
    contextvars.ContextVar("repro_torch_comm_label", default="")


@contextlib.contextmanager
def trace():
    """Activate cost recording; yields the CostTrace being filled."""
    t = CostTrace()
    tok = _ACTIVE.set(t)
    try:
        yield t
    finally:
        _ACTIVE.reset(tok)


@contextlib.contextmanager
def scope(mult: float):
    """Multiply costs recorded inside by ``mult`` (loop trip counts)."""
    tok = _MULT.set(_MULT.get() * mult)
    try:
        yield
    finally:
        _MULT.reset(tok)


@contextlib.contextmanager
def vmapped(lead: int = 1, *, exact: bool = False):
    """Collectives inside act on ``lead`` more leading batch dimensions:
    their ``axis`` arguments skip them and their costs are priced per
    example (the reference's ``jax.vmap`` of a body).  ``exact`` sets
    the count to ``lead`` whatever encloses it, for a body that flattens
    every leading axis into one."""
    tok = _LEAD.set(lead if exact else _LEAD.get() + lead)
    try:
        yield
    finally:
        _LEAD.reset(tok)


@contextlib.contextmanager
def labelled(label: str):
    """Tag the costs recorded inside with ``label``
    (:meth:`CostTrace.part` selects them): a program's own scopes, such
    as a refinement residual's product, apart from its solve."""
    tok = _LABEL.set(label)
    try:
        yield
    finally:
        _LABEL.reset(tok)


@contextlib.contextmanager
def unrecorded():
    """Record nothing inside: a body run once per example in a loop
    prices like one run of it (the reference's ``lax.scan`` traces its
    body once)."""
    tok = _ACTIVE.set(None)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


@contextlib.contextmanager
def on_mesh(mesh: "Mesh | None"):
    """Bind the axis names of the collectives inside to ``mesh``."""
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def _size(x: torch.Tensor) -> int:
    return int(math.prod(x.shape[_LEAD.get():]))


def _rec(op, axis, p, words, s, w, f):
    t = _ACTIVE.get()
    if t is not None:
        name = ",".join(axis) if isinstance(axis, (tuple, list)) else str(axis)
        t.records.append(Record(op, name, p, words, s, w, f, _MULT.get(),
                                _LABEL.get()))


# ---------------------------------- mesh ----------------------------------

def rank_of(x: int, y: int, z: int, p1: int, p2: int) -> int:
    """x-major, row-major rank numbering, rank = (x p1 + y) p2 + z: the
    order the reference's tuple-axis collectives assume."""
    return (x * p1 + y) * p2 + z


def coords_of(rank: int, p1: int, p2: int) -> tuple:
    return rank // (p1 * p2), rank // p2 % p1, rank % p2


def _axes(axis_name) -> tuple:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


# the axis groups every program may name; a tuple's index is row-major
# over its axes, which is the group rank (the ranks of a group sorted)
_GROUP_AXES = (("x",), ("y",), ("z",), ("x", "y"), MESH_AXES)


@dataclasses.dataclass(eq=False)
class Mesh:
    """The ("x", "y", "z") process mesh of shape (p1, p1, p2), from this
    rank's side: its coordinates and, for each axis group it may name,
    the process group it belongs to and that group's global ranks.
    Compared by identity, so a grid holding it keys its own programs."""
    p1: int
    p2: int
    rank: int
    groups: dict                 # axes tuple -> (ProcessGroup, ranks)
    staged_bytes: int = 0        # host copies of gloo-staged tensors

    @property
    def coords(self) -> tuple:
        return coords_of(self.rank, self.p1, self.p2)

    def size(self, axes: tuple) -> int:
        dims = dict(x=self.p1, y=self.p1, z=self.p2)
        return math.prod(dims[a] for a in axes)

    def index(self, axes: tuple) -> int:
        c = dict(zip(MESH_AXES, self.coords))
        dims = dict(x=self.p1, y=self.p1, z=self.p2)
        i = 0
        for a in axes:
            i = i * dims[a] + c[a]
        return i

    def group(self, axes: tuple):
        try:
            return self.groups[axes]
        except KeyError:
            raise ValueError(f"no process group for axes {axes}: the mesh "
                             f"builds {_GROUP_AXES}") from None

    def staged(self, group, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through the host on ``group``: a CUDA
        tensor on a gloo group (gloo exchanges host memory)."""
        return t.is_cuda and dist.get_backend(group[0]) == "gloo"


_MESHES: dict = {}


def make_mesh(p1: int, p2: int, timeout=None) -> Mesh:
    """This rank's :class:`Mesh` in the initialized default process
    group, whose world size must be p1 * p1 * p2.  Every rank creates
    every group, in the same order (``new_group`` is collective over the
    world), and keeps those it belongs to; an axis of size 1 gets none.
    Memoized per world, so every grid of a run shares one mesh.
    ``timeout`` (a ``timedelta``) bounds each collective of the new
    groups; a group does not inherit the world's (``new_group``
    defaults to the backend's, 30 minutes).

    The groups are explicit ``new_group`` calls rather than
    ``init_device_mesh``: the mesh's tuple axes (("x", "y"), the whole
    mesh) would need its private ``_flatten``, and its device type
    would tie the groups to a card, which several ranks may share."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {p1} x {p1} x {p2} grid spans {p1 * p1 * p2} processes: "
            f"call torch.distributed.init_process_group (world size "
            f"{p1 * p1 * p2}) in each of them first")
    p = p1 * p1 * p2
    if dist.get_world_size() != p:
        raise RuntimeError(f"a {p1} x {p1} x {p2} grid needs a world of "
                           f"{p} processes, got {dist.get_world_size()}")
    key = (p1, p2, id(dist.group.WORLD))
    if key not in _MESHES:
        rank = dist.get_rank()
        dims = dict(x=p1, y=p1, z=p2)
        groups = {}
        for axes in _GROUP_AXES:
            if math.prod(dims[a] for a in axes) == 1:
                continue
            others = [a for a in MESH_AXES if a not in axes]
            for fixed in itertools.product(*(range(dims[a])
                                             for a in others)):
                ranks = []
                for idx in itertools.product(*(range(dims[a])
                                               for a in axes)):
                    c = dict(zip(others, fixed))
                    c.update(zip(axes, idx))
                    ranks.append(rank_of(c["x"], c["y"], c["z"], p1, p2))
                if axes == MESH_AXES:
                    grp = dist.group.WORLD
                else:
                    grp = dist.new_group(ranks, timeout=timeout)
                if rank in ranks:
                    groups[axes] = (grp, ranks)
        _MESHES[key] = Mesh(p1, p2, rank, groups)
    return _MESHES[key]


def current_mesh() -> Mesh:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("a collective ran outside comm.on_mesh: run "
                           "the shard body through its grid's program")
    return mesh


def axis_size(axis_name) -> int:
    return current_mesh().size(_axes(axis_name))


def axis_index(axis_name) -> int:
    return current_mesh().index(_axes(axis_name))


# ------------------------------ the exchanges ------------------------------
#
# Each exchange makes its operand contiguous, stages it to the host on a
# gloo group, runs the collective (``async_op`` for the start/finish
# pairs) and returns ``done``: wait, copy back to the operand's device,
# fix the layout up.

def _exchange(axes: tuple, x: torch.Tensor, make_out, call, fixup,
              async_op: bool):
    mesh = current_mesh()
    grp = mesh.group(axes)
    dev = x.device
    staged = mesh.staged(grp, x)
    src = x.contiguous()
    if staged:
        src = src.cpu()
        mesh.staged_bytes += src.nbytes
    out = make_out(src)
    work = call(out, src, grp[0], async_op)

    def done(src=src):               # src lives until the work is done
        if work is not None:
            for w in (work if isinstance(work, list) else [work]):
                w.wait()
        res = out
        if staged:
            res = res.to(dev)
            mesh.staged_bytes += res.nbytes
        return fixup(res)
    return done if async_op else done()


def _ready(value):
    """A finished exchange, as a handle (size-1 axes)."""
    return lambda: value


def _gather(x, axes, axis, tiled, async_op):
    p = current_mesh().size(axes)
    ax = axis + _LEAD.get()
    if p == 1:
        out = x if tiled else x.unsqueeze(ax)
        return _ready(out) if async_op else out

    def make_out(src):
        return torch.empty((p,) + tuple(src.shape), dtype=src.dtype,
                           device=src.device)

    def call(out, src, group, a):
        return _ALL_GATHER(out.view(-1), src.view(-1), group=group,
                           async_op=a)

    def fixup(g):                                    # (p, *x.shape)
        g = g.movedim(0, ax)
        if not tiled:
            return g
        shape = tuple(x.shape)
        return g.reshape(shape[:ax] + (p * shape[ax],) + shape[ax + 1:])
    return _exchange(axes, x, make_out, call, fixup, async_op)


def _psum(x, axes):
    if current_mesh().size(axes) == 1:
        return x

    def make_out(src):
        return src.clone()               # all_reduce works in place

    def call(out, src, group, a):
        return dist.all_reduce(out, group=group, async_op=a)
    return _exchange(axes, x, make_out, call, lambda r: r, False)


# all_gather_into_tensor and reduce_scatter_tensor are deprecated in
# favour of all_gather_single and reduce_scatter_single from torch 2.13;
# earlier versions have only the former
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
# P2POp takes the peer's rank in its group (group_peer) from torch 2.6;
# earlier versions take its global rank (peer)
_GROUP_PEER = "group_peer" in inspect.signature(dist.P2POp.__init__).parameters


# ------------------------------- the wrappers -------------------------------

def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    axes = _axes(axis_name)
    p = axis_size(axes)
    n_total = _size(x) * p
    _rec("allgather", axis_name, p, n_total,
         s=_lg(p), w=n_total * _ind(p), f=0.0)
    return _gather(x, axes, axis, tiled, False)


def psum(x, axis_name):
    axes = _axes(axis_name)
    p = axis_size(axes)
    n = _size(x)
    _rec("allreduce", axis_name, p, n,
         s=2 * _lg(p), w=2 * n * _ind(p), f=n * _ind(p))
    return _psum(x, axes)


def psum_scatter(x, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False):
    axes = _axes(axis_name)
    p = axis_size(axes)
    n_total = _size(x)          # input holds the full (pre-scatter) array
    _rec("reduce-scatter", axis_name, p, n_total,
         s=_lg(p), w=n_total * _ind(p), f=n_total * _ind(p))
    d = scatter_dimension + _LEAD.get()
    if p == 1:
        return x if tiled else x.squeeze(d)
    moved = x.movedim(d, 0)

    def make_out(src):
        return torch.empty((src.shape[0] // p,) + tuple(src.shape[1:]),
                           dtype=src.dtype, device=src.device)

    def call(out, src, group, a):
        return _REDUCE_SCATTER(out, src, group=group, async_op=a)

    def fixup(r):
        return r.movedim(0, d) if tiled else r[0]
    return _exchange(axes, moved, make_out, call, fixup, False)


def all_to_all(x, axis_name, *, split_axis: int, concat_axis: int,
               tiled: bool = False):
    """The tiled all-to-all (the only form the algorithms use): ``x``
    splits into p chunks along ``split_axis``, chunk j goes to member j,
    and the chunks received are concatenated along ``concat_axis`` in
    the order of their senders."""
    if not tiled:
        raise ValueError("all_to_all takes tiled=True only")
    axes = _axes(axis_name)
    p = axis_size(axes)
    n_local = _size(x)
    _rec("alltoall", axis_name, p, n_local,
         s=_lg(p), w=n_local * _lg(p) / 2.0, f=0.0)
    if p == 1:
        return x
    lead = _LEAD.get()
    sa, ca = split_axis + lead, concat_axis + lead
    moved = x.movedim(sa, 0)                      # (S, rest...)

    def call(out, src, group, a):
        return dist.all_to_all_single(out, src, group=group, async_op=a)

    def fixup(r):
        chunk = (p, r.shape[0] // p) + tuple(r.shape[1:])
        r = r.reshape(chunk).movedim(1, sa + 1)   # (p, *x with S/p at sa)
        shape = tuple(r.shape[1:])
        r = r.movedim(0, ca)
        return r.reshape(shape[:ca] + (p * shape[ca],) + shape[ca + 1:])
    return _exchange(axes, moved, torch.empty_like, call, fixup, False)


def _permute(x, axes, perm, async_op):
    mesh = current_mesh()
    me = mesh.index(axes)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return _ready(x) if async_op else x
    ranks = mesh.group(axes)[1]

    def peer(j):
        return dict(group_peer=j) if _GROUP_PEER else dict(peer=ranks[j])

    def make_out(s):
        return torch.zeros_like(s)

    def call(out, s, group, a):
        ops = [dist.P2POp(dist.isend, s, group=group, **peer(j))
               for j in dst if j != me]
        ops += [dist.P2POp(dist.irecv, out, group=group, **peer(j))
                for j in src if j != me]
        if me in src:
            out.copy_(s)
        works = dist.batch_isend_irecv(ops) if ops else []
        if not a:
            for w in works:
                w.wait()
            return None
        return works
    return _exchange(axes, x, make_out, call, lambda r: r, async_op)


def ppermute(x, axis_name, perm: Sequence[tuple[int, int]]):
    axes = _axes(axis_name)
    p = axis_size(axes)
    n_local = _size(x)
    _rec("permute", axis_name, p, n_local, s=1.0, w=n_local, f=0.0)
    return _permute(x, axes, perm, False)


# ------------------- async (start/finish) wrappers -------------------
#
# ``*_start`` issues the collective (``async_op=True``) and returns a
# handle; ``*_finish`` waits for it, copies a staged result back and
# fixes its layout up.  The cost is recorded once, at start, so a
# start/finish pair prices as the synchronous wrapper it replaces.

def all_gather_start(x, axis_name, *, axis: int = 0, tiled: bool = False):
    """Begin ``all_gather``; pair with :func:`all_gather_finish`."""
    axes = _axes(axis_name)
    p = axis_size(axes)
    n_total = _size(x) * p
    _rec("allgather", axis_name, p, n_total,
         s=_lg(p), w=n_total * _ind(p), f=0.0)
    return _gather(x, axes, axis, tiled, True)


def all_gather_finish(handle):
    """Complete an :func:`all_gather_start` (cost already recorded)."""
    return handle()


def ppermute_start(x, axis_name, perm: Sequence[tuple[int, int]]):
    """Begin ``ppermute``; pair with :func:`ppermute_finish`."""
    axes = _axes(axis_name)
    p = axis_size(axes)
    n_local = _size(x)
    _rec("permute", axis_name, p, n_local, s=1.0, w=n_local, f=0.0)
    return _permute(x, axes, perm, True)


def ppermute_finish(handle):
    """Complete a :func:`ppermute_start` (cost already recorded)."""
    return handle()


def bcast_from(x, axis_name, root: int = 0):
    """Broadcast the value held at ``root`` along ``axis_name`` to all,
    as mask + psum, priced as the paper's bcast (2 log p latency, 2n
    bandwidth), as the reference prices it."""
    axes = _axes(axis_name)
    p = axis_size(axes)
    n = _size(x)
    _rec("bcast", axis_name, p, n,
         s=2 * _lg(p), w=2 * n * _ind(p), f=0.0)
    masked = x if axis_index(axes) == root else torch.zeros_like(x)
    return _psum(masked, axes)


def gather_all_unrecorded(x: torch.Tensor) -> torch.Tensor:
    """(p, *x.shape): every rank's ``x``, in rank order, on every rank,
    and no cost recorded (a layout change, as the reference's
    resharding of a program's output is not a collective of it)."""
    return _gather(x, MESH_AXES, 0, False, False)
