"""SolverFleet: the mixed-order, multi-tenant serving tier (DESIGN.md
Sec. 12), the counterpart of ``repro.core.fleet``.

A single :class:`~repro_torch.core.bank.FactorBank` holds factors of ONE
order, but the paper's consumer pattern (a per-layer K-FAC producer)
emits a whole SPECTRUM of orders per model, and a fleet of tenant
models multiplies that further.  This module adds the tier above the
banks:

* **Capacity planner** (:func:`plan_fleet`) — decides a priori, by
  pricing configurations with the alpha-beta-gamma cost model (no
  program built, no device touched), which factor orders SHARE a bucket
  via zero-padding to the bucket order versus get their own bank.
  Padding an order-d factor into an order-n bucket trades extra
  per-solve sweep work (the modeled steady-state delta) for one fewer
  dispatch per mixed-order wave; the planner merges exactly when the
  modeled padding overhead is bought back by the saved dispatch.  The
  recursive alternative is priced with the Tang 2024 bandwidth
  correction (``rec_model="tang2024"``).

* **SolverFleet** — a router over live-mutable capacity banks keyed by
  ``(n_bucket, PrecisionPolicy)``.  ``admit`` routes a factor to its
  planned bucket (zero-padded inside the bank's updater:
  ``FactorBank.admit(L, pad_to=n_bucket)``, whose phase 1 skips the
  identity tail's blocks on kernel B5), hands back a
  :class:`FleetHandle`, and — when the bucket is full — reclaims the
  least-recently-used live slot ACROSS TENANTS (one fleet-wide LRU
  clock).  Reclamation rides the banks' churn path, so it builds no
  program and moves nothing from the host; the evicted slot's
  generation counter bumps, so a stale handle (or a request submitted
  before the reclaim) is never served against the new occupant.

* **Fleet-wide stats** (:meth:`SolverFleet.stats`) — per-bucket
  occupancy plus admit / reclaim / lookup-hit-rate counters, printed
  by ``launch.serve --workload trsm-fleet --fleet-stats``.

Over p > 1 ranks a fleet keeps the front door's contract: every rank
makes each call (admit, lookup, replace, evict, apply_plan, a
``SolveServer``'s submit and drain) in the same order with the same
arguments, and every decision (routing, the integer LRU clock,
reclaims, migrations) is a function of those calls, so each rank's
banks hold the same factors in the same slots.  A p > 1
``AsyncSolveServer`` over the fleet leads it from rank 0: its
mutations, and those of each bucket's own bank (``fleet.bucket(key)
.bank.admit``, ``fleet.solver(key).replace_factor``, ...), are streamed
to the other ranks, and its lookups' LRU touches go with each message
(``core.stream``).
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

from repro_torch.core import cost_model as cm
from repro_torch.core import precision as preclib
from repro_torch.core import stream
from repro_torch.core import tuning
from repro_torch.core.bank import FactorBank
from repro_torch.core.grid import TrsmGrid
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.solver import Solver


# ------------------------------ planning ------------------------------

# modeled host overhead of one extra program dispatch per wave — the
# budget a merge's padding overhead must undercut.  The reference's
# nominal value, kept so that plans equal the reference's for the same
# explicit machine; not a time measured on the card (PERF.md has the
# host time of one bucket-wave dispatch on the H100).
DEFAULT_DISPATCH_S = 5e-5


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One planned bucket: the bank order every member order is
    zero-padded to, its precision policy, capacity, and the modeled
    per-wave costs that justified the membership."""
    n: int                       # bucket order (pad target)
    policy: PrecisionPolicy
    capacity: int
    orders: tuple[int, ...]      # member orders, descending
    counts: tuple[int, ...]      # factors per member order
    method: str                  # "inv" | "rec" (Tang-corrected pick)
    n0: int | None
    merged_s: float              # modeled s/wave serving members here
    split_s: float               # modeled s/wave with per-order banks
    structure: object | None = None   # FactorStructure (None = dense)
    overlap: str | None = "on"   # normalized SolveSpec.overlap value

    @property
    def key(self) -> tuple:
        return (self.n, self.policy)


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """The planner's output: every bucket, plus the routing map from
    member order to bucket."""
    buckets: tuple[BucketPlan, ...]
    k: int
    dispatch_s: float

    def bucket_for(self, order: int) -> BucketPlan:
        for b in self.buckets:
            if order in b.orders:
                return b
        # an unplanned order still routes: smallest bucket that fits
        fits = [b for b in self.buckets if b.n >= order]
        if not fits:
            raise ValueError(
                f"order {order} exceeds every bucket (max "
                f"{max(b.n for b in self.buckets)}); re-plan the fleet "
                f"with this order in the manifest")
        return min(fits, key=lambda b: b.n)

    def table(self) -> str:
        """The planner's bucket table, one row per bucket."""
        rows = [f"{'bucket n':>9} {'policy':>12} {'cap':>4} {'method':>6} "
                f"{'n0':>5}  {'orders (count)':<24} "
                f"{'merged s/wave':>13} {'split s/wave':>13}"]
        for b in self.buckets:
            members = ", ".join(f"{d}({c})"
                                for d, c in zip(b.orders, b.counts))
            rows.append(
                f"{b.n:>9} {b.policy.name:>12} {b.capacity:>4} "
                f"{b.method:>6} {str(b.n0):>5}  {members:<24} "
                f"{b.merged_s:>13.3e} {b.split_s:>13.3e}")
        return "\n".join(rows)


def _steady_s(n: int, k: int, grid: TrsmGrid, machine,
              n0: int | None = None, structure=None,
              overlap: bool = True) -> float:
    """Modeled steady-state seconds for one order-n, width-k solve on
    the grid — :func:`repro_torch.core.tuning.serving_steady_s`, the
    one spelling of this quantity."""
    return tuning.serving_steady_s(n, k, grid, machine=machine, n0=n0,
                                   structure=structure, overlap=overlap)


def plan_fleet(orders, grid: TrsmGrid, *, k: int = 16, precision=None,
               dtype=None, machine: cm.Machine | None = None,
               dispatch_s: float | None = None,
               headroom: int = 0, structure=None,
               overlap="auto") -> FleetPlan:
    """Decide the fleet's buckets a priori — pure cost-model
    arithmetic, no programs, no devices (a device-less
    ``plan_grid(p1, p2)`` works).

    ``orders`` is the mixed-order manifest: a ``{order: count}``
    mapping, or an iterable of orders (counted).  Greedy descending
    merge: each order joins the already-open bucket that minimizes the
    modeled padding overhead

        count * (steady_s(n_bucket) - steady_s(order))

    iff that overhead is bought back by the dispatch it saves per
    mixed-order wave (``dispatch_s``); otherwise it opens its own
    bucket.  Every bucket's method is the Tang-2024-corrected
    rec-vs-inv steady comparison at the bucket order.  ``headroom``
    adds spare capacity slots per bucket.  ``structure`` (a
    :class:`~repro_torch.core.structure.FactorStructure`) declares the
    block structure every member factor honors; it prices both sides
    of each bucket's method choice, picks each bucket's n0 from the
    structured argmin, and is stamped on the plan so
    :class:`SolverFleet` builds structured banks.

    ``machine`` defaults to the H100 preset (``tuning.default_machine``)
    and an unset ``dispatch_s`` to :data:`DEFAULT_DISPATCH_S`
    (``tuning.default_dispatch_s``: the port loads no calibration).
    ``overlap`` prices buckets with the pipelined sweep (the serving
    default) and is stamped on each bucket."""
    if hasattr(orders, "items"):
        manifest = {int(d): int(c) for d, c in orders.items()}
    else:
        manifest = {}
        for d in orders:
            manifest[int(d)] = manifest.get(int(d), 0) + 1
    if not manifest:
        raise ValueError("empty order manifest")
    if any(d < 1 or c < 1 for d, c in manifest.items()):
        raise ValueError(f"orders and counts must be >= 1: {manifest}")
    policy = preclib.resolve(precision, dtype) if (
        precision is not None or dtype is not None) \
        else preclib.PRESETS["fp32"]
    machine = machine or tuning.default_machine()
    if dispatch_s is None:
        dispatch_s = tuning.default_dispatch_s(DEFAULT_DISPATCH_S)
    from repro_torch.core import solver as solverlib
    overlap = solverlib._normalize_overlap(overlap)
    ov = overlap == "on"
    if structure is not None and structure.is_dense:
        structure = None

    # open buckets: [n_bucket, {order: count}]
    open_buckets: list[list] = []
    for d in sorted(manifest, reverse=True):
        count = manifest[d]
        own = _steady_s(d, k, grid, machine, structure=structure,
                        overlap=ov)
        best, best_extra = None, None
        for b in open_buckets:
            extra = count * (_steady_s(b[0], k, grid, machine,
                                       structure=structure,
                                       overlap=ov) - own)
            if best_extra is None or extra < best_extra:
                best, best_extra = b, extra
        if best is not None and best_extra <= dispatch_s:
            best[1][d] = count
        else:
            open_buckets.append([d, {d: count}])

    buckets = []
    for n_b, members in open_buckets:
        orders_desc = tuple(sorted(members, reverse=True))
        counts = tuple(members[d] for d in orders_desc)
        method, n0, _ = tuning.choose_serving_method(
            n_b, k, grid, machine, rec_model="tang2024",
            structure=structure, overlap=ov)
        merged_s = _steady_s(n_b, k, grid, machine, n0=n0,
                             structure=structure, overlap=ov) + dispatch_s
        split_s = sum(_steady_s(d, k, grid, machine,
                                structure=structure, overlap=ov)
                      + dispatch_s
                      for d in orders_desc)
        buckets.append(BucketPlan(
            n=n_b, policy=policy, capacity=sum(counts) + headroom,
            orders=orders_desc, counts=counts, method=method,
            n0=n0 if method == "inv" else None,
            merged_s=merged_s, split_s=split_s,
            structure=structure if method == "inv" else None,
            overlap=overlap))
    return FleetPlan(buckets=tuple(buckets), k=k, dispatch_s=dispatch_s)


# ------------------------------ the fleet ------------------------------

@dataclasses.dataclass(frozen=True)
class FleetHandle:
    """A tenant's claim on one bucket slot.  ``generation`` is the
    slot's turnover counter at admission: a cross-tenant reclaim bumps
    it, so a stale handle (its slot reclaimed for someone else) is
    detected on every fleet operation instead of silently serving the
    new occupant's factor."""
    bucket: tuple                # (n_bucket, PrecisionPolicy)
    slot: int
    generation: int
    tenant: str
    tag: object
    order: int                   # the factor's TRUE order d (<= n_bucket)


class _Bucket:
    def __init__(self, plan: BucketPlan, bank: FactorBank,
                 solver: Solver):
        self.plan = plan
        self.bank = bank
        self.solver = solver
        self.handles: dict[int, FleetHandle] = {}   # slot -> handle
        self.last_used: dict[int, int] = {}         # slot -> LRU clock
        # slot -> the natural (d, d) factor as admitted (a reference,
        # not a copy — typically the caller's device tensor from
        # place_factor): live migration re-admits it into a replanned
        # bucket
        self.factors: dict[int, object] = {}
        self.admits = 0
        self.reclaims = 0


class SolverFleet:
    """A router over live-mutable capacity banks keyed by
    ``(n_bucket, PrecisionPolicy)``, following a :class:`FleetPlan`
    (DESIGN.md Sec. 12).

        plan = api.plan_fleet({64: 2, 32: 3}, grid, k=8)
        fleet = api.SolverFleet(grid, plan)
        h = fleet.admit(L, tenant="modelA", tag="layer0")
        server = api.SolveServer(fleet, panel_k=8)
        server.submit(b, tenant="modelA", tag="layer0")
        outs = server.drain()        # {(tenant, tag): [X (d, j), ...]}

    Admission pads the factor to its planned bucket order inside the
    bank's updater; a full bucket reclaims its coldest slot (one
    fleet-wide LRU clock, cross-tenant) through evict + admit on the
    same churn path — no program built, nothing moved from the host,
    generation counters catching every stale claim.
    """

    # the p > 1 AsyncSolveServer leading this fleet (core.stream)
    _relay = None

    def __init__(self, grid: TrsmGrid, plan: FleetPlan, *, cache=None,
                 lower: bool = True, transpose: bool = False,
                 map_mode: str = "vmap", warm: bool = False):
        from repro_torch.core import session as sessionlib
        self.grid = grid
        self.plan = plan
        self.cache = cache if cache is not None \
            else sessionlib.default_cache()
        self._buckets: dict[tuple, _Bucket] = {}
        for bp in plan.buckets:
            self._buckets[bp.key] = self._new_bucket(bp, lower, transpose,
                                                     map_mode)
        self._dir: dict[str, list[FleetHandle]] = {}   # tenant index
        self._clock = 0
        # the clock and the LRU stamps move under this lock: a submit's
        # lookup never ticks between a streamed mutation's bookkeeping
        # and its reclaim decision
        self._lock = threading.RLock()
        self._touched: dict = {}    # (bucket, slot) -> stamp, to stream
        self.admits = 0
        self.reclaims = 0
        self.lookup_hits = 0
        self.lookup_misses = 0
        if warm:
            self.warmup(plan.k)

    def _new_bucket(self, bp: BucketPlan, lower: bool, transpose: bool,
                    map_mode: str) -> _Bucket:
        bank = FactorBank(
            self.grid, bp.n, method=bp.method, n0=bp.n0, lower=lower,
            transpose=transpose, precision=bp.policy, map_mode=map_mode,
            capacity=bp.capacity, structure=bp.structure,
            overlap=bp.overlap, cache=self.cache)
        # the bank finds the server leading this fleet through it
        bank._fleet = (weakref.ref(self), bp.key)
        return _Bucket(bp, bank, Solver.from_bank(bank))

    # ------------------------------ routing ------------------------------

    @property
    def buckets(self) -> tuple:
        """The bucket keys, ``(n_bucket, policy)`` each."""
        return tuple(self._buckets)

    def bucket(self, key) -> _Bucket:
        return self._buckets[key]

    def solver(self, key) -> Solver:
        """The width-C :class:`Solver` over one bucket's bank."""
        return self._buckets[key].solver

    def warmup(self, k: int | None = None) -> "SolverFleet":
        for b in self._buckets.values():
            b.solver.warmup(self.plan.k if k is None else k)
        return self

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch(self, handle: FleetHandle) -> None:
        self._buckets[handle.bucket].last_used[handle.slot] = self._tick()

    def _check_current(self, handle: FleetHandle) -> _Bucket:
        b = self._buckets.get(handle.bucket)
        if b is None:
            raise KeyError(f"unknown bucket {handle.bucket}")
        cur = b.handles.get(handle.slot)
        if cur is not handle or \
                b.bank.slot_generation(handle.slot) != handle.generation:
            raise KeyError(
                f"stale handle: bucket {handle.bucket[0]} slot "
                f"{handle.slot} was reclaimed (generation "
                f"{b.bank.slot_generation(handle.slot)} != "
                f"{handle.generation}) — re-admit the factor")
        return b

    def _drop(self, b: _Bucket, handle: FleetHandle) -> None:
        """Forget ``handle``'s slot and free it in the bank (its
        generation bumps)."""
        b.handles.pop(handle.slot)
        b.last_used.pop(handle.slot, None)
        b.factors.pop(handle.slot, None)
        self._dir[handle.tenant].remove(handle)
        b.bank.evict(handle.slot)

    def _reclaim(self, b: _Bucket) -> int:
        """Evict the least-recently-used live slot in the bucket,
        whichever tenant holds it (the cross-tenant LRU contract).  Host
        bookkeeping and a device fill only; the freed slot's next admit
        overwrites the lane through the updater."""
        slot = min(b.bank.live_slots(),
                   key=lambda s: b.last_used.get(s, 0))
        self._drop(b, b.handles[slot])
        b.reclaims += 1
        self.reclaims += 1
        return slot

    def _admit_into(self, b: _Bucket, L, *, tenant: str,
                    tag: object, order: int) -> FleetHandle:
        """The admit core, targeted at one (possibly not-yet-routed)
        bucket: reclaim-if-full, padded bank admit, handle and directory
        bookkeeping.  :meth:`admit` routes through the plan;
        :meth:`apply_plan` targets migration destinations directly."""
        if b.bank.size == b.bank.capacity:
            self._reclaim(b)
        slot = b.bank.admit(L, pad_to=b.plan.n if order < b.plan.n
                            else None)
        handle = FleetHandle(bucket=b.plan.key, slot=slot,
                             generation=b.bank.slot_generation(slot),
                             tenant=tenant, tag=tag, order=order)
        b.handles[slot] = handle
        b.factors[slot] = L
        b.admits += 1
        self.admits += 1
        self._dir.setdefault(tenant, []).append(handle)
        # touch the TARGET bucket directly: during apply_plan it may
        # not be routed in self._buckets yet
        b.last_used[slot] = self._tick()
        return handle

    def _check_admit(self, L, **_) -> _Bucket:
        """The bucket ``L``'s order routes to, which must take it: every
        check before a full bucket reclaims a slot."""
        order = int(L.shape[-1])
        b = self._buckets[self.plan.bucket_for(order).key]
        b.bank.check_factor(L, pad_to=b.plan.n if order < b.plan.n
                            else None)
        return b

    @stream.mutation(check="_check_admit", lock="_lock")
    def admit(self, L, *, tenant: str = "default",
              tag: object = None) -> FleetHandle:
        """Route one natural-layout (d, d) factor to its planned
        bucket, zero-padding to the bucket order inside the updater.  A
        full bucket first reclaims its coldest slot (cross-tenant LRU).
        Returns the tenant's :class:`FleetHandle`."""
        return self._admit_into(self._check_admit(L), L, tenant=tenant,
                                tag=tag, order=int(L.shape[-1]))

    def _check_replace(self, handle: FleetHandle, L) -> _Bucket:
        b = self._check_current(handle)
        d = int(L.shape[-1])
        if d != handle.order:
            raise ValueError(f"replacement order {d} != admitted order "
                             f"{handle.order}; evict and re-admit to "
                             f"change order")
        b.bank.check_factor(L, pad_to=b.plan.n if d < b.plan.n else None)
        return b

    @stream.mutation(check="_check_replace", lock="_lock")
    def replace(self, handle: FleetHandle, L) -> FleetHandle:
        """Refresh the handle's slot in place (same order, same
        bucket) through the bank's updater.  Raises ``KeyError`` on a
        stale handle (slot reclaimed since)."""
        b = self._check_replace(handle, L)
        b.bank.replace(handle.slot, L, pad_to=b.plan.n
                       if handle.order < b.plan.n else None)
        b.factors[handle.slot] = L
        self._touch(handle)
        return handle

    @stream.mutation(check="_check_current", lock="_lock")
    def evict(self, handle: FleetHandle) -> None:
        """Explicitly release the handle's slot back to its bucket."""
        self._drop(self._check_current(handle), handle)

    def lookup(self, tenant: str, *, order: int | None = None,
               tag: object = None) -> FleetHandle:
        """Find a tenant's handle by ``(tenant, order)`` and/or tag.
        Ambiguous lookups (several live handles match) raise with the
        candidate tags; misses raise ``KeyError`` and count toward the
        fleet hit rate."""
        with self._lock:
            matches = [h for h in self._dir.get(tenant, ())
                       if (order is None or h.order == order)
                       and (tag is None or h.tag == tag)]
            if not matches:
                self.lookup_misses += 1
                raise KeyError(
                    f"no live factor for tenant {tenant!r}"
                    + (f" at order {order}" if order is not None else "")
                    + (f" tag {tag!r}" if tag is not None else "")
                    + " (evicted by a cross-tenant reclaim? re-admit)")
            if len(matches) > 1:
                raise ValueError(
                    f"ambiguous lookup for tenant {tenant!r}: "
                    f"{len(matches)} live factors match; disambiguate "
                    f"with tag= (candidates: {[h.tag for h in matches]})")
            h = matches[0]
            self.lookup_hits += 1
            self._touch(h)
            if self._relay is not None:      # the leader streams it
                self._touched[(h.bucket, h.slot)] = self._clock
            return h

    def _sync_out(self) -> dict:
        """The LRU bookkeeping a leader streams with each message: the
        clock, the lookup counts and every (bucket, slot) stamp a lookup
        set since the last message."""
        with self._lock:
            touched, self._touched = self._touched, {}
            return dict(clock=self._clock, hits=self.lookup_hits,
                        misses=self.lookup_misses,
                        touched=list(touched.items()))

    def _sync_in(self, sync: dict) -> None:
        """A follower applies the leader's bookkeeping
        (:meth:`_sync_out`) before the message it came with."""
        with self._lock:
            self._clock = sync["clock"]
            self.lookup_hits = sync["hits"]
            self.lookup_misses = sync["misses"]
            for (bucket, slot), stamp in sync["touched"]:
                b = self._buckets.get(bucket)
                if b is not None and slot in b.handles:
                    b.last_used[slot] = stamp

    def state(self) -> dict:
        """Every input of the fleet's decisions, comparable across
        ranks: the LRU clock, the counters and, per bucket, its handles,
        every slot's generation, the LRU stamps, the live slots, admits
        and reclaims."""
        with self._lock:
            return dict(
                clock=self._clock, admits=self.admits,
                reclaims=self.reclaims, lookup_hits=self.lookup_hits,
                lookup_misses=self.lookup_misses,
                buckets={f"{k[0]}/{k[1].name}": dict(
                    handles={s: (h.tenant, h.tag, h.order, h.generation)
                             for s, h in sorted(b.handles.items())},
                    generations=[b.bank.slot_generation(s)
                                 for s in range(b.bank.width)],
                    last_used=dict(sorted(b.last_used.items())),
                    live=list(b.bank.live_slots()), admits=b.admits,
                    reclaims=b.reclaims)
                    for k, b in self._buckets.items()})

    def handles(self, tenant: str | None = None) -> tuple:
        """All live handles (optionally one tenant's), admission order."""
        if tenant is not None:
            return tuple(self._dir.get(tenant, ()))
        return tuple(h for hs in self._dir.values() for h in hs)

    def manifest(self) -> dict[int, int]:
        """The LIVE mixed-order manifest, ``{order: count}`` over every
        resident handle — the input :func:`plan_fleet` takes, so a
        replan prices the population actually being served."""
        man: dict[int, int] = {}
        for h in self.handles():
            man[h.order] = man.get(h.order, 0) + 1
        return man

    def _check_plan(self, new_plan: FleetPlan, **_) -> None:
        for d in self.manifest():
            new_plan.bucket_for(d)       # raises if any order unroutable

    @stream.mutation(check="_check_plan", lock="_lock", local=("on_move",))
    def apply_plan(self, new_plan: FleetPlan, *,
                   on_move=None) -> dict:
        """Live-migrate the fleet onto ``new_plan``.

        Buckets are REBUILT only where the plan demands it: a bucket
        key that survives with sufficient capacity keeps its bank (same
        programs, no build for its residents), while new keys (a split)
        and under-capacity keys (a merge growing a bucket's population:
        capacity is the programs' width, so it cannot grow in place) get
        fresh banks.  Every handle whose order now routes to another
        bank is re-admitted from its retained natural factor through
        the standard admit path (phase 1 runs once per moved factor,
        on B5 where it is padded) and its old slot is evicted —
        generation counters bump, so a stale claim on the old slot
        stays detectable.  ``on_move(old_handle, new_handle)`` fires
        per migrated handle (on the leader alone where a p > 1 server
        streams the plan); LRU clocks carry over.  Returns
        ``dict(moved=[(old, new), ...], opened=[...], closed=[...],
        rebuilt=[...])``."""
        self._check_plan(new_plan)
        targets: dict[tuple, _Bucket] = {}
        opened, rebuilt = [], []
        for bp in new_plan.buckets:
            old = self._buckets.get(bp.key)
            if old is not None and old.bank.capacity >= bp.capacity:
                old.plan = bp            # keep the bank (and its key)
                targets[bp.key] = old
            else:
                like = old.bank if old is not None else None
                targets[bp.key] = self._new_bucket(
                    bp, like.lower if like else True,
                    like.transpose if like else False,
                    like.map_mode if like else "vmap")
                (rebuilt if old is not None else opened).append(bp.key)
        moved = []
        for h in list(self.handles()):
            src = self._buckets[h.bucket]
            dest = targets.get(new_plan.bucket_for(h.order).key)
            if dest is src:
                continue                 # bucket survives: no move
            L = src.factors[h.slot]
            clock = src.last_used.get(h.slot, 0)
            new_h = self._admit_into(dest, L, tenant=h.tenant,
                                     tag=h.tag, order=h.order)
            dest.last_used[new_h.slot] = clock   # LRU order carries
            self._drop(src, h)           # bumps the old generation
            moved.append((h, new_h))
            if on_move is not None:
                on_move(h, new_h)
        closed = [key for key in self._buckets if key not in targets]
        self._buckets = targets
        self.plan = new_plan
        return dict(moved=moved, opened=opened, closed=closed,
                    rebuilt=rebuilt)

    def place_factor(self, L, order: int | None = None):
        """Put a factor on the device of its ROUTED bucket's bank (the
        ingestion copy, paid up front) so the admit or replace itself
        moves no host data — :meth:`FactorBank.place_factor` routed by
        order."""
        d = int(L.shape[-1]) if order is None else order
        return self._buckets[self.plan.bucket_for(d).key] \
            .bank.place_factor(L)

    # ------------------------------ stats ------------------------------

    def stats(self) -> dict:
        """Fleet-wide serving stats: per-bucket occupancy and reclaim
        counts plus the global admit/reclaim/lookup counters."""
        lookups = self.lookup_hits + self.lookup_misses
        per_bucket = {}
        for key, b in self._buckets.items():
            per_bucket[key] = dict(
                n=b.plan.n, capacity=b.bank.capacity,
                occupancy=b.bank.size, orders=b.plan.orders,
                admits=b.admits, reclaims=b.reclaims)
        return dict(
            buckets=per_bucket, admits=self.admits,
            reclaims=self.reclaims, lookup_hits=self.lookup_hits,
            lookup_misses=self.lookup_misses,
            hit_rate=(self.lookup_hits / lookups) if lookups else 1.0)

    def format_stats(self) -> str:
        st = self.stats()
        rows = [f"{'bucket n':>9} {'cap':>4} {'occ':>4} {'admits':>7} "
                f"{'reclaims':>9}  orders"]
        for (n, pol), b in st["buckets"].items():
            rows.append(f"{n:>9} {b['capacity']:>4} {b['occupancy']:>4} "
                        f"{b['admits']:>7} {b['reclaims']:>9}  "
                        f"{list(b['orders'])}")
        rows.append(f"fleet: admits={st['admits']} "
                    f"reclaims={st['reclaims']} "
                    f"hit_rate={st['hit_rate']:.3f} "
                    f"(hits={st['lookup_hits']} "
                    f"misses={st['lookup_misses']})")
        return "\n".join(rows)
