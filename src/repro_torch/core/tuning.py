"""Parameter tuning (paper Sec. VIII).

Given (n, k, p) this module decides the processor-grid layout
(p1 x p1 x p2), the diagonal-block size n0, and the inversion subgrid
(r1, r2) — first from the paper's closed forms, then *snapped* to
feasible integers (powers of two, divisibility with the mesh and the
matrix), and finally refined by an argmin over the alpha-beta-gamma
model ("This cost analysis makes it possible to determine optimal block
sizes and processor grids a priori", Sec. I).

Every planner prices with :func:`default_machine` -- the NVIDIA H100
preset (``cost_model.h100``, nominal data-sheet constants), rescaled
by the port's calibration when its file exists -- unless the caller
passes ``machine=``.  The reference's calibration of its TPU constants
is never read.  A non-dense ``structure=`` prices the blocks the
structured sweep executes (DESIGN.md Sec. 14).
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core import cost_model as cm


# ------------------------- default machine -------------------------

@functools.lru_cache(maxsize=1)
def calibration() -> cm.Calibration | None:
    """The port's calibration (``cost_model.CALIBRATION_PATH``), or None
    when absent.  Cached for the process lifetime: planners consult it
    on every decision."""
    return cm.load_calibration()


@functools.lru_cache(maxsize=1)
def default_machine() -> cm.Machine:
    """The machine every planner prices with when the caller passes
    none: the H100 preset (``cost_model.h100``), rescaled by
    :func:`calibration` when the port's file exists (its launch term
    kept).  An explicit ``machine=`` argument anywhere in this module
    takes its place."""
    m = cm.h100()
    cal = calibration()
    return cal.apply(m) if cal is not None else m


def default_dispatch_s(fallback: float) -> float:
    """Per-program dispatch overhead in the units of the planners'
    steady costs: the calibration's measured ``dispatch_s`` when one is
    loaded, else ``fallback`` (the fleet planner's nominal constant, not
    a time measured on the card)."""
    cal = calibration()
    if cal is not None and cal.dispatch_s is not None:
        return cal.dispatch_s
    return fallback


def steps_s(machine: cm.Machine, n: int, n0: int) -> float:
    """The machine's launch time for the n/n0 dependent steps of a
    solve (It-Inv sweep steps or Rec-TRSM base cases); 0 for a machine
    without a launch term, so such a machine plans as the reference."""
    return machine.launch * n / n0


def _sweep_steps_s(machine: cm.Machine, n: int, n0: int,
                   structure=None) -> float:
    """:func:`steps_s` for the It-Inv sweep as it executes: the n/n0
    solve steps of a dense sweep, or for a structure every solve step
    and every update the level schedule keeps (m + update_cols)."""
    if structure is None or structure.is_dense:
        return steps_s(machine, n, n0)
    from repro_torch.core.structure import block_counts
    m, _, update_cols = block_counts(structure, n, n0)
    return machine.launch * (m + update_cols)


def _rec_steps_s(machine: cm.Machine, n: int, k: int, p1: int,
                 p2: int) -> float:
    """:func:`steps_s` for Rec-TRSM at the paper's base-case size."""
    if not machine.launch:
        return 0.0
    from repro_torch.core.rec_trsm import default_n0
    return steps_s(machine, n, default_n0(n, k, p1, p2))


@dataclasses.dataclass(frozen=True)
class TrsmPlan:
    """A resolved execution plan for one (n, k, p) solve problem.

    Fields:

    * ``regime`` — which of the paper's three asymptotic regimes the
      problem falls in (see :func:`regime`): ``"1d"`` (many RHS columns
      relative to n — parallelize over columns), ``"2d"`` (tall solves,
      k << n — the square processor grid), ``"3d"`` (the general case
      with a nontrivial replication axis).
    * ``p1, p2`` — processor grid factors: the mesh is p1 x p1 x p2
      (axes "x", "y", "z"); ``grid`` gives the tuple.
    * ``n0`` — diagonal-block size: the granularity of the paper's
      Diagonal-Inverter and of the sweep (one GEMM solve + one trailing
      update per n0-block).  Smaller n0 = more latency, less inversion
      flop overhead; the Sec. VIII sweet spot balances the two.
    * ``r1, r2`` — the inversion subgrid (Sec. VI-A): each diagonal
      block is inverted on an r1 x r1 x r2 subset of processors.
    * ``cost`` — the alpha-beta-gamma cost (S messages, W words,
      F flops) the model predicts for this plan.
    * ``n, k, p`` — the problem the plan was derived for.

    * ``method`` — which algorithm the plan is for: ``"inv"``
      (It-Inv-TRSM, what :func:`tune` costs) or ``"rec"`` (the
      recursive baseline; :func:`choose_method` stamps the winner).

    Plans are produced by :func:`tune` / :func:`tune_for_grid` /
    :func:`choose_method`; ``repro_torch.core.solver.SolveSpec.auto`` (and
    through it the compiled-solver cache) consumes a plan VERBATIM
    when the caller leaves method/n0 unset, so a plan is also the
    provenance record for "why did the solver pick this block size".
    """
    regime: str          # "1d" | "2d" | "3d"
    p1: int
    p2: int
    n0: int
    r1: int
    r2: int
    cost: cm.Cost
    n: int
    k: int
    p: int
    method: str = "inv"

    @property
    def grid(self):
        return (self.p1, self.p1, self.p2)


def regime(n: int, k: int, p: int) -> str:
    """Classify (n, k, p) into the paper's parameter regimes.

    ``"1d"`` (n < 4k/p): the RHS dominates — a 1 x 1 x p grid with
    columns distributed is optimal.  ``"2d"`` (n > 4k sqrt(p)): the
    factor dominates — sqrt(p) x sqrt(p) x 1.  ``"3d"`` otherwise:
    both matter, and the z-axis replication of the paper's 3D
    algorithms pays for itself.  The thresholds are the crossing
    points of the Sec. VIII closed-form costs."""
    if n < 4 * k / p:
        return "1d"
    if n > 4 * k * math.sqrt(p):
        return "2d"
    return "3d"


def ideal_params(n: int, k: int, p: int) -> dict:
    """The paper's closed-form optima (Sec. VIII tables), un-snapped."""
    r = regime(n, k, p)
    if r == "1d":
        return dict(regime=r, p1=1.0, p2=float(p), n0=float(n),
                    r1=p ** (1 / 3), r2=p ** (1 / 3))
    if r == "2d":
        n0 = (n * k ** 3 * math.sqrt(p)) ** 0.25
        rr = (k / n) ** 0.25 * p ** (3 / 8)
        return dict(regime=r, p1=math.sqrt(p), p2=1.0, n0=n0, r1=rr, r2=rr)
    p1 = (p * n / (4 * k)) ** (1 / 3)
    p2 = (math.sqrt(p) * 4 * k / n) ** (2 / 3)
    n0 = min(math.sqrt(n * k), float(n))
    rr = min(p * math.sqrt(n * k) / n, float(p)) ** (1 / 3)
    return dict(regime=r, p1=p1, p2=p2, n0=n0, r1=rr, r2=rr)


def _pow2_divisors(x: int) -> list[int]:
    out = [1]
    d = 2
    while x % d == 0:
        out.append(d)
        d *= 2
    return out


def _snap_pow2(x: float, lo: int = 1, hi: int | None = None) -> int:
    """Nearest power of two to x within [lo, hi]."""
    x = max(x, 1.0)
    c = 2 ** round(math.log2(x))
    c = max(c, lo)
    if hi is not None:
        c = min(c, hi)
    return int(c)


def feasible_grids(p: int) -> list[tuple[int, int]]:
    """All (p1, p2) with p1^2 * p2 == p, p1 and p2 powers of two."""
    out = []
    p1 = 1
    while p1 * p1 <= p:
        if p % (p1 * p1) == 0:
            p2 = p // (p1 * p1)
            # only power-of-two axes are mappable onto mesh factors
            if (p1 & (p1 - 1)) == 0 and (p2 & (p2 - 1)) == 0:
                out.append((p1, p2))
        p1 *= 2
    return out


def _feasible_n0(n: int, p1: int, p2: int) -> list[int]:
    """n0 must divide n and be a multiple of p1*p2 (cyclic layout needs
    p1 | n0 rows and p1*p2 | n0 cols for contiguous local blocks)."""
    base = max(p1 * p2, 1)
    out = []
    n0 = base
    while n0 <= n:
        if n % n0 == 0 and n0 % base == 0:
            out.append(n0)
        n0 *= 2
    if not out:
        out = [n]
    return out


def _inv_subgrid(n: int, n0: int, p: int) -> tuple[int, int]:
    """r1, r2 per Sec. VI-A: r1^2 r2 = p n0 / n, ideal ratio r2 = 4 r1.

    The subgrid is a processor ASSIGNMENT, so feasibility means
    r1^2 * r2 <= p.  Snapping each factor to its nearest power of two
    independently can overshoot (e.g. q = 6 snaps r2 from 3 up to 8,
    an 8-processor subgrid on a 6-processor machine); clamp each factor
    back down in power-of-two steps until the product fits."""
    q = max(1.0, min(float(p), p * n0 / n))
    r1 = _snap_pow2((q / 4.0) ** (1 / 3))
    while r1 > 1 and r1 * r1 > p:
        r1 //= 2
    r2 = _snap_pow2(max(1, int(q) // (r1 * r1)))
    while r2 > 1 and r1 * r1 * r2 > p:
        r2 //= 2
    return r1, r2


def tune(n: int, k: int, p: int,
         machine: cm.Machine | None = None) -> TrsmPlan:
    """Model-driven a-priori choice of (p1, p2, n0, r1, r2).

    Starts from the Sec. VIII closed forms, then argmins the full
    alpha-beta-gamma model over the feasible (power-of-two)
    neighborhood.  ``machine`` supplies the (alpha, beta, gamma)
    constants — latency, per-word, per-flop — defaulting to the H100
    preset (:func:`default_machine`); a high-alpha MPI-cluster
    machine shifts the argmin toward larger n0 / more replication,
    exactly the paper's Sec. IX sensitivity.  Precision does not enter
    the plan: a bf16 sweep changes gamma and beta by the same factor
    at leading order, leaving the argmin unchanged."""
    machine = machine or default_machine()
    grids = feasible_grids(p)
    if not grids:
        # p admits no power-of-two p1^2 * p2 == p factorization (e.g.
        # p = 6): plan for the largest power of two <= p — using fewer
        # processors is always a valid (and mappable) assignment
        grids = feasible_grids(2 ** int(math.log2(p)))
    best = None
    for p1, p2 in grids:
        for n0 in _feasible_n0(n, p1, p2):
            r1, r2 = _inv_subgrid(n, n0, p)
            c = cm.it_inv_trsm_cost(n, k, n0, p1, p2, r1, r2)
            t = c.time(machine) + steps_s(machine, n, n0)
            if best is None or t < best[0]:
                best = (t, TrsmPlan(regime(n, k, p), p1, p2, n0, r1, r2,
                                    c, n, k, p))
    return best[1]


def tune_for_grid(n: int, k: int, grid,
                  machine: cm.Machine | None = None) -> TrsmPlan:
    """Tune n0 (and the inversion subgrid) for an already-built mesh.

    Same argmin as :func:`tune` but with (p1, p2) pinned to the given
    TrsmGrid — this is what ``repro_torch.core.solver.resolve_plan`` calls
    when a solver is requested without an explicit n0, so it is the
    default-n0 policy of the whole serving stack."""
    machine = machine or default_machine()
    p1, p2 = grid.p1, grid.p2
    p = grid.p
    best = None
    for n0 in _feasible_n0(n, p1, p2):
        r1, r2 = _inv_subgrid(n, n0, p)
        c = cm.it_inv_trsm_cost(n, k, n0, p1, p2, r1, r2)
        t = c.time(machine) + steps_s(machine, n, n0)
        if best is None or t < best[0]:
            best = (t, TrsmPlan(regime(n, k, p), p1, p2, n0, r1, r2,
                                c, n, k, p))
    return best[1]


def serving_n0(n: int, grid, structure=None) -> int:
    """Diagonal-block size for the HOISTED steady state (factor banks,
    DESIGN.md Sec. 9).

    The Sec. VIII argmin balances sweep latency (fewer, larger blocks)
    against diagonal-inversion flops (more, smaller blocks).  A factor
    bank inverts the diagonal blocks ONCE at admission, so the
    inversion term leaves the per-solve cost entirely and the argmin
    degenerates monotonically toward the largest feasible block.  We
    stop at n0 <= n/2 (the largest feasible block that keeps m >= 2,
    i.e. keeps the substitution structure of the sweep) as the
    stability hedge: the Sec. V bound on inversion error grows with
    the inverted block's order, and m = 1 would be full triangular
    inversion — an explicit opt-in (n0 = n), not a preference.  The
    one exception: when the cyclic layout admits NO block smaller than
    n (n0 = n is the only feasible size, e.g. n = p1^2*p2), m = 1 is
    forced rather than chosen and is returned — there is no hedged
    alternative to decline to pick.  k does not enter: with inversion
    hoisted, every remaining cost term scales the same way in k.

    With a non-dense ``structure`` the monotone argument breaks: a
    larger block coarsens the mask, so the sweep skips less.  The
    structured path argmins the structure-priced steady cost (at a
    nominal k = 16) over the same hedged set, plus one alpha of
    dispatch per executed sweep step, as the reference does, plus the
    machine's launch per executed step (:func:`_sweep_steps_s`; 0 for
    a machine without one, which then plans as the reference).  Ties go
    to the larger block.  The machine is :func:`default_machine`, as
    the reference prices with its own default."""
    feas = _feasible_n0(n, grid.p1, grid.p2)
    capped = [n0 for n0 in feas if n0 <= n // 2]
    cands = capped if capped else [max(feas)]
    if structure is None or structure.is_dense:
        return max(cands)
    from repro_torch.core.structure import block_counts
    machine = default_machine()
    best = None
    for n0 in sorted(cands, reverse=True):   # ties -> larger block
        m, _, update_cols = block_counts(structure, n, n0)
        t = cm.it_inv_trsm_steady_cost(
            n, 16, n0, grid.p1, grid.p2, structure=structure,
            overlap=True).time(machine)
        t += machine.alpha * (m + update_cols)
        t += _sweep_steps_s(machine, n, n0, structure)
        if best is None or t < best[0]:
            best = (t, n0)
    return best[1]


def serving_steady_s(n: int, k: int, grid, *,
                     machine: cm.Machine | None = None,
                     n0: int | None = None, structure=None,
                     overlap: bool = True) -> float:
    """Modeled steady-state seconds for one order-n, width-k solve on
    the grid — the HOISTED It-Inv sweep, i.e. the serving
    configuration (DESIGN.md Secs. 9, 15).  The one spelling of this
    quantity: the fleet planner prices bucket merges with it and the
    admission controller seeds its queue-wait estimates with it, so
    both control decisions price the same model.  ``n0`` defaults to
    the hoisted-serving argmin; ``overlap`` (on by default, matching
    the serving tier's resolved ``SolveSpec.overlap``) prices the
    double-buffered sweep's ``max(comm, comp)`` pipeline (Sec. 16);
    ``structure`` prices the level-scheduled sweep's skipped blocks and
    its executed steps."""
    machine = machine or default_machine()
    n0 = n0 if n0 is not None else serving_n0(n, grid,
                                              structure=structure)
    return cm.it_inv_trsm_steady_cost(
        n, k, n0, grid.p1, grid.p2, structure=structure,
        overlap=overlap).time(machine) \
        + _sweep_steps_s(machine, n, n0, structure)


def tuning_table(n: int, k: int, p: int) -> dict:
    """Sec. VIII report: ideal closed forms vs snapped/argmin'd plan."""
    plan = tune(n, k, p)
    return dict(ideal=ideal_params(n, k, p),
                plan=dataclasses.asdict(plan))


def choose_method(n: int, k: int, p: int,
                  machine: cm.Machine | None = None):
    """Beyond-paper auto-dispatch: pick Rec-TRSM or It-Inv-TRSM from
    the alpha-beta-gamma model instantiated with the MACHINE constants.

    The paper's latency-for-bandwidth trade wins on high-alpha networks
    (MPI clusters, cross-pod DCN) and for latency-dominated shapes
    (k << n); on low-alpha ICI with n ~ k the recursive algorithm's
    lower bandwidth wins.  Returns (method, plan, modeled_times)."""
    machine = machine or default_machine()
    plan = tune(n, k, p, machine)
    t_inv = plan.cost.time(machine) + steps_s(machine, n, plan.n0)
    t_rec = cm.rec_trsm_cost(n, k, p).time(machine) \
        + _rec_steps_s(machine, n, k, plan.p1, plan.p2)
    method = "inv" if t_inv <= t_rec else "rec"
    plan = dataclasses.replace(plan, method=method)
    return method, plan, {"inv": t_inv, "rec": t_rec}


def choose_serving_method(n: int, k: int, grid,
                          machine: cm.Machine | None = None,
                          n0: int | None = None,
                          rec_model: str = "paper",
                          structure=None, overlap: bool = True):
    """Auto-dispatch for the HOISTED steady state (a resident factor:
    phase 1 — the Diagonal-Inverter — runs once at admission).

    :func:`choose_method` compares the FUSED It-Inv cost, inversion
    term included; for a serving solver that term leaves the per-solve
    cost entirely, so the fused comparison systematically under-credits
    "inv" (exactly the regime the hoisting optimization targets).
    This variant compares Rec-TRSM against the sweep-only steady cost
    at the serving block size, on the pinned grid.  Returns
    ``(method, n0, modeled_times)`` — n0 is the serving argmin (or the
    caller's, passed through).  ``rec_model="tang2024"`` prices the
    recursive side with the corrected bandwidth term
    (:func:`repro_torch.core.cost_model.rec_trsm_cost`) — the fleet
    planner's setting, so recursion is not over-credited.

    ``structure`` prices both sides from the declared block structure:
    the It-Inv side with the level-scheduled sweep's skipped blocks,
    the recursive side from the structure's fill
    (``cost_model.rec_trsm_cost``).

    ``overlap`` (default on, matching the serving tier's resolved
    ``SolveSpec.overlap``) prices the It-Inv sweep pipelined."""
    machine = machine or default_machine()
    n0 = n0 if n0 is not None else serving_n0(n, grid,
                                              structure=structure)
    t_inv = serving_steady_s(n, k, grid, machine=machine, n0=n0,
                             structure=structure, overlap=overlap)
    t_rec = cm.rec_trsm_cost(n, k, grid.p, model=rec_model,
                             structure=structure).time(machine) \
        + _rec_steps_s(machine, n, k, grid.p1, grid.p2)
    method = "inv" if t_inv <= t_rec else "rec"
    return method, n0, {"inv": t_inv, "rec": t_rec}
