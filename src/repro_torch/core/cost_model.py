"""The paper's alpha-beta-gamma cost model (Secs. II, IV-VII).

The closed forms the planner prices, leading-order constants included
where the paper gives them.  ``Cost`` carries the
three critical-path counts:

    s : latency  — number of messages (collectives) on the critical path
    w : bandwidth — words sent/received on the critical path
    f : flops

``Machine`` instantiates the model with hardware constants.  The port
plans with :func:`h100` unless the caller passes a machine (Sec. VIII:
"the exact choice is machine dependent"); the TPU preset stays so that
plans can be compared with the reference's for the same machine.  The
reference's measured calibration is TPU data and is not ported.  Only
what the port's planners and its control plane price is here (the
admission controller's :func:`queue_wait_estimate` included), and the
Sec. III MM costs the distributed product is held to; the Sec. IX table
comes with the slice that uses it.  A
non-dense ``structure=`` (a
:class:`~repro_torch.core.structure.FactorStructure`) prices the blocks
the structured programs execute (DESIGN.md Sec. 14).
"""

from __future__ import annotations

import dataclasses
import math


def lg(x: float) -> float:
    return math.log2(max(x, 1.0))


def ind(p: float) -> float:
    """The paper's unit step 1_p  (1 if p > 1 else 0)."""
    return 1.0 if p > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class Cost:
    s: float = 0.0   # messages
    w: float = 0.0   # words
    f: float = 0.0   # flops

    def __add__(self, o: "Cost") -> "Cost":
        if not isinstance(o, Cost):      # PipelinedCost handles Cost +
            return NotImplemented        # PipelinedCost via __radd__
        return Cost(self.s + o.s, self.w + o.w, self.f + o.f)

    def __mul__(self, c: float) -> "Cost":
        return Cost(self.s * c, self.w * c, self.f * c)

    __rmul__ = __mul__

    def time(self, m: "Machine") -> float:
        return m.alpha * self.s + m.beta * self.w + m.gamma * self.f


@dataclasses.dataclass(frozen=True)
class PipelinedCost:
    """A sequence of pipelined stages, each a (comm, comp) pair of
    :class:`Cost` terms that execute CONCURRENTLY (DESIGN.md Sec. 16).

    The S/W/F *counts* are unchanged by overlap — the same messages,
    words and flops happen — so ``s``/``w``/``f`` sum both sides; only
    ``time`` changes: each stage prices ``max(comm.time, comp.time)``
    instead of their sum, which is the overlapped sweep's steady-state
    critical path (the panel collective of step i+1 rides under step
    i's GEMMs).  Stages are sequential with respect to each other, so
    ``__add__`` concatenates stage lists; adding a plain :class:`Cost`
    appends it as a serial stage (``max(0, c) == c``).
    """
    stages: tuple = ()        # tuple of (comm: Cost, comp: Cost) pairs

    @property
    def s(self) -> float:
        return sum(c.s + g.s for c, g in self.stages)

    @property
    def w(self) -> float:
        return sum(c.w + g.w for c, g in self.stages)

    @property
    def f(self) -> float:
        return sum(c.f + g.f for c, g in self.stages)

    def time(self, m: "Machine") -> float:
        return sum(max(c.time(m), g.time(m)) for c, g in self.stages)

    def serial(self) -> Cost:
        """Collapse to a plain (non-overlapped) :class:`Cost`."""
        return Cost(self.s, self.w, self.f)

    @staticmethod
    def _lift(o) -> tuple:
        if isinstance(o, PipelinedCost):
            return o.stages
        if isinstance(o, Cost):
            return ((Cost(), o),)
        return NotImplemented

    def __add__(self, o):
        stages = self._lift(o)
        if stages is NotImplemented:
            return NotImplemented
        return PipelinedCost(self.stages + stages)

    def __radd__(self, o):
        stages = self._lift(o)
        if stages is NotImplemented:
            return NotImplemented
        return PipelinedCost(stages + self.stages)

    def __mul__(self, c: float):
        return PipelinedCost(tuple((cm * c, cp * c)
                                   for cm, cp in self.stages))

    __rmul__ = __mul__


def pipelined(comm: Cost, comp: Cost) -> PipelinedCost:
    """One pipelined stage: ``comm`` and ``comp`` overlap, so the
    stage's machine time is ``max`` of the two instead of their sum
    (the counts still sum — overlap hides time, not traffic)."""
    return PipelinedCost(((comm, comp),))


@dataclasses.dataclass(frozen=True)
class Machine:
    """alpha [s/message], beta [s/word], gamma [s/flop], and launch
    [s per dependent kernel launch on one device].

    ``launch`` prices what the message count cannot see on one device:
    at p = 1 every collective is free (lg 1 = 0), yet each of an
    algorithm's dependent steps is a kernel launch.  The planner adds
    ``launch`` once per step (``tuning.steps_s``).  The reference has no
    such term, so the TPU preset keeps it 0 and prices as the
    reference does."""
    name: str
    alpha: float
    beta: float
    gamma: float
    launch: float = 0.0


def tpu_v5e(dtype_bytes: int = 2) -> Machine:
    """TPU v5e: 197 TFLOP/s bf16, ~50 GB/s/link ICI, ~1us collective hop."""
    return Machine(
        name="tpu_v5e",
        alpha=1e-6,
        beta=dtype_bytes / 50e9,
        gamma=1.0 / 197e12,
    )


def h100(dtype_bytes: int = 4) -> Machine:
    """NVIDIA H100 SXM, NOMINAL data-sheet constants, not measured on
    the card: gamma 1/67e12 s per flop (fp32 runs as IEEE FMAs on the
    CUDA cores, no TF32), beta one word over one direction of NVLink 4
    (450 GB/s), alpha and launch one nominal kernel launch (5 us)."""
    return Machine(
        name="h100",
        alpha=5e-6,
        beta=dtype_bytes / 450e9,
        gamma=1.0 / 67e12,
        launch=5e-6,
    )


# --------------------- collectives (Sec. II-C1) ---------------------

def allgather(n: float, p: float) -> Cost:
    return Cost(s=lg(p), w=n * ind(p))


def scatter(n: float, p: float) -> Cost:
    return Cost(s=lg(p), w=n * ind(p))


def gather(n: float, p: float) -> Cost:
    return Cost(s=lg(p), w=n * ind(p))


def reduce_scatter(n: float, p: float) -> Cost:
    return Cost(s=lg(p), w=n * ind(p), f=n * ind(p))


def alltoall(n: float, p: float) -> Cost:
    return Cost(s=lg(p), w=n * lg(p) / 2.0)


def reduction(n: float, p: float) -> Cost:
    return Cost(s=2 * lg(p), w=2 * n * ind(p), f=n * ind(p))


def allreduction(n: float, p: float) -> Cost:
    return Cost(s=2 * lg(p), w=2 * n * ind(p), f=n * ind(p))


def bcast(n: float, p: float) -> Cost:
    return Cost(s=2 * lg(p), w=2 * n * ind(p))


# --------------------- MM (Sec. III) ---------------------

def mm_cost_paper(n: float, k: float, p: float, p1: float,
                  p2: float) -> Cost:
    """3D matmul from a 2D cyclic start, line by line per the paper
    (Sec. III cost table), including the two rectangular-grid transposes
    (lines 3 and 8, O(nk log(p)/p) each) of its 4D-grid construction."""
    c = Cost()
    c = c + Cost(s=lg(p2), w=(n * n / (p1 * p1)) * ind(p2))       # line 2
    c = c + Cost(s=lg(p), w=n * k * lg(p) / p)                    # line 3
    c = c + Cost(s=1, w=n * k / p)                                # line 4
    c = c + Cost(s=lg(p1), w=n * k / (p1 * p2) * ind(p1))         # line 5
    c = c + Cost(f=n * n * k / p)                                 # line 6
    c = c + Cost(s=lg(p1), w=n * k / (p1 * p2) * ind(p1),
                 f=n * k / (p1 * p2) * ind(p1))                   # line 7
    c = c + Cost(s=lg(p), w=n * k * lg(p) / p)                    # line 8
    return c


def mm_cost(n: float, k: float, p: float, p1: float, p2: float,
            m: float | None = None) -> Cost:
    """Cost of the schedule ``core.mm3d`` runs: the mesh-native cyclic
    layout removes the paper's lines 3 and 8, and the x<->y exchange is
    one permute (line 4).  Leading order matches the paper:
    W = m n/p1^2 1_{p2} + 2 n k/(p1 p2), F = m n k/p, S = O(log p).
    ``m`` is the left operand's row count (default n, square)."""
    m = n if m is None else m
    c = Cost()
    c = c + Cost(s=lg(p2), w=(m * n / (p1 * p1)) * ind(p2))       # gather L
    c = c + Cost(s=ind(p1), w=n * k / p * ind(p1))                # permute
    c = c + Cost(s=lg(p1), w=n * k / (p1 * p2) * ind(p1))        # gather X
    c = c + Cost(f=m * n * k / p)                                 # GEMM
    c = c + Cost(s=lg(p1), w=m * k / (p1 * p2) * ind(p1),
                 f=m * k / (p1 * p2) * ind(p1))                   # red-scat
    return c


def w_mm_optimal(n: float, k: float, p: float) -> float:
    """Asymptotically optimal MM bandwidth (Demmel et al.), Sec. II-C2."""
    if n > k * math.sqrt(p):
        return n * k / math.sqrt(p)
    if n >= k / p:
        return (n * n * k / p) ** (2.0 / 3.0)
    return n * n


# --------------------- Recursive TRSM (Sec. IV) ---------------------

def rec_trsm_cost(n: float, k: float, p: float,
                  model: str = "paper", structure=None) -> Cost:
    """Closed-form leading-order cost of Rec-TRSM with the paper's
    parameter choices, by regime.

    ``model="tang2024"`` applies the bandwidth-cost correction of
    Tang, "A Reexamination of the Communication Bandwidth Cost
    Analysis of A Parallel Recursive Algorithm for Solving Triangular
    Systems of Linear Equations" (arXiv:2407.00871): in the recursive
    regimes the triangular operand is re-communicated across the
    lg(n/k)-deep recursion over n, so the paper's W under-counts by an
    n^2-order term — Θ(n^2/sqrt(p)) in the two-large-dimensions regime
    and the matching (n^2 k / p)^{2/3}-per-level term in the
    three-large-dimensions regime.  The 1D regime (no recursion over
    n) is unchanged.  Planner comparisons use the corrected figure so
    recursion is not over-credited against It-Inv serving
    (DESIGN.md Sec. 12).

    ``structure`` (a non-dense ``FactorStructure``) prices the
    structured recursion: admission masks the factor, so the
    L-proportional terms (the n^2-order words that move the factor and
    the trailing-MM flops) scale with the factor's block fill, diagonal
    blocks included.  The RHS-proportional nk words stay dense, and the
    message count is not scaled: the recursion and its base cases are
    structure-blind."""
    if model not in ("paper", "tang2024"):
        raise ValueError(f"unknown rec cost model {model!r}")
    fill = 1.0
    if structure is not None and not structure.is_dense:
        fill = _structure_fill_total(structure, n)
    corrected = model == "tang2024"
    if n < 4 * k / p:      # one large dimension
        return Cost(s=lg(p), w=n * n * fill, f=n * n * k / p * fill)
    if n > 4 * k * math.sqrt(p):   # two large dimensions
        w = n * k * lg(p) / math.sqrt(p)
        if corrected:
            w += n * n / math.sqrt(p) * fill
        return Cost(s=math.sqrt(p), w=w, f=n * n * k / p * fill)
    # three large dimensions
    w = (n * n * k / p) ** (2.0 / 3.0)
    if corrected:
        w *= max(lg(n / k), 1.0)   # one optimal-size term per level
    return Cost(s=(n * p / k) ** (2.0 / 3.0) * lg(p), w=w,
                f=n * n * k / p * fill)


def _structure_fill_total(structure, n: float) -> float:
    """Whole-factor block fill (diagonal included) of a structure at its
    natural granularity, from the admission analysis's nonzero counts;
    dense (1.0) when n cannot host that granularity."""
    from repro_torch.core.structure import block_counts
    n = int(n)
    if n < 2:
        return 1.0
    if structure.kind == "block_sparse":
        g = len(structure.mask)
        n0 = n // g if g and n % g == 0 else 0
    else:
        g = 64
        while g > 1 and n % g:
            g //= 2
        n0 = n // g
    if n0 < 1 or n % n0:
        return 1.0
    m, nnz_offdiag, _ = block_counts(structure, n, n0)
    total = m * (m + 1) / 2.0
    return (nnz_offdiag + m) / total if total else 1.0


# --------------------- Triangular inversion (Sec. V) ---------------------

NU = 2.0 ** (1.0 / 3.0) / (2.0 ** (1.0 / 3.0) - 1.0)   # 2^{1/3}/(2^{1/3}-1)


def tri_inv_cost(n: float, p1: float, p2: float) -> Cost:
    """RecTriInv total cost (Sec. V-B)."""
    p = p1 * p1 * p2
    return Cost(
        s=lg(p) ** 2,
        w=NU * (n * n / (8 * p1 * p1) + n * n / (2 * p1 * p2)),
        f=NU * n ** 3 / (8 * p),
    )


# --------------------- It-Inv-TRSM (Secs. VI-VII) ---------------------

def inv_phase_cost(n: float, n0: float, r1: float, r2: float,
                   p: float) -> Cost:
    """Diagonal-Inverter: n/n0 blocks inverted on r1 x r1 x r2 subgrids,
    plus the redistribution lines 6/9/16/17 (never leading order)."""
    per_block = tri_inv_cost(n0, r1, r2)
    # All n/n0 inversions run concurrently on disjoint subgrids: the
    # critical path is ONE block inversion; W/F below are per-processor.
    redist = Cost(s=4 * lg(p), w=2 * n * n0 / p * lg(p) + n * n0 / p)
    return Cost(s=per_block.s, w=per_block.w, f=per_block.f) + redist


def solve_phase_cost(n: float, k: float, n0: float,
                     p1: float, p2: float, overlap: bool = False):
    """n/n0 block solves:  X_i = L~_ii B_i  + allreduce over x (Sec. VII-B).

    ``overlap`` returns the PIPELINED form (DESIGN.md Sec. 16): the
    per-step collective words/messages and the per-step GEMM flops
    price ``max(comm, comp)`` instead of their sum.  The counts are
    identical either way — overlap hides time, not traffic."""
    m = n / n0
    p = p1 * p1 * p2
    w = m * ((n0 * n0 / (p1 * p1)) * ind(p2)
             + 4 * (n0 * k / (p1 * p2)) * ind(p1))
    comm = Cost(s=m * lg(p), w=w)
    comp = Cost(f=m * n0 * n0 * k / (p1 * p1 * p2))
    if overlap:
        return pipelined(comm, comp)
    return comm + comp


def update_phase_cost(n: float, k: float, n0: float,
                      p1: float, p2: float,
                      structure=None, overlap: bool = False):
    """Trailing updates: bcast of the L~ panel + GEMM + allreduce (VII-C).

    With a non-dense ``structure`` the sweep skips zero blocks: words
    and flops scale by the off-diagonal block fill (nnz_offdiag over
    the dense m(m-1)/2), and the latency term counts only the columns
    with at least one dependent block row (DESIGN.md Sec. 14).
    ``overlap`` returns the pipelined ``max(comm, comp)`` form — the
    double-buffered sweep starts panel i+1's allgather before panel
    i's update GEMM executes (Sec. 16)."""
    m = n / n0
    p = p1 * p1 * p2
    w = (m - 1) * (4 * (n * n0 - n) / (p1 * p1) * ind(p2)
                   + 4 * n0 * k / (p1 * p2) * ind(p1))
    s = (m - 1) * lg(p)
    f = (m - 1) * k * n * n0 / (p1 * p1 * p2)
    if structure is not None and not structure.is_dense:
        from repro_torch.core.structure import block_counts
        mi, nnz_offdiag, update_cols = block_counts(structure, int(n),
                                                    int(n0))
        dense_off = mi * (mi - 1) / 2.0
        fill = nnz_offdiag / dense_off if dense_off else 0.0
        cols = update_cols / (mi - 1.0) if mi > 1 else 0.0
        w, f, s = w * fill, f * fill, s * cols
    if overlap:
        return pipelined(Cost(s=s, w=w), Cost(f=f))
    return Cost(s=s, w=w, f=f)


def it_inv_trsm_cost(n: float, k: float, n0: float, p1: float, p2: float,
                     r1: float, r2: float, overlap: bool = False):
    p = p1 * p1 * p2
    return (inv_phase_cost(n, n0, r1, r2, p)
            + solve_phase_cost(n, k, n0, p1, p2, overlap=overlap)
            + update_phase_cost(n, k, n0, p1, p2, overlap=overlap))


def it_inv_trsm_steady_cost(n: float, k: float, n0: float,
                            p1: float, p2: float,
                            structure=None, overlap: bool = False):
    """Per-solve It-Inv cost in the HOISTED steady state (DESIGN.md
    Secs. 9-10): the Diagonal-Inverter ran once at factor admission, so
    a resident-factor solve pays only the sweep (solve + update
    phases).  ``structure`` prices the level-scheduled sweep: the solve
    phase is unchanged (every diagonal block is on its block row's
    critical path), the update phase pays only for nonzero blocks.
    ``overlap`` prices the double-buffered sweep's ``max(comm, comp)``
    per phase (a :class:`PipelinedCost` — same counts, smaller
    ``time``)."""
    return (solve_phase_cost(n, k, n0, p1, p2, overlap=overlap)
            + update_phase_cost(n, k, n0, p1, p2, structure=structure,
                                overlap=overlap))


# ------------------- control-plane wait pricing -------------------

def queue_wait_estimate(queued_cols: float, width: float,
                        inflight_waves: float, k: float,
                        steady_s: float,
                        dispatch_s: float = 0.0) -> float:
    """A priori queue-wait bound for one arriving request (DESIGN.md
    Sec. 15): seconds until a request of ``width`` columns joining a
    backlog of ``queued_cols`` columns completes, when each wave
    carries up to ``k`` columns and costs ``steady_s`` (the modeled —
    or measured-EWMA — per-wave service time) plus ``dispatch_s`` of
    launch overhead, with ``inflight_waves`` already dispatched ahead.

    The reference's formula: the admission controller admits or sheds
    a request on this arithmetic, before any queue time is spent.  The
    wave count is a CEILING (a request never splits across waves), so
    admission errs toward shedding work it could not serve in time
    rather than admitting work it cannot."""
    waves = math.ceil((queued_cols + width) / max(k, 1.0)) \
        + inflight_waves
    return waves * (steady_s + dispatch_s)
