"""The solve stack: layouts, precision, It-Inv-TRSM and the recursive
TRSM, the cost model and planner, the factor bank, the compiled-program
cache and the serving front door.

    trsm(L, B, grid, method="inv"|"rec"|"auto", ...)   one-shot solve
    tri_inv.invert(L, grid)                   L^{-1} (paper Sec. V)
    mm3d.matmul(L, X, grid)                   Sec. III 3D product
    cholesky.cholesky(A, grid)                Cholesky via inversion
    cholesky.cholesky_cyclic / lu.lu_cyclic   factor producers emitting
                                              cyclic storage (bank feed)
    comm.trace()                              alpha-beta-gamma cost
                                              records of the collectives

``trsm``, ``tri_inv.invert`` and ``mm3d.matmul`` also run on a grid with
p > 1: one rank per process, in a ``torch.distributed`` world of p
(``make_trsm_mesh``), each returning its natural-layout result on every
rank; so do the front door's ``Solver`` (every constructor, every
precision preset) and ``FactorBank`` (append-only and capacity, padded
admission and cyclic ingestion), every rank making each call in the
same order.  Structures, fleets, the serving tiers and multi-rank
``cholesky`` and ``lu`` raise ``NotImplementedError`` there.
``python -m repro_torch.core.selfcheck`` runs them on gloo ranks.
"""


def trsm(L, B, grid, method: str = "inv", n0: int | None = None,
         machine=None, lower: bool = True, transpose: bool = False,
         mode: str | None = None, block_inv=None, precision=None):
    """Solve op(L) X = B on a TrsmGrid, one shot.

    method="inv":  It-Inv-TRSM (paper Secs. VI-VII): phase 1 (the
                   ``tri_inv_blocks`` kernel) and the sweep (``trmm``).
    method="rec":  the recursive baseline (paper Sec. IV), its base
                   cases on the ``trsm_substitution`` kernel.
    method="auto": pick by the alpha-beta-gamma model on ``machine``
                   (default the H100 preset, ``tuning.default_machine``).
    lower/transpose: upper-triangular and transposed solves reduce to
    the lower case by the reversal identity (DESIGN.md Sec. 3), folded
    into the admission gather.  n0 defaults to the Sec. VIII tuned
    block size ("inv") or the Sec. IV-A base-case size ("rec").
    precision: a preset name or a PrecisionPolicy; defaults to the
    uniform policy at L's dtype.

    The program (B gather -> solve -> X gather [-> refinement passes])
    comes from the process-wide CompiledSolverCache, so repeated
    same-shape calls build nothing.  For repeated solves against a
    fixed factor use ``Solver.from_factor``, which keeps the factor
    (and for "inv" its inverted blocks) resident."""
    import torch

    from repro_torch.core import precision as preclib
    from repro_torch.core import solver as solverlib
    L = torch.as_tensor(L)
    n, k = B.shape
    method, n0 = solverlib.resolve_plan(grid, n, k, method=method, n0=n0,
                                        machine=machine)
    spec = solverlib.SolveSpec(n=n, k=k, grid=grid,
                               policy=preclib.resolve(precision, L.dtype),
                               method=method, n0=n0, mode=mode,
                               lower=lower, transpose=transpose,
                               block_inv=block_inv)
    prog = solverlib.solver_for(spec)
    return prog.solve(prog.prep(L), B)


from repro_torch.core import (  # noqa: E402,F401
    cholesky, comm, lu, mm3d, tri_inv)
