"""Block-size choice for the hoisted steady state.

Only the dense ``serving_n0`` of the reference's tuner so far: with
phase 1 hoisted to admission the per-solve cost argmin is the largest
feasible block.  The cost model, ``SolveSpec.auto`` and
``method="auto"`` wait for the H100 cost model (ROADMAP A5, A8).
"""

from __future__ import annotations


def _pow2_divisors(x: int) -> list[int]:
    out = [1]
    d = 2
    while x % d == 0:
        out.append(d)
        d *= 2
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


def serving_n0(n: int, grid, structure=None) -> int:
    """Diagonal-block size for the HOISTED steady state (factor banks).

    A bank inverts the diagonal blocks ONCE at admission, so the
    inversion term leaves the per-solve cost and the argmin is the
    largest feasible block, capped at n/2 (keeps m >= 2, the
    substitution structure of the sweep) as the stability hedge; when
    n0 = n is the only feasible size it is returned.  Block structures
    other than dense wait for ROADMAP A9."""
    if structure is not None and not structure.is_dense:
        raise NotImplementedError("structured factors are ROADMAP A9")
    feas = _feasible_n0(n, grid.p1, grid.p2)
    capped = [n0 for n0 in feas if n0 <= n // 2]
    return max(capped if capped else [max(feas)])
