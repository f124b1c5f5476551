"""KFAC-CA: Kronecker-factored preconditioning whose solves run through
the paper's inversion-based TRSM (the counterpart of
``repro.optim.kfac_ca``).

For every eligible 2D weight W (d_out x d_in) the state keeps the
Kronecker factor EMAs

    A = EMA[G G^T]      (d_out x d_out)
    B = EMA[G^T G]      (d_in  x d_in)

and the update preconditions G through Cholesky factors of their
damped forms and It-Inv-TRSM solves (multiplication by pre-inverted
diagonal blocks, ``core.blocked.it_inv_trsm_local``): by default the
inverse square root of the smaller side's factor (Denman-Beavers, two
SPD inversions an iteration).  The Cholesky is the selective-inversion
blocked factorization of ``core.cholesky``.  On the card every
diagonal-block inversion of both is the ``tri_inv_blocks`` kernel (B1).

Stacked parameters (scan units, MoE experts) carry their leading axis
through every step as a batch axis, where the reference maps them with
``vmap``.  Non-eligible tensors (norms, widths beyond max_dim, 1D) take
the AdamW update; the K-FAC update is grafted to its norm.  The step,
the refresh decision and the grafting scale stay on the device.

The per-layer factors also feed the serving stack:
:func:`factor_banks_from_state` banks every damped Cholesky factor by
order (or admits them into a :class:`~repro_torch.core.fleet.
SolverFleet`) and :func:`refresh_banks` re-factors them into their
slots in place.
"""

from __future__ import annotations

import torch

from repro_torch.core import blocked, cholesky, trace
from repro_torch.core import precision as preclib
from repro_torch.kernels.ops import block_inv_kernel
from repro_torch.optim.adamw import Optimizer, adamw, \
    clip_by_global_norm, global_norm
from repro_torch.optim.tree import leaves_with_path, tree_map


def _pow2_divisor(n: int, cap: int = 64) -> int:
    d = 1
    while n % (d * 2) == 0 and d * 2 <= cap:
        d *= 2
    return d


def _trsm_solver(L, Bm):
    """It-Inv-TRSM local solve; n0 = largest pow2 divisor (<= 64), the
    diagonal blocks inverted by the kernel hook."""
    n0 = _pow2_divisor(L.shape[-1])
    return blocked.it_inv_trsm_local(L, Bm, n0, block_inv=block_inv_kernel)


def _spd_solve(chol, X):
    return blocked.spd_solve(chol, X, _trsm_solver)


def _chol(A):
    bs = _pow2_divisor(A.shape[-1], cap=128)
    if bs >= 8:
        return cholesky.chol_blocked_local(A, bs)
    return cholesky.cholesky_nan(A)


def _eye_like(M):
    """The identity of M's order, repeated over M's leading axes."""
    d = M.shape[-1]
    return torch.eye(d, dtype=M.dtype, device=M.device).expand(
        M.shape).clone()


def _trace(M):
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]


def _spd_inv(M):
    """SPD inverse through the paper's machinery: blocked Cholesky
    (selective-inversion panels) + two triangular solves on I."""
    return _spd_solve(_chol(M), _eye_like(M))


def _inv_sqrt(A, iters: int = 14):
    """A^{-1/2} by Denman-Beavers:  Y <- (Y + Z^{-1})/2, Z <- (Z + Y^{-1})/2
    with Y -> A^{1/2}, Z -> A^{-1/2}; every iteration is two SPD
    inversions, two Cholesky factorizations and four It-Inv solves."""
    d = A.shape[-1]
    c = _trace(A) / d + 1e-30
    Y = A / c
    Z = _eye_like(A)
    for _ in range(iters):
        Yn = 0.5 * (Y + _spd_inv(Z))
        Z = 0.5 * (Z + _spd_inv(Y))
        Y = Yn
    return Z / torch.sqrt(c)


def _precondition(G, Aema, Bema, damping, mode="whiten"):
    """Precondition a (..., d_out, d_in) G through Cholesky + It-Inv
    solves.

    mode="whiten" (default): P = (A + lI)^{-1/2} G on the smaller side
    (Denman-Beavers).  mode="two_sided": P = A^{-1} G B^{-1} (4 solves,
    an ablation).  mode="inverse": one-sided (A + lI)^{-1} G."""
    do, di = G.shape[-2:]
    T = lambda X: X.transpose(-2, -1)  # noqa: E731
    if mode == "two_sided":
        lamA = damping * (_trace(Aema) / do + 1e-12)
        lamB = damping * (_trace(Bema) / di + 1e-12)
        cA = _chol(Aema + lamA * _eye_like(Aema))
        cB = _chol(Bema + lamB * _eye_like(Bema))
        P = _spd_solve(cA, G)             # A^{-1} G      (2 solves)
        return T(_spd_solve(cB, T(P)))    # ... B^{-1}    (2 solves)
    transpose = do > di
    Gw = T(G) if transpose else G
    A = Bema if transpose else Aema
    d = Gw.shape[-2]
    lam = damping * (_trace(A) / d + 1e-12)
    Ad = A + lam * _eye_like(A)
    if mode == "inverse":
        P = _spd_solve(_chol(Ad), Gw)
    else:
        P = _inv_sqrt(Ad) @ Gw            # (A + lI)^{-1/2} G
    return T(P) if transpose else P


def _damped_chol(M, damping: float):
    """``chol(M + lam I)`` of each (..., d, d) M with the
    preconditioner's trace-scaled damping: the factor the banks serve."""
    d = M.shape[-1]
    lam = damping * (_trace(M) / d + 1e-12)
    return _chol(M + lam * _eye_like(M))


def _iter_kron_factors(state):
    """Yield ``(name, side, M)`` for every Kronecker factor EMA in a
    kfac_ca state, ``name`` the parameter's path as the reference
    spells it: the one traversal order ``factor_banks_from_state``
    banks in and ``refresh_banks`` refreshes in."""
    for name, kron in leaves_with_path(
            state["kron"], is_leaf=lambda t: isinstance(t, tuple)):
        if not (isinstance(kron, tuple) and len(kron) == 2):
            continue
        for side, M in zip(("A", "B"), kron):
            yield name, side, M


def _kron_order_counts(state) -> dict:
    """{order d: number of Kronecker factors of that order}: the
    mixed-order manifest the fleet planner prices."""
    counts: dict[int, int] = {}
    for _, _, M in _iter_kron_factors(state):
        d = int(M.shape[-1])
        counts[d] = counts.get(d, 0) + \
            (1 if M.ndim == 2 else int(M.shape[0]))
    return counts


def fleet_plan_from_state(state, grid=None, *, k: int = 16,
                          precision=None, machine=None,
                          dispatch_s=None, headroom: int = 0):
    """Price a kfac_ca state's mixed-order factor manifest through the
    fleet capacity planner (:func:`repro_torch.core.fleet.plan_fleet`):
    cost-model arithmetic only, so the default grid is the plan-only
    1 x 1 x 1 grid."""
    from repro_torch.core import fleet as fleetlib
    from repro_torch.core.solver import plan_grid
    grid = grid if grid is not None else plan_grid(1, 1)
    kw = {} if dispatch_s is None else {"dispatch_s": dispatch_s}
    return fleetlib.plan_fleet(_kron_order_counts(state), grid, k=k,
                               precision=precision, machine=machine,
                               headroom=headroom, **kw)


def factor_banks_from_state(state, *, damping: float = 1e-3,
                            grid=None, precision=None,
                            method: str = "inv", n0: int | None = None,
                            map_mode: str = "vmap",
                            capacity="auto", fleet=None,
                            tenant: str = "kfac"):
    """Pool a kfac_ca state's per-layer DAMPED Cholesky factors
    (``chol(A + lam I)`` on the d_out side, ``chol(B + lam I)`` on the
    d_in side, the preconditioner's damping rule) into one
    :class:`~repro_torch.core.bank.FactorBank` per order, for batched
    serving (``Solver.from_bank(banks[d])``, one dispatch per wave
    across the layer group).  ``grid`` defaults to ``cuda:0``'s.

    Returns ``(banks, manifest)``: ``manifest[d][i]`` is the
    ``(param_path, side, unit)`` tag of the factor in slot i of
    ``banks[d]`` (side "A" = output side, "B" = input side; unit indexes
    a stacked parameter, None for a 2D one).

    ``capacity``: "auto" (default) allocates each bank at exactly its
    factor count, so every bank is live-mutable at the width an
    append-only banking would give; an int (uniform) or ``{d: C}``
    leaves churn headroom; None builds append-only banks.

    ``fleet``: a :class:`~repro_torch.core.fleet.SolverFleet`, or True
    for one built from :func:`fleet_plan_from_state`'s plan, admits
    every factor into its planned bucket under ``tenant`` with its tag;
    then the return is ``(fleet, {tag: FleetHandle})``."""
    from repro_torch.core.grid import make_trsm_mesh

    preclib.pin_matmul_numerics()
    grid = grid if grid is not None else make_trsm_mesh(1, 1)

    if fleet is not None and fleet is not False:
        from repro_torch.core.fleet import SolverFleet
        if fleet is True:
            fleet = SolverFleet(grid, fleet_plan_from_state(
                state, grid, precision=precision))
        elif not isinstance(fleet, SolverFleet):
            raise TypeError(f"fleet must be a SolverFleet or True, got "
                            f"{type(fleet).__name__}")
        fleet.kfac_damping = damping
        handles: dict = {}
        for name, side, M in _iter_kron_factors(state):
            cs = _damped_chol(M, damping)
            units = [None] if M.ndim == 2 else range(M.shape[0])
            for u in units:
                handles[(name, side, u)] = fleet.admit(
                    cs if u is None else cs[u], tenant=tenant,
                    tag=(name, side, u))
        return fleet, handles

    with trace.span("kfac.bank", sync=grid.device):
        return _bank_factors(state, grid, damping=damping,
                             precision=precision, method=method, n0=n0,
                             map_mode=map_mode, capacity=capacity)


def _bank_factors(state, grid, *, damping, precision, method, n0,
                  map_mode, capacity):
    """:func:`factor_banks_from_state` into one bank per order."""
    from repro_torch.core import bank as banklib

    counts = _kron_order_counts(state)

    def _cap(d):
        if capacity is None:
            return None
        if capacity == "auto":
            return counts[d]
        if isinstance(capacity, int):
            return capacity
        return capacity[d]

    banks: dict = {}
    manifest: dict[int, list] = {}
    for name, side, M in _iter_kron_factors(state):
        d = M.shape[-1]
        with trace.span("kfac.cholesky", sync=grid.device):
            L = _damped_chol(M, damping)
        if d not in banks:
            banks[d] = banklib.FactorBank(
                grid, d, method=method, n0=n0,
                dtype=None if precision is not None else L.dtype,
                precision=precision, map_mode=map_mode, capacity=_cap(d))
            # the banking-time damping, so refresh_banks re-factors the
            # factors the manifest describes
            banks[d].kfac_damping = damping
            manifest[d] = []
        if M.ndim == 2:
            banks[d].admit(L)
            manifest[d].append((name, side, None))
        else:                       # stacked units: one stacked admission
            banks[d].admit_stack(L)
            manifest[d].extend((name, side, u) for u in range(M.shape[0]))
    return banks, manifest


def refresh_banks(banks, manifest, state, *, damping: float | None = None):
    """Re-factor every banked factor from the CURRENT EMA state and
    replace it IN PLACE in the slot the manifest gave it: no rebank, no
    program built, occupancy and slots unchanged, so a server over the
    banks never notices.  A stacked parameter whose slots form a
    contiguous run of a capacity bank (the banking-time layout) goes in
    with ONE ``replace_run``; other layouts replace unit by unit.
    ``damping`` defaults to the value recorded on each bank at banking
    time.  Returns ``banks``.

    ``banks`` may be the :class:`~repro_torch.core.fleet.SolverFleet`
    of ``factor_banks_from_state(..., fleet=...)`` with its tag ->
    handle manifest: each factor then goes through ``fleet.replace``."""
    from repro_torch.core.fleet import SolverFleet
    preclib.pin_matmul_numerics()
    if isinstance(banks, SolverFleet):
        damp = damping if damping is not None else \
            getattr(banks, "kfac_damping", 1e-3)
        for name, side, M in _iter_kron_factors(state):
            units = [None] if M.ndim == 2 else range(M.shape[0])
            cs = _damped_chol(M, damp)
            for u in units:
                h = manifest.get((name, side, u))
                if h is not None:
                    banks.replace(h, cs if u is None else cs[u])
        return banks

    index = {d: {tag: i for i, tag in enumerate(tags)}
             for d, tags in manifest.items()}
    for name, side, M in _iter_kron_factors(state):
        d = M.shape[-1]
        slots = index.get(d, {})
        if not slots:
            continue
        damp = damping if damping is not None else \
            getattr(banks[d], "kfac_damping", 1e-3)
        if M.ndim == 2:
            slot = slots.get((name, side, None))
            if slot is not None:
                banks[d].replace(slot, _damped_chol(M, damp))
            continue
        run = [slots.get((name, side, u)) for u in range(M.shape[0])]
        cs = _damped_chol(M, damp)
        if None not in run and banks[d].capacity is not None \
                and run == list(range(run[0], run[0] + len(run))):
            banks[d].replace_run(run[0], cs)   # one chunked dispatch
        else:
            for u, slot in enumerate(run):
                if slot is not None:
                    banks[d].replace(slot, cs[u])
    return banks


def kfac_ca(lr=1e-3, ema=0.95, damping=1e-3, max_dim=8192, min_dim=8,
            clip_norm=1.0, update_freq: int = 1, mode: str = "whiten",
            **adam_kw):
    """Optimizer factory.  ``update_freq``: refresh the factor EMAs
    every k steps (stale preconditioner in between).  ``mode``:
    "whiten" (default, one-sided) | "two_sided" | "inverse" (ablations).
    fp32 GEMMs run in IEEE fp32 (TF32 off).  ``update(grads, state,
    params, gnorm=None)``: the preconditioned parameters (those with
    Kronecker factors) come whole, the others may be one rank's shards
    given the whole gradient's global norm ``gnorm`` (their update is
    adam's, elementwise)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    inner = adamw(lr=lr_fn, clip_norm=0.0, **adam_kw)

    def eligible(p):
        if p.ndim == 2:
            return (min_dim <= p.shape[0] <= max_dim
                    and min_dim <= p.shape[1] <= max_dim)
        if p.ndim == 3:     # stacked units / experts: batch over axis 0
            return (min_dim <= p.shape[1] <= max_dim
                    and min_dim <= p.shape[2] <= max_dim)
        return False

    def init(params):
        def fstate(p):
            if not eligible(p):
                return ()
            do, di = p.shape[-2:]
            lead = tuple(p.shape[:-2])
            return (torch.zeros(lead + (do, do), dtype=torch.float32,
                                device=p.device),
                    torch.zeros(lead + (di, di), dtype=torch.float32,
                                device=p.device))

        adam_state = inner.init(params)
        return {"adam": adam_state,
                "kron": tree_map(fstate, params),
                "step": torch.zeros_like(adam_state["step"])}

    def update(grads, state, params, gnorm=None):
        preclib.pin_matmul_numerics()
        step = state["step"] + 1
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, gnorm)
        elif gnorm is None:
            gnorm = global_norm(grads)
        # the adam pass is the grafting baseline for every tensor
        adam_params, adam_state, _ = inner.update(grads, state["adam"],
                                                  params, gnorm=gnorm)
        lr_t = lr_fn(step)
        do_refresh = (step % update_freq) == 0

        def upd(p, g, kron, a_new):
            if not kron:                # not preconditioned (init's rule)
                return a_new, kron
            gf = g.to(torch.float32)
            A, B = kron
            gT = gf.transpose(-2, -1)
            A2 = torch.where(do_refresh, ema * A + (1 - ema) * gf @ gT, A)
            B2 = torch.where(do_refresh, ema * B + (1 - ema) * gT @ gf, B)
            P = _precondition(gf, A2, B2, damping, mode)
            # graft to the adam update's magnitude
            adam_delta = (p - a_new).to(torch.float32)
            scale = torch.linalg.vector_norm(adam_delta) / torch.clamp(
                torch.linalg.vector_norm(lr_t * P), min=1e-12)
            newp = (p.to(torch.float32) - lr_t * P * scale).to(p.dtype)
            return newp, (A2, B2)

        is_kron = lambda t: isinstance(t, tuple)  # noqa: E731
        out = tree_map(upd, params, grads, state["kron"], adam_params,
                       is_leaf=is_kron)
        new_params = tree_map(lambda t: t[0], out, is_leaf=is_kron)
        new_kron = tree_map(lambda t: t[1], out, is_leaf=is_kron)
        new_state = {"adam": adam_state, "kron": new_kron, "step": step}
        return new_params, new_state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update, needs_whole=eligible)
