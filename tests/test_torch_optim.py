"""The port's optimizers (``repro_torch.optim``: AdamW, the schedules,
KFAC-CA) and the K-FAC -> bank -> solve path against the JAX package's,
on the CPU.

Both sides step from the SAME state: each step's input params and
optimizer state come from the reference's previous step through
``convert.tree_from_reference``, so every comparison is one step's.
The reference's updates run under ``jax.jit`` (its eager Denman-Beavers
retraces per call and takes minutes here).  Its banks are built with
``repro.kernels.ops.block_inv_kernel`` patched into ``repro.core.
FactorBank`` (and ``repro.core.fleet.FactorBank``), in this process
only: its default phase 1 fails on jax 0.9 (ROADMAP C).  Fleet parity
passes an explicit ``cost_model.tpu_v5e()`` and ``dispatch_s`` to both
planners, as tests/test_torch_fleet.py does.

Tolerances: AdamW, the EMAs and plain products 2e-5 (fp32, the port's
parity tolerance); a preconditioned update 1e-3 of its largest entry
(its damped factors, at damping 1e-3 of their mean eigenvalue, have
condition numbers up to ~1e3, which multiplies fp32's 6e-8 rounding
through 14 Denman-Beavers iterations or four solves); the schedules
1e-6; served solves 1e-4 against each other and every column within
the reference's residual bound (1e-4, tests/test_factor_bank.py).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
from repro import api as japi
from repro.core import cost_model as jcm
from repro.core import fleet as jfleet
from repro.kernels import ops as jops
from repro.optim import schedules as jschedules
from repro_torch import api, convert
from repro_torch.core import cost_model as cm
from repro_torch.core import session
from repro_torch.optim import schedules
from torch_parity import assert_close

# ``repro.optim`` rebinds ``adamw`` and ``kfac_ca`` to the factories, as
# the port's package does: the modules come through importlib
jadamw = importlib.import_module("repro.optim.adamw")
adamw = importlib.import_module("repro_torch.optim.adamw")
jkfac = importlib.import_module("repro.optim.kfac_ca")
kfac = importlib.import_module("repro_torch.optim.kfac_ca")
optim = importlib.import_module("repro_torch.optim")

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = repro.core.make_trsm_mesh(1, 1)
TOL = 2e-5
PRECOND_TOL = 1e-3
SOLVE_TOL = 1e-4
RELRES = 1e-4
DISPATCH_S = 5e-5


@pytest.fixture
def jref(monkeypatch):
    """The reference's banks and fleet buckets with the kernel phase 1
    hook (its default phase 1 fails on jax 0.9)."""
    for mod in (repro.core, jfleet):
        monkeypatch.setattr(mod, "FactorBank", functools.partial(
            mod.FactorBank, block_inv=jops.block_inv_kernel))


def _params(seed=3):
    """The reference tests' parameters: a 2D weight, a 2-unit stack and
    an ineligible norm."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "stack": rng.standard_normal((2, 16, 8)).astype(np.float32),
            "norm": np.ones((16,), np.float32)}


def _deep_params(seed=4):
    """A 3-deep tree of stacked units, a 2D head and norms."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"units": {"b0": {"attn": {"wq": f(2, 16, 16), "wk": f(2, 16, 8)},
                             "mlp": {"up": f(2, 16, 32)},
                             "ln": np.ones((2, 16), np.float32)}},
            "head": f(8, 16), "ln_f": np.ones((16,), np.float32)}


def _grads(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(np.float32), params)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(jopt, opt, params, steps, seed=10):
    """``steps`` updates on both sides from the same state; yields
    (reference (params, state, metrics), port (...), input params) per
    step, the port's each stepped from the reference's previous one."""
    update = jax.jit(jopt.update)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    for i in range(steps):
        g = _grads(params, seed + i)
        tp, ts = convert.tree_from_reference(_np(jp)), \
            convert.tree_from_reference(_np(js))
        out = opt.update(convert.tree_from_reference(g), ts, tp)
        jout = update(jax.tree.map(jnp.asarray, g), js, jp)
        yield _np(jout), out, _np(jp)
        jp, js = jout[0], jout[1]


def _assert_same_state(got, want, tol=TOL):
    got_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] \
        == [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert_close(g, w, tol)


def _assert_same_step(jout, out, p_in, param_tol):
    (jp, js, jm), (tp, ts, tm) = jout, out
    moves = jax.tree.map(lambda t, w, p: (t.numpy() - p, w - p, p),
                         tp, jp, p_in)
    for path, (got, want, p) in jax.tree_util.tree_leaves_with_path(
            moves, is_leaf=lambda t: isinstance(t, tuple)):
        # one step's move against its own scale; read through the fp32
        # params, it carries their rounding: 2 ulps of the largest
        np.testing.assert_allclose(
            got, want, rtol=param_tol, atol=param_tol * np.abs(want).max()
            + 2 * np.spacing(np.abs(p).max()),
            err_msg=jax.tree_util.keystr(path))
    _assert_same_state(ts, js)
    assert int(ts["step"]) == int(js["step"])
    assert_close(tm["grad_norm"], jm["grad_norm"], 1e-6)


# ------------------------------ AdamW ------------------------------

@pytest.mark.parametrize("which", ["float", "constant", "warmup_cosine"])
def test_adamw_matches_reference(which):
    lr = {"float": (1e-3, 1e-3),
          "constant": (schedules.constant(1e-3), jschedules.constant(1e-3)),
          "warmup_cosine": (schedules.warmup_cosine(1e-2, 2, 6),
                            jschedules.warmup_cosine(1e-2, 2, 6))}[which]
    opt = adamw.adamw(lr=lr[0], weight_decay=0.01)
    jopt = jadamw.adamw(lr=lr[1], weight_decay=0.01)
    for jout, out, p_in in _run(jopt, opt, _params(), steps=3):
        _assert_same_step(jout, out, p_in, TOL)
        assert_close(out[2]["lr"], jout[2]["lr"], 1e-6)


def test_schedules_match_reference():
    for fn, jfn in ((schedules.warmup_cosine(3e-3, 4, 20, 0.2),
                     jschedules.warmup_cosine(3e-3, 4, 20, 0.2)),
                    (schedules.constant(3e-3), jschedules.constant(3e-3))):
        for step in range(0, 24, 3):
            want = np.asarray(jfn(step))
            got = fn(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_get_and_global_norm():
    assert isinstance(optim.get("adamw"), adamw.Optimizer)
    assert isinstance(optim.get("kfac_ca", min_dim=8), adamw.Optimizer)
    with pytest.raises(ValueError):
        optim.get("sgd")
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": (np.ones(2, np.float32), ())}
    want = float(jadamw.global_norm(tree))
    got = float(adamw.global_norm(convert.tree_from_reference(tree)))
    assert abs(got - want) <= 1e-6 * want
    clipped, _ = adamw.clip_by_global_norm(
        convert.tree_from_reference(tree), 1.0)
    assert abs(float(adamw.global_norm(clipped)) - 1.0) < 1e-6


# ------------------------------ KFAC-CA ------------------------------

@pytest.mark.parametrize("mode", ["whiten", "two_sided", "inverse"])
def test_kfac_update_matches_reference(mode):
    opt, jopt = kfac.kfac_ca(min_dim=8, mode=mode), \
        jkfac.kfac_ca(min_dim=8, mode=mode)
    for jout, out, p_in in _run(jopt, opt, _params(), steps=2):
        _assert_same_step(jout, out, p_in, PRECOND_TOL)
        # the norm is ineligible: it takes the AdamW update
        assert out[1]["kron"]["norm"] == ()


def test_kfac_update_freq_and_deep_tree_match_reference():
    """A 3-deep tree, the EMAs refreshed every other step: steps 1 and 3
    leave them where they were, on the device's decision."""
    opt, jopt = kfac.kfac_ca(min_dim=8, mode="inverse", update_freq=2), \
        jkfac.kfac_ca(min_dim=8, mode="inverse", update_freq=2)
    params = _deep_params()
    kron = None
    for i, (jout, out, p_in) in enumerate(_run(jopt, opt, params, 3)):
        _assert_same_step(jout, out, p_in, PRECOND_TOL)
        A = out[1]["kron"]["units"]["b0"]["attn"]["wq"][0].numpy()
        if kron is not None:                    # the step's input EMA
            assert np.array_equal(A, kron) == (i % 2 == 0), i
        kron = jout[1]["kron"]["units"]["b0"]["attn"]["wq"][0]
    js, ts = jout[1], out[1]
    assert [n for n, _, _ in kfac._iter_kron_factors(ts)] \
        == [n for n, _, _ in jkfac._iter_kron_factors(js)]
    assert kfac._kron_order_counts(ts) == jkfac._kron_order_counts(js) \
        == {8: 3, 16: 9, 32: 2}


def test_tree_from_reference_carries_a_kfac_state():
    jopt = jkfac.kfac_ca(min_dim=8)
    js = _np(jopt.init(jax.tree.map(jnp.asarray, _params())))
    ts = convert.tree_from_reference(js)
    assert ts["kron"]["norm"] == () and isinstance(ts["kron"]["w"], tuple)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    _assert_same_state(ts, js, tol=0.0)


# -------------------- K-FAC -> banks -> served solves --------------------

def _states(seed=5, steps=2):
    """The reference's kfac states after each of ``steps`` updates (mode
    "inverse": the EMAs do not depend on the mode), as NumPy."""
    jopt = jkfac.kfac_ca(min_dim=8, mode="inverse")
    return [out[1] for out, _, _ in _run(
        jopt, kfac.kfac_ca(min_dim=8, mode="inverse"),
        _params(seed), steps)]


def _relres(M, x, b):
    """relres of x against the damped Cholesky factor of EMA M in
    fp64, the factor recomputed by the reference."""
    L = np.asarray(jkfac._damped_chol(jnp.asarray(M), 1e-3), np.float64)
    return np.linalg.norm(L @ x - b) / np.linalg.norm(b)


def _ema(state, name, side, unit):
    for nm, sd, M in jkfac._iter_kron_factors(state):
        if (nm, sd) == (name, side):
            return M if unit is None else M[unit]
    raise KeyError((name, side))


def _serve_both(jbanks, banks, d, seed):
    B = np.random.default_rng(seed).standard_normal(
        (banks[d].width, d, 4)).astype(np.float32)
    want = np.asarray(japi.Solver.from_bank(jbanks[d]).solve(
        jnp.asarray(B)))
    got = api.Solver.from_bank(banks[d]).solve(torch.as_tensor(B))
    assert_close(got, want, SOLVE_TOL)
    return got.double().numpy(), B


def test_kfac_banks_match_reference_and_refresh_in_place(jref):
    """factor_banks_from_state from the same state: equal manifests (the
    reference's tags, compared with ==), equal sizes, equal solves; a
    later state refreshes both in place with no program built and the
    stacked parameter's two slots in ONE dispatch."""
    s1, s2 = _states()
    jbanks, jman = jkfac.factor_banks_from_state(s1, grid=JGRID)
    banks, man = kfac.factor_banks_from_state(
        convert.tree_from_reference(s1), grid=CPU)
    assert man == jman
    assert {d: (b.size, b.capacity) for d, b in banks.items()} \
        == {d: (b.size, b.capacity) for d, b in jbanks.items()} \
        == {16: (3, 3), 8: (3, 3)}
    for d in banks:
        _serve_both(jbanks, banks, d, seed=d)

    solver = api.Solver.from_bank(banks[16]).warmup(4)
    key = solver.spec_for(4)
    builds = session.BUILD_COUNTS[key]
    before = {d: b.updates_dispatched for d, b in banks.items()}
    ts2 = convert.tree_from_reference(s2)
    assert kfac.refresh_banks(banks, man, ts2) is banks
    jkfac.refresh_banks(jbanks, jman, s2)
    assert session.BUILD_COUNTS[key] == builds
    for d, b in banks.items():
        assert b.updates_dispatched - before[d] == 2, d
        assert b.size == 3
        X, B = _serve_both(jbanks, banks, d, seed=10 + d)
        for i, (name, side, unit) in enumerate(man[d]):
            assert _relres(_ema(s2, name, side, unit), X[i], B[i]) \
                < RELRES, (d, i)
    # a second refresh builds nothing at all
    counts = dict(session.BUILD_COUNTS)
    kfac.refresh_banks(banks, man, ts2)
    assert dict(session.BUILD_COUNTS) == counts


def test_kfac_banks_capacity_modes():
    """tests/test_bank_update.py's capacity modes: "auto" sizes each
    bank to its factor count (compared with the reference's in
    ``test_kfac_banks_match_reference_and_refresh_in_place``), an int
    is uniform, None is append-only."""
    s1, = _states(steps=1)
    ts = convert.tree_from_reference(s1)
    for capacity, want in (("auto", {16: 3, 8: 3}), (4, {16: 4, 8: 4}),
                           (None, {16: None, 8: None})):
        kw = {} if capacity == "auto" else {"capacity": capacity}
        banks, _ = kfac.factor_banks_from_state(ts, grid=CPU, **kw)
        assert {d: b.capacity for d, b in banks.items()} == want
    banks[16].admit(torch.eye(16))                   # append-only grows
    with pytest.raises(ValueError, match="capacity-allocated"):
        banks[16].evict(0)
    auto, _ = kfac.factor_banks_from_state(ts, grid=CPU)
    auto[16].evict(0)                                # live-mutable
    # a stacked parameter whose slots are not one ascending run
    # replaces unit by unit: 2 + 1 dispatches instead of 1 + 1
    wide, man = kfac.factor_banks_from_state(ts, grid=CPU, capacity=4)
    before = wide[16].updates_dispatched
    kfac.refresh_banks(wide, man, ts)
    assert wide[16].updates_dispatched - before == 2
    man[16][0], man[16][1] = man[16][1], man[16][0]
    kfac.refresh_banks(wide, man, ts)
    assert wide[16].updates_dispatched - before == 5


def test_kfac_fleet_matches_reference_and_refreshes(jref):
    """The fleet path: the same plan (explicit TPU preset and dispatch),
    one handle per (param, side, unit), and a refresh through each
    handle's bucket; ``fleet=True`` plans on the port's own machine."""
    s1, s2 = _states(seed=7)
    ts1 = convert.tree_from_reference(s1)
    plan = kfac.fleet_plan_from_state(ts1, CPU, k=4, machine=cm.tpu_v5e(),
                                      dispatch_s=DISPATCH_S)
    jplan = jkfac.fleet_plan_from_state(s1, JGRID, k=4,
                                        machine=jcm.tpu_v5e(),
                                        dispatch_s=DISPATCH_S)
    assert [(b.n, b.orders, b.capacity, b.method, b.n0)
            for b in plan.buckets] == [(b.n, b.orders, b.capacity,
                                        b.method, b.n0)
                                       for b in jplan.buckets]
    fleet, handles = kfac.factor_banks_from_state(
        ts1, grid=CPU, fleet=api.SolverFleet(CPU, plan))
    jfl, jhandles = jkfac.factor_banks_from_state(
        s1, grid=JGRID, fleet=jfleet.SolverFleet(JGRID, jplan))
    assert list(handles) == list(jhandles) and len(handles) == 6
    assert [(h.bucket[0], h.slot, h.order) for h in handles.values()] \
        == [(h.bucket[0], h.slot, h.order) for h in jhandles.values()]

    assert kfac.refresh_banks(fleet, handles, convert.tree_from_reference(
        s2)) is fleet
    jkfac.refresh_banks(jfl, jhandles, s2)
    rng = np.random.default_rng(8)
    for (tag, h), jh in zip(handles.items(), jhandles.values()):
        solver, jsolver = fleet.solver(h.bucket), jfl.solver(jh.bucket)
        B = np.zeros((solver.width, h.bucket[0], 4), np.float32)
        B[h.slot, :h.order] = rng.standard_normal((h.order, 4))
        X = solver.solve(torch.as_tensor(B)).double().numpy()
        assert_close(X, np.asarray(jsolver.solve(jnp.asarray(B))),
                     SOLVE_TOL)
        assert _relres(_ema(s2, *tag), X[h.slot][:h.order],
                       B[h.slot][:h.order]) < RELRES, tag
    own, own_handles = kfac.factor_banks_from_state(ts1, grid=CPU,
                                                    fleet=True)
    assert isinstance(own, api.SolverFleet) and len(own_handles) == 6
    with pytest.raises(TypeError, match="fleet"):
        kfac.factor_banks_from_state(ts1, grid=CPU, fleet="yes")
