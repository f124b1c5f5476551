"""The mixed-order fleet tier (DESIGN.md Sec. 12) and kernel B5 of the
port against the JAX package's, on the CPU.

The same numpy factors and right-hand sides go through ``repro`` and
``repro_torch``: the plain B5 against ``repro.kernels.ops.tri_inv_blocks
(valid=)`` (its Pallas kernel in interpret mode, as its own tests run
it), the padded updater's phase 1, the planner, and fleets driven by the
same admits, lookups, replaces, reclaims, migrations and fleet-mode
server traffic.  The reference's ``SolverFleet`` builds its banks with
``block_inv=None``, whose phase 1 fails on jax 0.9 (ROADMAP C); these
tests patch ``repro.core.fleet.FactorBank`` in this process only, to
pass ``block_inv=repro.kernels.ops.block_inv_kernel``.  Planner parity
passes an explicit ``cost_model.tpu_v5e()`` and ``dispatch_s`` to both
sides: the reference's default machine is calibrated, the port's is the
H100 preset.  Tolerances: B5 1e-6 (fp32) and 1e-12 (fp64) of the
inverse's scale (``torch_parity``), fleet outputs 2e-5 for fp32 and
bf16_refine (tests/test_kernels.py's fp32 tolerance, as the port's other
parity tests hold them), and every served request within the
reference's residual bound (1e-4, tests/test_fleet.py).
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import cost_model as jcm
from repro.core import fleet as jfleet
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.core import cost_model as cm
from repro_torch.core import session
from repro_torch.kernels import ops, ref, tri_inv_block
from torch_parity import assert_close, assert_inverse_close

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = japi.make_trsm_mesh(1, 1)
TOL = 2e-5
RELRES = 1e-4
VARIANTS = [(True, False), (True, True), (False, False), (False, True)]


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def jref(monkeypatch):
    """The reference's fleet with the kernel phase 1 hook in its banks
    (its default phase 1 fails on jax 0.9)."""
    monkeypatch.setattr(jfleet, "FactorBank", functools.partial(
        jfleet.FactorBank, block_inv=jops.block_inv_kernel))
    return jfleet


def _tri(d, seed=0, lower=True):
    rng = np.random.default_rng(seed)
    T = np.tril(rng.standard_normal((d, d))) + d * np.eye(d)
    return (T if lower else T.T).astype(np.float32)


def _rel(T, x, b):
    x = np.asarray(torch.as_tensor(x).double().numpy() if isinstance(
        x, torch.Tensor) else x, np.float64)
    return np.linalg.norm(T.astype(np.float64) @ x - b) / np.linalg.norm(b)


# ------------------------------ kernel B5 ------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_b5_plain_matches_reference_kernel_and_ignores_poison(x64, dtype,
                                                              tol):
    """The plain B5 against ``repro.kernels.ops.tri_inv_blocks(valid=)``
    at m = 4, n0 = 16: the valid blocks within ``tol`` of the inverse's
    scale, the flagged ones exact zeros on both sides; a flagged block
    zeroed and one NaN-poisoned change no bit; an all-ones mask is the
    plain B1 bit for bit; no launch is counted on the CPU."""
    rng = np.random.default_rng(15)
    m, n0 = 4, 16
    Ls = np.stack([np.tril(rng.standard_normal((n0, n0))) + n0 * np.eye(n0)
                   for _ in range(m)]).astype(dtype)
    v = np.asarray([1, 0, 1, 0], np.int32)
    Lp = Ls.copy()
    Lp[1] = 0
    Lp[3] = np.nan
    b1, b5 = (tri_inv_block.tri_inv_blocks.launches,
              tri_inv_block.tri_inv_blocks.valid_launches)
    got = ops.tri_inv_blocks(torch.as_tensor(Ls), valid=torch.as_tensor(v))
    pois = ops.tri_inv_blocks(torch.as_tensor(Lp), valid=torch.as_tensor(v))
    acc = jnp.float64 if dtype == np.float64 else jnp.float32
    want = np.asarray(jops.tri_inv_blocks(jnp.asarray(Ls), acc,
                                          valid=jnp.asarray(v)))
    jpois = np.asarray(jops.tri_inv_blocks(jnp.asarray(Lp), acc,
                                           valid=jnp.asarray(v)))
    assert (tri_inv_block.tri_inv_blocks.launches,
            tri_inv_block.tri_inv_blocks.valid_launches) == (b1, b5)
    assert got.dtype == torch.as_tensor(Ls).dtype
    for z in (0, 2):
        assert_inverse_close(got[z], want[z], tol)
    assert torch.equal(pois, got)
    np.testing.assert_array_equal(jpois, want)
    assert not got[1].any() and not got[3].any()
    assert not want[1].any() and not want[3].any()
    assert_inverse_close(got, ref.tri_inv_blocks_valid_ref(
        torch.as_tensor(Ls), torch.as_tensor(v)), tol)
    ones = ops.tri_inv_blocks(torch.as_tensor(Ls),
                              valid=torch.ones(m, dtype=torch.int32))
    assert torch.equal(ones, tri_inv_block.tri_inv_blocks_plain(
        torch.as_tensor(Ls)))
    # the hook passes the mask through
    assert torch.equal(ops.block_inv_kernel(torch.as_tensor(Ls),
                                            valid=torch.as_tensor(v)), got)


def test_b5_checks_its_mask():
    Ls = torch.eye(8).expand(3, 8, 8).contiguous()
    with pytest.raises(ValueError, match=r"valid must be \(3,\)"):
        ops.tri_inv_blocks(Ls, valid=torch.ones(2, dtype=torch.int32))
    # a block size B1 cannot take goes in padded, gated alike
    L6 = torch.as_tensor(np.stack([_tri(6, s) for s in range(3)]))
    v = torch.tensor([0, 1, 1], dtype=torch.int32)
    got = ops.block_inv_kernel(L6, valid=v)
    assert not got[0].any()
    assert_inverse_close(got[1:], ref.tri_inv_blocks_ref(L6[1:]), 1e-6)


# --------------------------- padded phase 1 ---------------------------

@pytest.mark.parametrize("precision", ["fp32", "bf16_refine"])
@pytest.mark.parametrize("lower,transpose", VARIANTS)
def test_padded_updater_runs_b5_and_keeps_b1s_dt(monkeypatch, precision,
                                                 lower, transpose):
    """d = 16 into n = 32 at n0 = 8: the padded updater inverts with a
    mask that flags the identity tail's blocks (the trailing two without
    the reversal, the leading two with it), and the slot's resident Dt
    equals the plain B1 on the whole padded, reduced stack; the leading
    block of a solve equals an unpadded width-1 bank's bit for bit, the
    tail is exact zeros, and the lane agrees with the reference's padded
    admission."""
    d, n, n0, k = 16, 32, 8, 4
    rev = lower == transpose
    want_mask = [1, 1, 0, 0] if not rev else [0, 0, 1, 1]
    assert session.pad_block_mask(n, d, n0, rev) == want_mask
    masks = []
    real = ops.tri_inv_blocks

    def spy(Ls, valid=None):
        masks.append(None if valid is None else valid.tolist())
        return real(Ls, valid)

    monkeypatch.setattr(ops, "tri_inv_blocks", spy)
    T = _tri(d, seed=d + 2 * lower + transpose, lower=lower)
    kw = dict(n0=n0, precision=precision, lower=lower, transpose=transpose,
              capacity=1)
    bank = api.FactorBank(CPU, n, **kw)
    assert bank.admit(T, pad_to=n) == 0
    assert masks == [want_mask]
    small = api.FactorBank(CPU, d, **kw)
    small.admit(T)
    assert masks[-1] is None
    L_lo, Dt = bank.stacks()[:2]
    from repro_torch.core import inv_trsm
    want = inv_trsm.invert_diag_blocks(
        L_lo, n0=n0, block_inv=tri_inv_block.tri_inv_blocks_plain,
        accum_dtype=bank.policy.accumulate)
    assert torch.equal(Dt, want)
    assert tri_inv_block.tri_inv_blocks.valid_launches == 0
    B = np.random.default_rng(3).standard_normal((d, k)).astype(np.float32)
    Bp = np.zeros((1, n, k), np.float32)
    Bp[0, :d] = B
    X = api.Solver.from_bank(bank).solve(torch.as_tensor(Bp))[0]
    Xs = api.Solver.from_bank(small).solve(torch.as_tensor(B[None]))[0]
    assert torch.equal(X[:d], Xs)
    assert not X[d:].any()
    jbank = japi.FactorBank(JGRID, n, block_inv=jops.block_inv_kernel,
                            **kw)
    jbank.admit(T, pad_to=n)
    jX = np.asarray(japi.Solver.from_bank(jbank).solve(jnp.asarray(Bp),
                                                       donate=False))[0]
    assert_close(X, jX, TOL)


def test_padded_admission_with_a_caller_hook_inverts_every_block():
    """A caller's own ``block_inv`` hook takes no mask: a padded bank
    that has one inverts every diagonal block (the identity tail's to
    the identity) and solves as the default kernel hook's bank does."""
    from repro_torch.core import blocked
    T = _tri(16, seed=7)
    banks = [api.FactorBank(CPU, 32, n0=8, capacity=2, block_inv=hook)
             for hook in (blocked.tri_inv_batched, None)]
    for bank in banks:
        bank.admit(T, pad_to=32)
    B = torch.zeros((2, 32, 4))
    B[0, :16] = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (16, 4)).astype(np.float32))
    X, Xd = (api.Solver.from_bank(b).solve(B) for b in banks)
    assert_close(X[0], Xd[0], TOL)
    assert not X[0, 16:].any()
    eye = torch.eye(8).expand(2, 8, 8)
    assert torch.equal(banks[0].stacks()[1][0, 2:], eye)


def test_fixed_order_is_a_capacity_banks_program():
    """A capacity bank keys its programs with fixed_order on the CPU,
    whatever its width (on the card only below FIXED_ORDER_WIDTH: the
    gpu tests); an append-only width-1 bank, the main path, keeps the
    library products.  The two agree within TOL, and the fixed-order
    products sum in one order whatever the shape."""
    from repro_torch.core import solver as solverlib
    T = _tri(32, seed=4)
    one = api.Solver.from_factor(T, CPU, n0=8, precision="bf16_refine")
    cap1 = api.Solver.from_spec(api.SolveSpec.auto(
        32, 4, grid=CPU, method="inv", n0=8, precision="bf16_refine",
        bank_width=1), capacity=1)
    cap2 = api.Solver.from_spec(api.SolveSpec.auto(
        32, 4, grid=CPU, method="inv", n0=8, precision="bf16_refine",
        bank_width=2), capacity=2)
    assert solverlib.FIXED_ORDER_WIDTH == 2
    assert [s.spec_for(4).fixed_order for s in (one, cap1, cap2)] \
        == [False, True, True]
    cap1.admit_factor(T)
    B = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (32, 4)).astype(np.float32))
    assert_close(cap1.solve(B[None])[0], one.solve(B), TOL)
    A = torch.randn(2, 24, 8, dtype=torch.float64).float()
    X = torch.randn(2, 8, 4, dtype=torch.float64).float()
    assert torch.equal(ops.gemm(A, X)[:, :8], ops.gemm(A[:, :8], X))
    assert torch.equal(ops.gemm(A, X, lower=True),
                       ops.gemm(torch.tril(A), X))
    assert_close(ops.gemm(A, X), A @ X, TOL)
    with pytest.raises(ValueError, match="banked"):
        api.SolveSpec(n=32, k=4, grid=CPU, policy=one.policy, n0=8,
                      fixed_order=True)


# ------------------------------ the planner ------------------------------

PLAN_CASES = [
    (dict(manifest={16384: 2, 8192: 4, 1024: 8, 512: 16, 256: 32, 128: 32},
          grid=(2, 2), k=16, headroom=1, dispatch_s=5e-5)),
    (dict(manifest=[512, 256, 128, 64], grid=(1, 1), k=8, dispatch_s=0.0)),
    (dict(manifest=[512, 256, 128, 64], grid=(1, 1), k=8, dispatch_s=1e9)),
    (dict(manifest=[64, 64, 64], grid=(1, 1), k=8, dispatch_s=5e-5)),
    (dict(manifest={8192: 4, 4096: 4, 2048: 4}, grid=(1, 1), k=16,
          dispatch_s=5e-5, precision="bf16_refine")),
    (dict(manifest={32: 2, 16: 2}, grid=(1, 1), k=4, dispatch_s=5e-5)),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_fleet_matches_reference(case):
    """Explicit machine and dispatch budget: the same buckets (order,
    member orders and counts, capacity, method, n0, policy) and modeled
    costs within 1e-12 relative; the routing map agrees on every member
    order and on an unplanned one."""
    case = dict(case)
    manifest, (p1, p2) = case.pop("manifest"), case.pop("grid")
    got = api.plan_fleet(manifest, api.plan_grid(p1, p2),
                         machine=cm.tpu_v5e(), **case)
    want = japi.plan_fleet(manifest, japi.plan_grid(p1, p2),
                           machine=jcm.tpu_v5e(), **case)
    assert (got.k, got.dispatch_s) == (want.k, want.dispatch_s)
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        assert (g.n, g.orders, g.counts, g.capacity, g.method, g.n0,
                g.policy.name, g.overlap) == (
            w.n, w.orders, w.counts, w.capacity, w.method, w.n0,
            w.policy.name, w.overlap)
        assert g.merged_s == pytest.approx(w.merged_s, rel=1e-12)
        assert g.split_s == pytest.approx(w.split_s, rel=1e-12)
    orders = list(manifest) + [min(manifest) - 1]
    assert [got.bucket_for(d).n for d in orders] \
        == [want.bucket_for(d).n for d in orders]
    assert got.table().splitlines()[0] == want.table().splitlines()[0]


def test_plan_fleet_on_the_h100_preset():
    """The port's default machine and dispatch budget for the smoke's
    manifest at k = 16: order 4096 joins the 8192 bucket (4 x (26.03 -
    14.01) us <= 50 us) and 2048 opens its own (4 x (26.03 - 11.00) us
    > 50 us); at a 100 us budget all three share the 8192 bucket."""
    g = api.plan_grid(1, 1)
    man = {8192: 4, 4096: 4, 2048: 4}
    plan = api.plan_fleet(man, g, k=16, precision="bf16_refine")
    assert plan.dispatch_s == 5e-5
    assert [(b.n, b.orders, b.capacity, b.method, b.n0)
            for b in plan.buckets] == [(8192, (8192, 4096), 8, "inv", 4096),
                                       (2048, (2048,), 4, "inv", 1024)]
    wide = api.plan_fleet(man, g, k=16, precision="bf16_refine",
                          dispatch_s=1e-4)
    assert [(b.n, b.orders, b.capacity, b.method, b.n0)
            for b in wide.buckets] == [(8192, (8192, 4096, 2048), 12, "inv",
                                        4096)]


def test_plan_fleet_validation():
    g = api.plan_grid(1, 1)
    with pytest.raises(ValueError, match="empty"):
        api.plan_fleet({}, g)
    with pytest.raises(ValueError, match=">= 1"):
        api.plan_fleet({64: 0}, g)
    with pytest.raises(ValueError, match=">= 1"):
        api.plan_fleet({0: 3}, g)
    plan = api.plan_fleet([64, 32], g, k=4, dispatch_s=1e9)
    with pytest.raises(ValueError, match="exceeds every bucket"):
        plan.bucket_for(1 << 20)


@pytest.mark.parametrize("manifest,text", [
    ({256: 2, 128: 2}, "banded:16"), ({4096: 2, 2048: 4}, "banded:16"),
    ({256: 2, 64: 2}, "block-sparse"), ({1024: 2, 512: 2}, "block-sparse")])
def test_plan_fleet_threads_structure(manifest, text):
    """tests/test_structure.py::test_plan_fleet_threads_structure against
    the reference: the same buckets (orders, counts, capacities,
    methods), the structure stamped on every "inv" bucket and on no
    "rec" one, and each side's n0 its OWN ``serving_n0``: the
    structured argmin prices with each package's default machine (the
    port's H100 preset, the reference's calibrated TPU), whatever
    machine the planner was given, so the two n0 may differ."""
    from repro.core import tuning as jtuning
    from repro.core.structure import FactorStructure as JStructure
    from repro_torch.core import tuning
    n = max(manifest)
    st = api.FactorStructure.parse(text, n=n)
    jst = JStructure.parse(text, n=n)
    g, jg = api.plan_grid(1, 1), japi.plan_grid(1, 1)
    kw = dict(k=8, dispatch_s=5e-5)
    plan = api.plan_fleet(manifest, g, machine=cm.tpu_v5e(), structure=st,
                          **kw)
    jplan = japi.plan_fleet(manifest, jg, machine=jcm.tpu_v5e(),
                            structure=jst, **kw)

    def rows(p):
        return [(b.n, b.orders, b.counts, b.capacity, b.method)
                for b in p.buckets]
    assert rows(plan) == rows(jplan)
    for b, jb in zip(plan.buckets, jplan.buckets):
        if b.method == "inv":
            assert b.structure == st and jb.structure == jst
            assert b.n0 == tuning.serving_n0(b.n, g, structure=st)
            assert jb.n0 == jtuning.serving_n0(jb.n, jg, structure=jst)
        else:
            assert b.structure is None and jb.structure is None


# ------------------------------ the fleet ------------------------------

def _fleets(jref, manifest=None, precision="fp32", k=4, dispatch_s=5e-5):
    """A port fleet and a reference fleet of one plan (explicit TPU
    machine on both sides)."""
    manifest = manifest or {32: 2, 16: 2}
    kw = dict(k=k, precision=precision, dispatch_s=dispatch_s)
    jplan = jref.plan_fleet(manifest, JGRID, machine=jcm.tpu_v5e(), **kw)
    plan = api.plan_fleet(manifest, CPU, machine=cm.tpu_v5e(), **kw)
    return api.SolverFleet(CPU, plan), japi.SolverFleet(JGRID, jplan)


def _same_handle(h, jh):
    assert (h.bucket[0], h.slot, h.generation, h.tenant, h.tag, h.order) \
        == (jh.bucket[0], jh.slot, jh.generation, jh.tenant, jh.tag,
            jh.order)


def _both(fleets, fn):
    """fn(fleet) on both sides; returns (port result, reference result),
    or the exception types and messages when both raise."""
    out = []
    for f in fleets:
        try:
            out.append(fn(f))
        except (KeyError, ValueError) as e:
            out.append((type(e), str(e)))
    return out


def test_fleet_admit_lookup_and_stats_match_reference(jref):
    fl, jfl = _fleets(jref)
    assert len(fl.buckets) == 1 and fl.plan.buckets[0].capacity == 4
    hs = []
    for seed, (d, tenant, tag) in enumerate([(16, "a", "l0"), (32, "b", "l0"),
                                             (16, "a", "l1")]):
        T = _tri(d, seed=seed + 1)
        h, jh = fl.admit(T, tenant=tenant, tag=tag), \
            jfl.admit(T, tenant=tenant, tag=tag)
        _same_handle(h, jh)
        hs.append(h)
    assert [h.slot for h in hs] == [0, 1, 2]
    assert fl.lookup("a", order=16, tag="l0") is hs[0]
    assert jfl.lookup("a", order=16, tag="l0").slot == 0
    assert fl.lookup("b", order=32) is hs[1]
    jfl.lookup("b", order=32)
    for call, err in ((lambda f: f.lookup("a", order=16), ValueError),
                      (lambda f: f.lookup("a", order=8), KeyError)):
        got, want = _both((fl, jfl), call)
        assert got[0] is want[0] is err
    assert fl.handles("a") == (hs[0], hs[2]) and len(fl.handles()) == 3
    assert fl.manifest() == jfl.manifest() == {16: 2, 32: 1}
    st, jst = fl.stats(), jfl.stats()
    for key in ("admits", "reclaims", "lookup_hits", "lookup_misses",
                "hit_rate"):
        assert st[key] == jst[key], key
    assert list(st["buckets"].values()) == list(jst["buckets"].values())
    assert fl.format_stats() == jfl.format_stats()


def test_fleet_cross_tenant_lru_reclaim_matches_reference(jref):
    """A full bucket reclaims its least-recently-used live slot across
    tenants on both sides; the victim's handle goes stale and every
    operation through it is refused."""
    fleets = _fleets(jref)
    hs = {}
    for f in fleets:
        hs[f] = [f.admit(_tri(16, seed=i), tenant=t, tag=i)
                 for i, t in enumerate(["a", "a", "b", "b"])]
        f.lookup("a", tag=0)
        f.lookup("b", tag=2)
        f.lookup("b", tag=3)
    new = [f.admit(_tri(16, seed=9), tenant="c", tag="hot") for f in fleets]
    _same_handle(*new)
    fl, jfl = fleets
    assert new[0].slot == hs[fl][1].slot == 1
    assert new[0].generation == hs[fl][1].generation + 1
    assert fl.reclaims == jfl.reclaims == 1
    assert hs[fl][1] not in fl.handles()
    for call in (lambda f: f.replace(hs[f][1], _tri(16)),
                 lambda f: f.evict(hs[f][1])):
        got, want = _both(fleets, call)
        assert got[0] is want[0] is KeyError and "stale handle" in got[1]
    got, want = _both(fleets, lambda f: f.lookup("a", tag=1))
    assert got[0] is want[0] is KeyError
    for f in fleets:
        f.evict(hs[f][0])
    back = [f.admit(_tri(16, seed=10), tenant="a", tag=0) for f in fleets]
    _same_handle(*back)
    assert back[0].slot == 0 and fl.reclaims == 1
    assert fl.format_stats() == jfl.format_stats()


def test_fleet_replace_refuses_an_order_change(jref):
    fleets = _fleets(jref)
    got, want = _both(fleets, lambda f: f.replace(
        f.admit(_tri(16), tenant="a"), _tri(32)))
    assert got[0] is want[0] is ValueError
    assert "order 32 != admitted" in got[1]


def _serve(fleet, server_cls, reqs, panel_k=8):
    server = server_cls(fleet, panel_k=panel_k).warmup()
    for b, tenant, tag in reqs:
        server.submit(b, tenant=tenant, tag=tag)
    return server, server.drain()


@pytest.mark.parametrize("precision", ["fp32", "bf16_refine"])
def test_solve_server_fleet_mode_matches_reference(jref, precision):
    """Requests route by (tenant, order[, tag]); mixed orders in one
    stream drain as one wave per bucket; results come back keyed by
    (tenant, tag) at the request's true order, within TOL of the
    reference's and within its residual bound."""
    fleets = _fleets(jref, precision=precision)
    Ts = {("a", "l0"): _tri(16, 1), ("b", "l0"): _tri(32, 2),
          ("c", "l0"): _tri(16, 3)}
    for f in fleets:
        for (tenant, tag), T in Ts.items():
            f.admit(T, tenant=tenant, tag=tag)
    rng = np.random.default_rng(4)
    reqs = [(rng.standard_normal((16, 2)).astype(np.float32), "a", "l0"),
            (rng.standard_normal((32, 3)).astype(np.float32), "b", "l0"),
            (rng.standard_normal(16).astype(np.float32), "c", "l0")]
    server, outs = _serve(fleets[0], api.SolveServer, reqs)
    _, jouts = _serve(fleets[1], japi.SolveServer, reqs)
    assert set(outs) == set(jouts) == set(Ts)
    for (b, tenant, tag) in reqs:
        X, = outs[(tenant, tag)]
        jX, = jouts[(tenant, tag)]
        b2 = b if b.ndim == 2 else b[:, None]
        assert tuple(X.shape) == tuple(jX.shape) == b2.shape
        assert_close(X, np.asarray(jX), TOL)
        assert _rel(Ts[(tenant, tag)], X, b2) < RELRES
    assert server.waves_solved == 1 and server.requests_served == 3
    assert server.pending() == 0
    with pytest.raises(KeyError, match="no live factor"):
        server.submit(reqs[0][0], tenant="zz")
    with pytest.raises(ValueError, match="fleet"):
        server.cancel(0)
    plain = api.SolveServer(
        api.Solver.from_bank(fleets[0].bucket(fleets[0].buckets[0]).bank), 8)
    with pytest.raises(ValueError, match="fleet"):
        plain.submit(np.zeros((32, 1), np.float32), tenant="a")


def test_apply_plan_migrates_as_the_reference_does(jref):
    """Split into per-order buckets, then merge: a grown bucket is
    rebuilt (capacity is its programs' width), a vanished one closed,
    every handle whose bucket changed re-admitted (padded into the
    merged bucket) with its old slot's generation bumped, LRU clocks
    carried; then split again, which keeps the surviving bucket.  The
    moves, opens, closes and rebuilds equal the reference's, and a
    fleet server routes to the rebuilt bucket and solves as the
    reference does."""
    man = {32: 2, 16: 2}
    fleets = _fleets(jref, man, dispatch_s=0.0)
    assert [b.n for b in fleets[0].plan.buckets] == [32, 16]
    Ts = [(_tri(32, 1), "a", 0), (_tri(16, 2), "a", 1),
          (_tri(32, 3), "b", 0), (_tri(16, 4), "b", 1)]
    for f in fleets:
        for T, tenant, tag in Ts:
            f.admit(T, tenant=tenant, tag=tag)
    rng = np.random.default_rng(6)
    reqs = [(rng.standard_normal((T.shape[0], 3)).astype(np.float32),
             tenant, tag) for T, tenant, tag in Ts]
    server = api.SolveServer(fleets[0], 8)
    for b, tenant, tag in reqs:
        server.submit(b, tenant=tenant, tag=tag)
    server.drain()                       # inner servers of the old banks
    results = []
    for split in (1e9, 0.0):
        moves = [[], []]
        out = []
        for i, (f, mod) in enumerate(zip(fleets, (api, jref))):
            kw = dict(k=4, precision="fp32", dispatch_s=split)
            plan = (api.plan_fleet(man, CPU, machine=cm.tpu_v5e(), **kw)
                    if i == 0 else
                    jref.plan_fleet(man, JGRID, machine=jcm.tpu_v5e(), **kw))
            res = f.apply_plan(plan, on_move=lambda o, n, i=i:
                               moves[i].append((o.slot, n.slot)))
            out.append(res)
        got, want = out
        for key in ("opened", "closed", "rebuilt"):
            assert [k[0] for k in got[key]] == [k[0] for k in want[key]], key
        assert [(o.order, o.slot, n.slot, n.bucket[0]) for o, n in
                got["moved"]] == [(o.order, o.slot, n.slot, n.bucket[0])
                                  for o, n in want["moved"]]
        assert moves[0] == moves[1]
        for o, _ in got["moved"]:
            with pytest.raises(KeyError, match="stale handle|unknown"):
                fleets[0].replace(o, _tri(o.order))
        results.append(got)
    assert [k[0] for k in results[0]["rebuilt"]] == [32]
    assert [k[0] for k in results[0]["closed"]] == [16]
    assert len(results[0]["moved"]) == 4
    assert [k[0] for k in results[1]["opened"]] == [16]
    assert len(results[1]["moved"]) == 2
    for f in fleets:
        f.apply_plan((api if f is fleets[0] else jref).plan_fleet(
            man, CPU if f is fleets[0] else JGRID, k=4, precision="fp32",
            dispatch_s=1e9,
            machine=(cm if f is fleets[0] else jcm).tpu_v5e()))
    # the bucket rows (the port's fleet alone served the first requests)
    assert fleets[0].format_stats().splitlines()[:-1] \
        == fleets[1].format_stats().splitlines()[:-1]
    for b, tenant, tag in reqs:          # the same server, rebuilt bucket
        server.submit(b, tenant=tenant, tag=tag)
    outs = server.drain()
    assert server.requests_served == 2 * len(reqs)
    _, jouts = _serve(fleets[1], japi.SolveServer, reqs)
    for (b, tenant, tag), (T, _, _) in zip(reqs, Ts):
        X, = outs[(tenant, tag)]
        assert_close(X, np.asarray(jouts[(tenant, tag)][0]), TOL)
        assert _rel(T, X, b) < RELRES
    # a request queued on a bank that a migration then rebuilds
    server.submit(reqs[0][0], tenant="a", tag=0)
    fleets[0].apply_plan(api.plan_fleet(
        {32: 4, 16: 2}, CPU, k=4, precision="fp32", dispatch_s=1e9,
        machine=cm.tpu_v5e()))
    with pytest.raises(api.StrandedRequestError, match="rebuilt"):
        server.submit(reqs[0][0], tenant="a", tag=0)


def test_bucket_banks_read_the_relay_of_the_fleet_that_holds_them():
    """A bank that a fleet holds as a bucket finds the p > 1 server
    leading the fleet (``_relay``) through the fleet, at call time, so
    its own mutations are streamed too: set on the fleet, every bucket's
    bank reads it; the banks of buckets that ``apply_plan`` rebuilt or
    closed are no longer the fleet's and read none; cleared, no bank
    reads it; a bank of no fleet keeps its own, and a bank whose fleet
    is gone reads none."""
    import gc

    def plan(dispatch_s):
        return api.plan_fleet({32: 2, 16: 2}, CPU, k=4, precision="fp32",
                              dispatch_s=dispatch_s, machine=cm.tpu_v5e())
    relay = object()
    fleet = api.SolverFleet(CPU, plan(0.0))        # split: two buckets
    old = [fleet.bucket(k).bank for k in fleet.buckets]
    assert len(old) == 2 and all(b._relay is None for b in old)
    fleet._relay = relay
    assert all(b._relay is relay for b in old)
    fleet._relay = None
    res = fleet.apply_plan(plan(1e9))              # merged: 32 rebuilt
    assert [k[0] for k in res["rebuilt"]] == [32]
    assert [k[0] for k in res["closed"]] == [16]
    fleet._relay = relay
    assert all(b._relay is None for b in old)
    new = fleet.bucket(fleet.buckets[0]).bank
    assert new._relay is relay
    fleet._relay = None
    assert new._relay is None
    alone = api.FactorBank(CPU, 16, capacity=2)
    assert alone._relay is None
    alone._relay = relay
    assert alone._relay is relay
    fleet._relay = relay
    del fleet, res
    gc.collect()
    assert new._relay is None


@pytest.mark.parametrize("precision", ["fp32", "bf16_refine"])
def test_fleet_steady_state_builds_nothing(precision):
    """Routing, an in-place refresh with a placed factor and a
    cross-tenant reclaim at full occupancy build no program and no
    updater after warmup; every live lane solves its factor (the
    leading d x k block of a padded lane)."""
    k, n_b = 4, 32
    plan = api.plan_fleet({32: 2, 16: 2}, CPU, k=k, precision=precision,
                          machine=cm.tpu_v5e(), dispatch_s=5e-5)
    fleet = api.SolverFleet(CPU, plan).warmup(k)
    bkey = fleet.buckets[0]
    bank, solver = fleet.bucket(bkey).bank, fleet.solver(bkey)
    orders = [16, 32, 16, 32]
    Ls = [_tri(d, seed=10 + i) for i, d in enumerate(orders)]
    hs = [fleet.admit(L, tenant="ab"[i % 2], tag=i)
          for i, L in enumerate(Ls)]
    live = {h.slot: (L, h.order) for h, L in zip(hs, Ls)}
    fresh = [_tri(16, seed=50), _tri(32, seed=51)]
    placed = [fleet.place_factor(L) for L in fresh]
    rng = np.random.default_rng(1)
    Bs = [solver.place_rhs(rng.standard_normal((4, n_b, k))
                           .astype(np.float32)) for _ in range(3)]
    skey = solver.spec_for(k)
    uspecs = [bank.update_spec(pad_from=16), bank.update_spec()]
    builds = [session.BUILD_COUNTS[s] for s in (skey, *uspecs)]
    outs = [(solver.solve(Bs[0]), dict(live))]
    fleet.replace(hs[0], placed[0])
    live[hs[0].slot] = (fresh[0], 16)
    outs.append((solver.solve(Bs[1]), dict(live)))
    h_new = fleet.admit(placed[1], tenant="c")
    assert h_new.slot == hs[1].slot and fleet.reclaims == 1
    live[h_new.slot] = (fresh[1], 32)
    outs.append((solver.solve(Bs[2]), dict(live)))
    assert [session.BUILD_COUNTS[s] for s in (skey, *uspecs)] == builds
    for (X, then), B in zip(outs, Bs):
        for slot, (L, d) in then.items():
            assert _rel(L, X[slot][:d], B[slot][:d].numpy()) < RELRES
    with pytest.raises(KeyError, match="stale handle"):
        fleet.replace(hs[1], placed[1])


def test_the_fleet_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "trsm-fleet", "--device", "cpu", "--n", "64", "--requests", "24",
         "--updates", "6", "--precision", "bf16_refine", "--fleet-stats"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    assert "served 24 mixed-order requests" in out
    assert "rebuilds solve=0" in out and "cross-tenant reclaims" in out
    assert "fleet: admits=" in out
    assert tri_inv_block.tri_inv_blocks.valid_launches == 0
