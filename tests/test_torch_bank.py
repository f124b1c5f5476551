"""Capacity banks and live mutation (DESIGN.md Sec. 11) and kernel B6 of
the port against the JAX package's, on the CPU.

The same numpy factors and right-hand sides go through a ``repro``
bank and a ``repro_torch`` bank driven by the same sequence of admits,
replaces, runs, evicts and re-admits; after each step every live lane
is compared.  The JAX side passes ``block_inv=ops.block_inv_kernel``
for "inv" (its default phase 1 fails on jax 0.9, ROADMAP C); its
validity-gated substitution kernel runs in interpret mode, as its own
tests run it.  Tolerances (``torch_parity``, relative with an absolute
term scaled to max|X|): fp32 and bf16_refine 2e-5, as
tests/test_kernels.py and the port's other parity tests hold them.
Dead lanes are compared with exact zeros in the port only: the
reference's empty "rec" lanes are NaN (recorded by
``test_rec_empty_lanes_are_zeros_here_and_nan_in_the_reference``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.core import session
from repro_torch.core.bank import BatchedTrsmSession
from repro_torch.kernels import ops, ref, trsm_block
from repro_torch.launch import serve as cli
from torch_parity import assert_close

CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = japi.make_trsm_mesh(1, 1)
TOL = {"fp32": 2e-5, "bf16_refine": 2e-5}


def _factors(M, n=32, seed=0):
    rng = np.random.default_rng(seed)
    Ls = np.stack([np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
                   for _ in range(M)]).astype(np.float32)
    return Ls, rng


def _banks(method, precision, n=32, C=4, n0=8, structure=None):
    """A reference bank and a port bank of one configuration."""
    kw = dict(method=method, n0=n0, precision=precision, capacity=C)
    jkw = dict(kw, block_inv=jops.block_inv_kernel) if method == "inv" \
        else kw
    jst = st = None
    if structure is not None:
        jst = japi.FactorStructure.parse(structure, n=n)
        st = api.FactorStructure.parse(structure, n=n)
    return (japi.FactorBank(JGRID, n, structure=jst, **jkw),
            api.FactorBank(CPU, n, structure=st, **kw))


def _rhs(bank, rng, k=4):
    """Random panels for the live lanes, zero panels for the dead ones
    (what a server gives them)."""
    B = rng.standard_normal((bank.width, bank.n, k)).astype(np.float32)
    for s in range(bank.width):
        if not bank.is_live(s):
            B[s] = 0
    return B


def _solve(bank, B):
    return api.Solver.from_bank(bank).solve(torch.as_tensor(B))


def _jsolve(jbank, B):
    return np.asarray(japi.Solver.from_bank(jbank).solve(jnp.asarray(B),
                                                         donate=False))


def _compare(jbank, bank, rng, tol):
    """Every live lane against the reference, every dead lane exactly
    zero."""
    assert bank.live_slots() == jbank.live_slots()
    B = _rhs(bank, rng)
    X, jX = _solve(bank, B), _jsolve(jbank, B)
    for s in range(bank.width):
        if bank.is_live(s):
            assert_close(X[s], jX[s], tol)
        else:
            assert torch.equal(X[s], torch.zeros_like(X[s])), s
    return X


# ------------------------------ kernel B6 ------------------------------

@pytest.mark.parametrize("m,n0,k,mask", [(4, 16, 32, (1, 0, 1, 0)),
                                         (3, 32, 64, (0, 1, 1)),
                                         (2, 16, 16, (0, 0))])
def test_b6_plain_matches_reference_kernel_and_ignores_poison(m, n0, k,
                                                               mask):
    """The plain B6 against ``repro.kernels.ops.trsm_substitution(valid=)``
    (the Pallas kernel in interpret mode); NaN planted in every invalid
    system's L (its diagonal zeroed) and B changes no bit of either
    side's valid outputs, and their invalid outputs are exact zeros."""
    rng = np.random.default_rng(n0 * k + m)
    Ls = np.stack([np.tril(rng.standard_normal((n0, n0))) + n0 * np.eye(n0)
                   for _ in range(m)]).astype(np.float32)
    Bs = rng.standard_normal((m, n0, k)).astype(np.float32)
    v = np.asarray(mask, np.int32)
    Lp, Bp = Ls.copy(), Bs.copy()
    Lp[v == 0] = np.nan
    for i in np.flatnonzero(v == 0):
        np.fill_diagonal(Lp[i], 0)
    Bp[v == 0] = np.nan
    want = np.asarray(jops.trsm_substitution(jnp.asarray(Ls), jnp.asarray(Bs),
                                             valid=jnp.asarray(v)))
    jpois = np.asarray(jops.trsm_substitution(
        jnp.asarray(Lp), jnp.asarray(Bp), valid=jnp.asarray(v)))
    got = ops.trsm_substitution(torch.as_tensor(Ls), torch.as_tensor(Bs),
                                valid=torch.as_tensor(v))
    pois = ops.trsm_substitution(torch.as_tensor(Lp), torch.as_tensor(Bp),
                                 valid=torch.as_tensor(v))
    assert_close(got, want, 2e-5)
    assert torch.equal(pois, got)
    np.testing.assert_array_equal(jpois, want)
    assert not got[torch.as_tensor(v == 0)].any()
    # the oracle agrees, and valid systems are B3's, bit for bit
    assert_close(got, ref.trsm_valid_ref(torch.as_tensor(Ls),
                                         torch.as_tensor(Bs),
                                         torch.as_tensor(v)), 2e-5)
    ones = ops.trsm_substitution(torch.as_tensor(Ls), torch.as_tensor(Bs),
                                 valid=torch.ones(m, dtype=torch.int32))
    assert torch.equal(ones, ops.trsm_substitution(torch.as_tensor(Ls),
                                                   torch.as_tensor(Bs)))


def test_b6_takes_quadrant_views_and_checks_its_mask():
    """The recursion hands the base case strided quadrant views of the
    resident stack; the mask must have one flag per system, on L's
    device."""
    rng = np.random.default_rng(5)
    L = torch.as_tensor(np.tril(rng.standard_normal((3, 64, 64)))
                        + 64 * np.eye(64), dtype=torch.float32)
    B = torch.as_tensor(rng.standard_normal((3, 64, 8)), dtype=torch.float32)
    v = torch.tensor([1, 0, 1], dtype=torch.int32)
    got = ops.trsm_substitution(L[:, 32:, 32:], B[:, 32:], valid=v)
    want = ops.trsm_substitution(L[:, 32:, 32:].contiguous(),
                                 B[:, 32:].contiguous(), valid=v)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="one flag per system"):
        ops.trsm_substitution(L, B, valid=torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="valid on"):
        ops.trsm_substitution(L, B, valid=torch.ones(3, device="meta"))
    assert trsm_block.trsm_substitution.valid_launches == 0


def test_rec_program_hands_the_liveness_vector_to_every_base_case(
        monkeypatch):
    """A "rec" capacity bank's program takes the bank's liveness vector
    as an operand at every base case (n / n0 per pass); an append-only
    bank's passes none (B3 unchanged)."""
    seen = []
    real = ops.trsm_substitution

    def spy(L, B, *, accum_dtype=None, valid=None):
        seen.append(valid)
        return real(L, B, accum_dtype=accum_dtype, valid=valid)

    monkeypatch.setattr(ops, "trsm_substitution", spy)
    Ls, rng = _factors(2, seed=2)
    bank = api.FactorBank(CPU, 32, method="rec", n0=8,
                          precision="bf16_refine", capacity=3)
    for L in Ls:
        bank.admit(L)
    _solve(bank, _rhs(bank, rng))
    assert len(seen) == 4 * 3 and all(v is bank.valid for v in seen)
    assert bank.valid.tolist() == [1, 1, 0]
    seen.clear()
    _solve(_append_only(Ls, "rec"), rng.standard_normal((2, 32, 4)))
    assert len(seen) == 4 and all(v is None for v in seen)


def _append_only(Ls, method, **kw):
    bank = api.FactorBank(CPU, Ls.shape[-1], method=method, n0=8, **kw)
    bank.admit_stack(Ls)
    return bank


def test_rec_empty_lanes_are_zeros_here_and_nan_in_the_reference():
    """The reference's zero-filled "rec" lanes divide 0 by 0 in their
    base case (against its own docstring, ROADMAP C); the port's gated
    base case solves them to exact zeros.  Both are asserted, so the
    difference stays on record."""
    n, C, k = 32, 4, 4
    jbank, bank = _banks("rec", "bf16_refine", n, C, n0=16)
    Ls, rng = _factors(2, n, seed=3)
    for L in Ls:
        jbank.admit(L)
        bank.admit(L)
    B = rng.standard_normal((C, n, k)).astype(np.float32)
    jX, X = _jsolve(jbank, B), _solve(bank, B)
    assert np.isnan(jX[2:]).all()
    assert torch.equal(X[2:], torch.zeros_like(X[2:]))
    for s in (0, 1):
        assert_close(X[s], jX[s], TOL["bf16_refine"])
    empty = api.FactorBank(CPU, n, method="rec", n0=16,
                           precision="bf16_refine", capacity=C)
    X = api.Solver.from_bank(empty).warmup(k).solve(torch.as_tensor(B))
    assert torch.equal(X, torch.zeros_like(X))


# --------------------------- capacity lifecycle ---------------------------

@pytest.mark.parametrize("precision", ["fp32", "bf16_refine"])
@pytest.mark.parametrize("method", ["inv", "rec"])
def test_capacity_lifecycle_matches_reference(method, precision):
    """admit (lowest free slot), replace, replace_run, evict and
    re-admit (the victim's slot reused) on both packages; after each
    step every live lane agrees and every dead lane is zero."""
    n, C = 32, 4
    Ls, rng = _factors(8, n, seed=4)
    jbank, bank = _banks(method, precision, n, C)
    tol = TOL[precision]

    def both(op, *args, **kw):
        got = getattr(bank, op)(*args, **kw)
        want = getattr(jbank, op)(*args, **kw)
        assert got == want or list(got) == list(want), (op, got, want)
        return got

    X = api.Solver.from_bank(bank).warmup(4).solve(torch.zeros(C, n, 4))
    assert torch.equal(X, torch.zeros_like(X))             # empty warmup
    assert both("admit", Ls[0]) == 0 and both("admit", Ls[1]) == 1
    _compare(jbank, bank, rng, tol)
    both("replace", 1, Ls[2])
    _compare(jbank, bank, rng, tol)
    assert both("admit", Ls[3]) == 2
    assert list(both("replace_run", 0, Ls[4:6])) == [0, 1]
    _compare(jbank, bank, rng, tol)
    both("evict", 1)
    assert bank.valid.tolist() == [1, 0, 1, 0]
    assert bank.slot_generation(1) == jbank.slot_generation(1) == 1
    _compare(jbank, bank, rng, tol)
    assert both("admit", Ls[6]) == 1                        # re-admit
    both("replace_run", 1, Ls[6:8])
    X = _compare(jbank, bank, rng, tol)
    assert bank.size == 3 and bank.updates_dispatched == 7


@pytest.mark.parametrize("method", ["inv", "rec"])
def test_cyclic_admission_is_natural_admission_at_p1(method):
    """At p = 1 (lower, not transposed) cyclic storage is the natural
    layout: admit_cyclic / replace_cyclic give the resident stacks of
    admit / replace bit for bit, on capacity and append-only banks, and
    the lanes agree with the reference's cyclic ingestion."""
    n = 32
    Ls, rng = _factors(3, n, seed=5)
    jbank, cyc = _banks(method, "bf16_refine", n, C=2)
    nat = api.FactorBank(CPU, n, method=method, n0=8,
                         precision="bf16_refine", capacity=2)
    for b in (jbank, cyc):
        assert b.admit_cyclic(Ls[0]) == 0 and b.admit(Ls[1]) == 1
        b.replace_cyclic(1, Ls[2])
    nat.admit(Ls[0])
    nat.admit(Ls[1])
    nat.replace(1, Ls[2])
    for a, b in zip(cyc.stacks(), nat.stacks()):
        assert torch.equal(a, b)
    _compare(jbank, cyc, rng, TOL["bf16_refine"])
    app = api.FactorBank(CPU, n, method=method, n0=8, precision="fp32")
    app.admit_cyclic(Ls[0])
    for a, b in zip(app.stacks(), _append_only(Ls[:1], method).stacks()):
        assert torch.equal(a, b)
    upper = api.FactorBank(CPU, n, n0=8, capacity=1, lower=False)
    upper.admit(Ls[0].T)
    with pytest.raises(ValueError, match="cyclic ingestion"):
        upper.replace_cyclic(0, Ls[0])


@pytest.mark.parametrize("method", ["inv", "rec"])
def test_padded_admission_is_bit_identical_to_the_unpadded_solve(method):
    """pad_to=n admits an order-d factor as blockdiag(L, I): the leading
    d x k block equals an unpadded order-d solve at the same n0 bit for
    bit, the tail is exact zeros, and the lane agrees with the
    reference's padded admission."""
    n, d, k = 32, 16, 4
    Ts, rng = _factors(2, d, seed=6)
    jbank, bank = _banks(method, "bf16_refine", n, C=2)
    for b in (jbank, bank):
        assert b.admit(Ts[0], pad_to=n) == 0
    small = api.FactorBank(CPU, d, method=method, n0=8,
                           precision="bf16_refine", capacity=1)
    small.admit(Ts[0])
    B = rng.standard_normal((d, k)).astype(np.float32)
    Bp = np.zeros((2, n, k), np.float32)
    Bp[0, :d] = B
    X = _solve(bank, Bp)
    Xs = _solve(small, B[None])
    assert torch.equal(X[0, :d], Xs[0])
    assert torch.equal(X[:, d:], torch.zeros_like(X[:, d:]))
    assert_close(X[0], _jsolve(jbank, Bp)[0], TOL["bf16_refine"])
    # replace with a padded factor, and a padded run, the same way
    bank.replace(0, Ts[1], pad_to=n)
    small.replace(0, Ts[1])
    assert torch.equal(_solve(bank, Bp)[0, :d], _solve(small, B[None])[0])
    bank.admit(Ts[0], pad_to=n)
    bank.replace_run(0, Ts, pad_to=n)
    assert bank.update_spec(chunk=2, pad_from=d) in bank.cache
    with pytest.raises(ValueError, match="must equal the bank's order"):
        bank.replace(0, Ts[0], pad_to=64)
    with pytest.raises(ValueError, match="capacity-allocated"):
        api.FactorBank(CPU, n, n0=8).admit(Ts[0], pad_to=n)


@pytest.mark.parametrize("method", ["inv", "rec"])
def test_structured_capacity_bank_matches_reference(method):
    """A banded capacity bank: the updater masks each admitted factor at
    the bank's n0, as the append-only admission does; lanes agree with
    the reference's structured capacity bank through churn."""
    n = 32
    Ls, rng = _factors(4, n, seed=7)
    jbank, bank = _banks(method, "bf16_refine", n, C=3,
                         structure="banded:8")
    for b in (jbank, bank):
        b.admit(Ls[0])
        b.admit(Ls[1])
        b.replace(0, Ls[2])
        b.evict(1)
        assert b.admit(Ls[3]) == 1
    app = api.FactorBank(CPU, n, method=method, n0=8,
                         precision="bf16_refine",
                         structure=api.FactorStructure.parse("banded:8"))
    app.admit_stack(Ls[[2, 3]])
    for a, b in zip(bank.stacks(), app.stacks()):
        assert torch.equal(a[:2], b)
    _compare(jbank, bank, rng, TOL["bf16_refine"])
    with pytest.raises(ValueError, match="cyclic ingestion into a "
                                         "structured bank"):
        bank.admit_cyclic(Ls[0])


@pytest.mark.parametrize("method", ["inv", "rec"])
def test_full_width_admit_stack_equals_per_slot_admission(method):
    """An empty capacity bank filled to exactly C takes one batched
    admission, bit-identical to C single admissions; a partial fill
    falls back to per-slot admission."""
    n, C = 32, 3
    Ls, rng = _factors(C, n, seed=8)
    fast = api.FactorBank(CPU, n, method=method, n0=8,
                          precision="bf16_refine", capacity=C)
    slow = api.FactorBank(CPU, n, method=method, n0=8,
                          precision="bf16_refine", capacity=C)
    assert fast.admit_stack(Ls) == [0, 1, 2]
    assert [slow.admit(L) for L in Ls] == [0, 1, 2]
    assert fast.updates_dispatched == 0 and slow.updates_dispatched == 3
    assert fast.valid.tolist() == slow.valid.tolist() == [1, 1, 1]
    for a, b in zip(fast.stacks(), slow.stacks()):
        assert torch.equal(a, b)
    B = _rhs(fast, rng)
    assert torch.equal(_solve(fast, B), _solve(slow, B))
    part = api.FactorBank(CPU, n, method=method, n0=8, capacity=C)
    part.admit(Ls[0])
    assert part.admit_stack(Ls[1:]) == [1, 2]
    with pytest.raises(ValueError, match="bank full"):
        part.admit_stack(Ls[:1])


def test_append_only_replace_matches_reference():
    """replace works on append-only banks too (the KFAC refresh path),
    in place in the fused stacks."""
    n = 32
    Ls, rng = _factors(4, n, seed=9)
    jbank = japi.FactorBank(JGRID, n, n0=8, precision="fp32",
                            block_inv=jops.block_inv_kernel)
    bank = api.FactorBank(CPU, n, n0=8, precision="fp32")
    for b in (jbank, bank):
        b.admit_stack(Ls[:3])
        b.replace(1, Ls[3])
    stack = bank.stacks()[0]
    _compare(jbank, bank, rng, TOL["fp32"])
    assert bank.stacks()[0] is stack
    with pytest.raises(ValueError, match="capacity-allocated"):
        bank.evict(0)
    with pytest.raises(ValueError, match="capacity-allocated"):
        bank.replace_run(0, Ls[:2])


# ----------------------- validation and bookkeeping -----------------------

def test_capacity_bank_validation_matches_reference():
    """The reference's lifecycle errors, with its messages."""
    Ls, _ = _factors(3, seed=10)
    jbank, bank = _banks("inv", "fp32", C=2)
    for b in (jbank, bank):
        b.admit(Ls[0])
        b.admit(Ls[1])
    calls = [lambda b: b.admit(Ls[2]), lambda b: b.admit_stack(Ls[:1]),
             lambda b: b.replace(5, Ls[2]), lambda b: b.replace_run(1, Ls),
             lambda b: (b.evict(0), b.replace(0, Ls[2])),
             lambda b: b.evict(0)]
    for call in calls:
        with pytest.raises(ValueError) as jerr:
            call(jbank)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            call(bank)
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        api.FactorBank(CPU, 32, capacity=0)


def test_failed_admission_returns_the_slot(monkeypatch):
    """An update that fails mid-admission puts the slot back on the
    free list and leaves its liveness flag at 0."""
    bank = api.FactorBank(CPU, 32, n0=8, capacity=2)
    Ls, _ = _factors(1)

    def fail(*a, **k):
        raise RuntimeError("launch")

    monkeypatch.setattr(bank, "_scatter", fail)
    with pytest.raises(RuntimeError, match="launch"):
        bank.admit(Ls[0])
    assert bank._free == [0, 1] and bank.size == 0
    assert bank.valid.tolist() == [0, 0]
    monkeypatch.undo()
    assert bank.admit(Ls[0]) == 0 and bank.live_slots() == (0,)


@pytest.mark.parametrize("method", ["inv", "rec"])
def test_one_build_per_spec_across_occupancies(method):
    """Banks of one capacity at occupancies 1, 2 and 4 share one solve
    program and one updater: occupancy is in no key."""
    n, C, k = 32, 4, 4
    cache = session.CompiledSolverCache()
    probe = api.FactorBank(CPU, n, method=method, n0=8, capacity=C)
    spec0, uspec0 = api.Solver.from_bank(probe).spec_for(k), \
        probe.update_spec()
    builds = (session.BUILD_COUNTS[spec0], session.BUILD_COUNTS[uspec0])
    keys = set()
    for occ in (1, 2, 4):
        Ls, _ = _factors(occ, seed=occ)
        bank = api.FactorBank(CPU, n, method=method, n0=8, capacity=C,
                              cache=cache)
        solver = api.Solver.from_bank(bank, cache=cache).warmup(k)
        for L in Ls:
            solver.admit_factor(L)
        solver.replace_factor(0, Ls[-1])
        solver.evict_factor(0)
        solver.admit_factor(Ls[0])
        solver.solve(torch.zeros(C, n, k))
        keys.add((solver.spec_for(k), bank.update_spec()))
    assert keys == {(spec0, uspec0)}
    assert (session.BUILD_COUNTS[spec0], session.BUILD_COUNTS[uspec0]) \
        == (builds[0] + 1, builds[1] + 1)
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] >= 4
    with pytest.raises(TypeError, match="UpdateSpec"):
        api.updater_for((1, 2))


def test_update_spec_normalizes_as_the_reference():
    """UpdateSpec's fields and normalizations: overlap is always None, a
    dense structure is None, cyclic ingestion is refused for structured
    banks and with pad_from, chunk lies in [1, C] — with the reference's
    messages."""
    from repro.core.solver import UpdateSpec as JUpdateSpec
    base = dict(n=32, method="inv", n0=8, mode=None, lower=True,
                transpose=False, block_inv=None, bank_width=4)
    port = api.UpdateSpec(grid=CPU, policy=api.PRESETS["fp32"],
                          overlap="on",
                          structure=api.FactorStructure.dense(), **base)
    assert port.overlap is None and port.structure is None
    assert port == api.UpdateSpec(grid=CPU, policy=api.PRESETS["fp32"],
                                  **base)
    banded = dict(structure="banded:8")
    for bad in (dict(ingest="weird"), dict(chunk=0), dict(chunk=5),
                dict(pad_from=32), dict(pad_from=16, ingest="cyclic"),
                dict(banded, ingest="cyclic")):
        jkw, kw = dict(base, **bad), dict(base, **bad)
        if "structure" in bad:
            jkw["structure"] = japi.FactorStructure.parse("banded:8")
            kw["structure"] = api.FactorStructure.parse("banded:8")
        with pytest.raises(ValueError) as jerr:
            JUpdateSpec(grid=JGRID, policy=japi.PRESETS["fp32"], **jkw)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            api.UpdateSpec(grid=CPU, policy=api.PRESETS["fp32"], **kw)


# ------------------------------- front door -------------------------------

def test_from_spec_capacity_entry_point():
    """A bank_width spec with no factors allocates an empty capacity
    bank to fill later; a contradicting capacity is refused."""
    spec = api.SolveSpec.auto(32, 4, grid=CPU, method="inv", n0=8,
                              precision="fp32", bank_width=3)
    solver = api.Solver.from_spec(spec)
    assert solver.width == 3 and solver.occupancy == 0
    Ls, rng = _factors(1, seed=11)
    slot = solver.admit_factor(Ls[0])
    B = np.zeros((3, 32, 4), np.float32)
    B[slot] = rng.standard_normal((32, 4))
    X = solver.solve(solver.place_rhs(B))
    assert np.linalg.norm(Ls[0] @ X[slot].numpy() - B[slot]) \
        < 1e-4 * np.linalg.norm(B[slot])
    with pytest.raises(ValueError, match="contradicts"):
        api.Solver.from_spec(spec, capacity=5)
    with pytest.raises(ValueError, match="bank_width=3"):
        api.Solver.from_spec(spec, Ls)
    wide = api.Solver.from_factors(np.concatenate([Ls, Ls]), CPU, n0=8,
                                   capacity=4)
    assert wide.width == 4 and wide.occupancy == 2


def test_server_refuses_inactive_slots_and_drains_live():
    n, C, k = 32, 4, 4
    Ls, rng = _factors(3, seed=12)
    bank = api.FactorBank(CPU, n, n0=8, capacity=C)
    slots = [bank.admit(L) for L in Ls]
    server = api.SolveServer(api.Solver.from_bank(bank), k).warmup()
    with pytest.raises(ValueError, match="inactive slot"):
        server.submit(np.zeros((n, 1), np.float32), factor=3)
    with pytest.raises(ValueError, match="unknown factor"):
        server.submit(np.zeros((n, 1), np.float32), factor=C)
    bank.evict(slots[1])
    with pytest.raises(ValueError, match="inactive slot"):
        server.submit(np.zeros((n, 1), np.float32), factor=slots[1])
    reqs = {f: rng.standard_normal((n, 2)).astype(np.float32)
            for f in (slots[0], slots[2])}
    for f, r in reqs.items():
        server.submit(r, factor=f)
    outs = server.drain()
    assert set(outs) == {slots[0], slots[2]}          # live slots only
    for f, r in reqs.items():
        assert_close(outs[f][0], np.linalg.solve(Ls[f], r), 2e-5)


def test_server_strands_requests_of_a_turned_over_slot():
    """A request submitted before its slot was evicted fails at drain,
    even after the slot was re-admitted (the generation counter catches
    what liveness cannot); cancel drops it and serving goes on."""
    n = 32
    Ls, rng = _factors(3, seed=13)
    bank = api.FactorBank(CPU, n, n0=8, capacity=2)
    bank.admit_stack(Ls[:2])
    server = api.SolveServer(api.Solver.from_bank(bank), 4)
    server.submit(np.zeros((n, 1), np.float32), factor=1)
    bank.evict(1)
    with pytest.raises(api.StrandedRequestError, match="evicted"):
        server.drain()
    assert bank.admit(Ls[2]) == 1 and bank.is_live(1)
    with pytest.raises(ValueError, match="evicted after submission"):
        server.drain()
    assert server.cancel(1) == 1
    assert server.cancel(1) == 0 and not server._req_gen
    r = rng.standard_normal((n, 2)).astype(np.float32)
    server.submit(r, factor=1)
    outs = server.drain()
    assert_close(outs[1][0], np.linalg.solve(Ls[2], r), 2e-5)
    assert not server._req_gen


def test_batched_trsm_session_shim():
    Ls, rng = _factors(2, seed=14)
    bank = _append_only(Ls, "inv")
    with pytest.warns(DeprecationWarning, match="Solver.from_bank"):
        sess = BatchedTrsmSession(bank)
    B = rng.standard_normal((2, 32, 3)).astype(np.float32)
    assert torch.equal(sess.warmup(3).solve(torch.as_tensor(B)),
                       _solve(bank, B))
    with pytest.raises(ValueError, match="rhs stack"):
        sess.solve(torch.zeros(32, 3))


@pytest.mark.parametrize("method", ["inv", "rec"])
def test_cli_bank_and_churn_workloads(method, capsys):
    """The trsm-bank and trsm-churn workloads on the CPU: the churn
    serves every request, re-admits into the victim's slot, and builds
    no program after its warmup."""
    common = ["--n", "32", "--n0", "8", "--bank", "4", "--panel-k", "4",
              "--device", "cpu", "--method", method]
    cli.main(["--workload", "trsm-bank", "--requests", "8", *common])
    cli.main(["--workload", "trsm-churn", "--requests", "24", "--updates",
              "6", "--precision", "bf16_refine", *common])
    out = capsys.readouterr().out
    assert "served 8 solve requests" in out and "against 4 factors" in out
    assert "served 24 solve requests" in out
    assert "(6 replaces, 2 evict+readmit)" in out
    assert "rebuilds solve=0 update=0" in out
    with pytest.raises(SystemExit):
        cli.main(["--workload", "trsm-churn", "--method", "auto",
                  "--device", "cpu"])
