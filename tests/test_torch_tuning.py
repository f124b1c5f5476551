"""The port's cost model and planner against the JAX package's.

Both are host arithmetic, so for the same explicit machine every cost,
plan and spec must agree EXACTLY over a small grid of (n, k, p).  The
port's default machine is the H100 preset and never the reference's
calibrated TPU machine.  The structure-priced planner is held against
the reference in tests/test_torch_structure.py.
"""

import dataclasses
import itertools

import pytest

from repro import api as japi
from repro.core import cost_model as jcm
from repro.core import tuning as jtuning
from repro_torch import api
from repro_torch.core import cost_model as cm
from repro_torch.core import tuning

NKP = list(itertools.product((256, 1024, 8192), (1, 16, 512), (1, 8, 64)))
GRIDS = [(1, 1), (2, 1), (1, 4), (2, 2), (4, 4)]


def _c(c):
    return (c.s, c.w, c.f)


# the reference's cross-pod preset (tpu_v5e_dcn): a high-alpha machine,
# spelt out on both sides since the port carries only the presets it plans
# with
_DCN = ("dcn", 5e-5, 2 / 25e9, 1 / 197e12)


def _dcn():
    return cm.Machine(*_DCN), jcm.Machine(*_DCN)


def _machines():
    return [(cm.tpu_v5e(), jcm.tpu_v5e()), _dcn(),
            (cm.tpu_v5e(4), jcm.tpu_v5e(4))]


def test_machines_and_collectives_match_reference():
    for m, jm in _machines():
        assert (m.name, m.alpha, m.beta, m.gamma) \
            == dataclasses.astuple(jm)
        assert m.launch == 0.0            # the reference has no launch term
    for name in ("allgather", "scatter", "gather", "reduce_scatter",
                 "alltoall", "reduction", "allreduction", "bcast"):
        for n, p in ((1e6, 1), (1e6, 8), (3e3, 64)):
            assert _c(getattr(cm, name)(n, p)) \
                == _c(getattr(jcm, name)(n, p))


@pytest.mark.parametrize("n,k,p", NKP)
def test_closed_forms_match_reference(n, k, p):
    p1 = 2 if p >= 8 else 1
    p2 = p // (p1 * p1)
    n0 = n // 4
    for m, jm in _machines():
        pairs = [
            (cm.rec_trsm_cost(n, k, p), jcm.rec_trsm_cost(n, k, p)),
            (cm.rec_trsm_cost(n, k, p, model="tang2024"),
             jcm.rec_trsm_cost(n, k, p, model="tang2024")),
            (cm.tri_inv_cost(n, p1, p2), jcm.tri_inv_cost(n, p1, p2)),
            (cm.inv_phase_cost(n, n0, 1, 2, p),
             jcm.inv_phase_cost(n, n0, 1, 2, p)),
            (cm.it_inv_trsm_cost(n, k, n0, p1, p2, 1, 1),
             jcm.it_inv_trsm_cost(n, k, n0, p1, p2, 1, 1))]
        for overlap in (False, True):
            pairs += [
                (cm.solve_phase_cost(n, k, n0, p1, p2, overlap=overlap),
                 jcm.solve_phase_cost(n, k, n0, p1, p2, overlap=overlap)),
                (cm.update_phase_cost(n, k, n0, p1, p2, overlap=overlap),
                 jcm.update_phase_cost(n, k, n0, p1, p2, overlap=overlap)),
                (cm.it_inv_trsm_steady_cost(n, k, n0, p1, p2,
                                            overlap=overlap),
                 jcm.it_inv_trsm_steady_cost(n, k, n0, p1, p2,
                                             overlap=overlap))]
        for got, want in pairs:
            assert _c(got) == _c(want)
            assert got.time(m) == want.time(jm)


@pytest.mark.parametrize("n,k,p", NKP)
def test_mm_costs_match_reference(n, k, p):
    """The 3D product's closed forms: the paper's line by line, the
    schedule ``core.mm3d`` runs (square and with m rows), and the
    optimal bandwidth they are held to."""
    for p1 in (1, 2, 4):
        if p % (p1 * p1):
            continue
        p2 = p // (p1 * p1)
        assert _c(cm.mm_cost_paper(n, k, p, p1, p2)) \
            == _c(jcm.mm_cost_paper(n, k, p, p1, p2))
        for m in (None, n // 2):
            assert _c(cm.mm_cost(n, k, p, p1, p2, m=m)) \
                == _c(jcm.mm_cost(n, k, p, p1, p2, m=m))
    assert cm.w_mm_optimal(n, k, p) == jcm.w_mm_optimal(n, k, p)


@pytest.mark.parametrize("n,k,p", NKP)
def test_tuner_matches_reference(n, k, p):
    m, jm = cm.tpu_v5e(), jcm.tpu_v5e()
    assert tuning.regime(n, k, p) == jtuning.regime(n, k, p)
    assert tuning.ideal_params(n, k, p) == jtuning.ideal_params(n, k, p)
    assert tuning.feasible_grids(p) == jtuning.feasible_grids(p)
    assert tuning._inv_subgrid(n, n // 8, p) \
        == jtuning._inv_subgrid(n, n // 8, p)
    assert dataclasses.asdict(tuning.tune(n, k, p, m)) \
        == dataclasses.asdict(jtuning.tune(n, k, p, jm))
    method, plan, times = tuning.choose_method(n, k, p, m)
    jmethod, jplan, jtimes = jtuning.choose_method(n, k, p, jm)
    assert (method, dataclasses.asdict(plan), times) \
        == (jmethod, dataclasses.asdict(jplan), jtimes)


@pytest.mark.parametrize("p1,p2", GRIDS)
@pytest.mark.parametrize("n,k", [(256, 16), (8192, 16), (1024, 1024)])
def test_grid_planners_match_reference(p1, p2, n, k):
    m, jm = cm.tpu_v5e(), jcm.tpu_v5e()
    g, jg = api.plan_grid(p1, p2), japi.plan_grid(p1, p2)
    assert dataclasses.asdict(tuning.tune_for_grid(n, k, g, m)) \
        == dataclasses.asdict(jtuning.tune_for_grid(n, k, jg, jm))
    assert tuning.serving_n0(n, g) == jtuning.serving_n0(n, jg)
    assert tuning.serving_steady_s(n, k, g, machine=m) \
        == jtuning.serving_steady_s(n, k, jg, machine=jm)
    for rec_model in ("paper", "tang2024"):
        assert tuning.choose_serving_method(n, k, g, m, rec_model=rec_model) \
            == jtuning.choose_serving_method(n, k, jg, jm,
                                             rec_model=rec_model)
    for method, hoisted, n0 in itertools.product(
            ("inv", "rec", "auto"), (False, True), (None, n // 4)):
        assert api.resolve_plan(g, n, k, method=method, n0=n0, machine=m,
                                hoisted=hoisted) \
            == japi.resolve_plan(jg, n, k, method=method, n0=n0,
                                 machine=jm, hoisted=hoisted)


def _plan_fields(spec):
    return (spec.n, spec.k, spec.method, spec.n0, spec.grid.p1,
            spec.grid.p2, spec.bank_width, spec.map_mode, spec.overlap,
            spec.lower, spec.transpose)


@pytest.mark.parametrize("n,k", [(256, 16), (8192, 16), (4096, 4096)])
@pytest.mark.parametrize("kw", [dict(p=1), dict(p=8), dict(p=64),
                                dict(p=64, method="rec"),
                                dict(p=16, bank_width=4),
                                dict(grid=(1, 1)), dict(grid=(2, 2)),
                                dict(grid=(1, 1), bank_width=2,
                                     lower=False)])
def test_solve_spec_auto_matches_reference(n, k, kw):
    kw = dict(kw)
    grid = kw.pop("grid", None)
    got = api.SolveSpec.auto(
        n, k, machine=cm.tpu_v5e(),
        grid=api.plan_grid(*grid) if grid else None, **kw)
    want = japi.SolveSpec.auto(
        n, k, machine=jcm.tpu_v5e(),
        grid=japi.plan_grid(*grid) if grid else None, **kw)
    assert _plan_fields(got) == _plan_fields(want)
    assert got.grid.device is None and not got.is_concrete


def test_auto_on_a_mesh_resolves_and_runs_like_the_reference():
    """SolveSpec.auto and Solver.from_factor(method="auto") on the CPU
    grid resolve the reference's plan for the same machine."""
    import numpy as np
    n = 64
    cpu = api.make_trsm_mesh(1, 1, device="cpu")
    jgrid = japi.make_trsm_mesh(1, 1)
    spec = api.SolveSpec.auto(n, 16, grid=cpu, machine=cm.tpu_v5e())
    jspec = japi.SolveSpec.auto(n, 16, grid=jgrid, machine=jcm.tpu_v5e())
    assert (spec.method, spec.n0) == (jspec.method, jspec.n0)
    L = (np.tril(np.random.default_rng(0).standard_normal((n, n)))
         + n * np.eye(n)).astype(np.float32)
    for machine, jmachine in ((cm.tpu_v5e(), jcm.tpu_v5e()),
                              _dcn()):
        solver = api.Solver.from_factor(L, cpu, method="auto",
                                        machine=machine, k_hint=16)
        want = japi.resolve_plan(jgrid, n, 16, method="auto",
                                 machine=jmachine, hoisted=True)
        assert (solver.method, solver.n0) == want
        X = solver.solve(np.ones((n, 2), np.float32))
        np.testing.assert_allclose(L @ X.numpy(), np.ones((n, 2)),
                                   atol=1e-4)
    banked = api.Solver.from_factors(L[None], cpu, method="auto",
                                     machine=cm.tpu_v5e())
    assert (banked.method, banked.n0) == japi.resolve_plan(
        jgrid, n, n, method="auto", machine=jcm.tpu_v5e(), hoisted=True)


def test_default_machine_is_the_h100_and_reads_no_calibration():
    m = tuning.default_machine()
    assert m == cm.h100() and m.name == "h100"
    assert (m.gamma, m.beta) == (1 / 67e12, 4 / 450e9)
    # nothing of the reference's calibration path is ported
    for name in ("load_calibration", "_default_calibration_path"):
        assert not hasattr(cm, name)
    assert not hasattr(tuning, "calibration")
    assert tuning.choose_method(8192, 16, 1) \
        == tuning.choose_method(8192, 16, 1, cm.h100())
    assert tuning.tuning_table(4096, 16, 8)["plan"] \
        == dataclasses.asdict(tuning.tune(4096, 16, 8, cm.h100()))
    g = api.plan_grid(1, 1)
    assert api.resolve_plan(g, 8192, 16, method="auto", hoisted=True) \
        == ("inv", 4096)


@pytest.mark.parametrize("n", [256, 1024, 8192])
def test_h100_launch_term_prices_the_steps(n):
    """At p = 1 every message count is lg 1 = 0, so without a launch term
    the one-shot It-Inv argmin is n0 = 1 (n dependent steps).  The H100
    preset adds one launch per step, and the argmin is the brute-force
    minimum of cost + steps over the feasible block sizes."""
    m, g = cm.h100(), api.plan_grid(1, 1)
    assert m.launch == 5e-6
    assert tuning.steps_s(m, n, n // 4) == 4 * 5e-6
    plan = tuning.tune_for_grid(n, 16, g, m)
    brute = min((cm.it_inv_trsm_cost(n, 16, n0, 1, 1, 1, 1).time(m)
                 + m.launch * n / n0, n0) for n0 in tuning._feasible_n0(
                     n, 1, 1))
    assert plan.n0 == brute[1] > 1
    no_launch = dataclasses.replace(m, launch=0.0)
    assert tuning.tune_for_grid(n, 16, g, no_launch).n0 == 1
    method, _, times = tuning.choose_method(n, 16, 1, m)
    assert times["rec"] == cm.rec_trsm_cost(n, 16, 1).time(m) + m.launch
    assert api.resolve_plan(g, n, 16, method="auto") \
        == ((method, plan.n0) if method == "inv" else ("rec", n))


def test_h100_plans_at_the_path_shape():
    """The plans the card's runs resolve at n = 8192, k = 16, p = 1."""
    g = api.plan_grid(1, 1)
    assert api.resolve_plan(g, 8192, 16, method="inv") == ("inv", 512)
    assert api.resolve_plan(g, 8192, 16, method="auto") == ("rec", 8192)
    assert api.resolve_plan(g, 8192, 16, method="auto", hoisted=True) \
        == ("inv", 4096)
    spec = api.SolveSpec.auto(8192, 16, grid=g)
    assert (spec.method, spec.n0) == ("rec", 8192)


def test_structures_and_plan_grids_are_out_of_scope():
    """Structures are priced now (the structure slice): a banded factor
    costs less than a dense one and resolves a plan, dense prices as no
    structure at all; plan grids still cannot run a program."""
    banded = api.FactorStructure.banded(2)
    g = api.plan_grid(1, 1)
    assert cm.rec_trsm_cost(256, 16, 1, structure=banded).f \
        < cm.rec_trsm_cost(256, 16, 1).f
    assert tuning.choose_serving_method(256, 16, g, structure=banded)[0] \
        in ("inv", "rec")
    assert api.resolve_plan(g, 256, 16, method="auto",
                            structure=banded)[0] in ("inv", "rec")
    assert cm.update_phase_cost(256, 16, 64, 1, 1,
                                structure=api.FactorStructure.dense()) \
        == cm.update_phase_cost(256, 16, 64, 1, 1)
    spec = api.SolveSpec.auto(256, 16, p=64)
    with pytest.raises(ValueError, match="concrete"):
        api.solver_for(spec)
    with pytest.raises(ValueError, match="plan-only"):
        api.FactorBank(spec.grid, 256)
    with pytest.raises(ValueError, match="auto"):
        api.SolveSpec(n=256, k=16, grid=g, policy=api.PRESETS["fp32"],
                      method="auto")
    with pytest.raises(ValueError, match="SolveSpec.auto needs"):
        api.SolveSpec.auto(256, 16)
