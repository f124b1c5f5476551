"""The block-structure slice: ``repro_torch`` against ``repro`` on the CPU.

Every test feeds the same numpy inputs to both packages.  The analysis
(block masks, levels, spans, counts), ``parse``, validation and
``apply_block_mask`` must agree exactly; the structure-priced planner
too, for the same explicit machine (``cost_model.tpu_v5e()``; both
packages' ``default_machine`` is pinned to it, since ``serving_n0``
prices with the default machine in both).  The block-masked product's
plain version is held against the reference's Pallas kernel in
interpret mode at 2e-5 (fp32 sums in another order); structured
solves against the reference's at the preset tolerances of
tests/test_torch_solver.py (fp32 and bf16_refine 2e-5, bf16 2e-2,
relative and scaled to max|X|), the JAX side driven with
``block_inv=ops.block_inv_kernel`` (its default phase 1 fails on jax
0.9, ROADMAP C).  fp64_refine is held against scipy at the
reference's 1e-11 residual bound.
"""

import re
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from repro import api as japi
from repro.core import cost_model as jcm
from repro.core import structure as jstructure
from repro.core import tuning as jtuning
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.core import cost_model as cm
from repro_torch.core import inv_trsm, session, tuning
from repro_torch.core.structure import (FactorStructure, analyze,
                                        apply_block_mask)
from repro_torch.kernels import ref, trmm
from torch_parity import assert_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = api.make_trsm_mesh(1, 1, device="cpu")
JGRID = japi.make_trsm_mesh(1, 1)
TOL = {"fp32": 2e-5, "bf16": 2e-2, "bf16_refine": 2e-5}


def _random_mask(m, seed):
    rng = np.random.default_rng(seed)
    bm = np.tril(rng.random((m, m)) < 0.4)
    np.fill_diagonal(bm, True)
    return bm


# (kind, argument) pairs that build the same structure in both packages
STRUCTURES = [("banded", 1), ("banded", 8), ("banded", 40),
              ("block_sparse", _random_mask(8, 1)),
              ("block_sparse", _random_mask(4, 2)),
              ("parse", "block-sparse"), ("parse", "banded")]


def _both(kind, arg, n=None):
    """The same structure as (port's, reference's)."""
    if kind == "parse":
        return (FactorStructure.parse(arg, n=n),
                jstructure.FactorStructure.parse(arg, n=n))
    return (getattr(FactorStructure, kind)(arg),
            getattr(jstructure.FactorStructure, kind)(arg))


def _factor(n, seed=0):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    return L.astype(np.float32), rng


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _masked(L, st, n0):
    bm = st.block_mask(L.shape[-1], n0)
    return np.where(np.repeat(np.repeat(bm, n0, 0), n0, 1), L, 0.0)


# ------------------------------ analysis ------------------------------

@pytest.mark.parametrize("kind,arg", STRUCTURES)
@pytest.mark.parametrize("n,n0", [(64, 8), (64, 16), (64, 64), (128, 32),
                                  (256, 8)])
def test_analysis_matches_reference(kind, arg, n, n0):
    st, jst = _both(kind, arg, n)
    assert st.kind == jst.kind and st.bandwidth == jst.bandwidth \
        and st.mask == jst.mask
    np.testing.assert_array_equal(st.block_mask(n, n0),
                                  jst.block_mask(n, n0))
    assert st.nnz_blocks(n, n0) == jst.nnz_blocks(n, n0)
    info, jinfo = analyze(st, n, n0), jstructure.analyze(jst, n, n0)
    for f in ("n", "n0", "mask", "levels", "spans", "nnz_offdiag",
              "update_cols", "m", "n_levels"):
        assert getattr(info, f) == getattr(jinfo, f), f
    assert info.full == (info.nnz_offdiag == info.m * (info.m - 1) // 2)


def test_parse_hashing_and_validation_match_reference():
    for text, n in (("dense", None), ("banded:16", None), ("banded", 512),
                    ("Block-Sparse", None), ("block_sparse", None)):
        st = FactorStructure.parse(text, n=n)
        jst = jstructure.FactorStructure.parse(text, n=n)
        assert (st.kind, st.bandwidth, st.mask) \
            == (jst.kind, jst.bandwidth, jst.mask)
    m = np.tril(np.ones((4, 4), bool))
    assert FactorStructure.block_sparse(m) \
        == FactorStructure.block_sparse(m.tolist())
    assert hash(FactorStructure.dense()) == hash(FactorStructure("dense"))
    bad = [lambda F: F("diagonal"), lambda F: F.banded(0),
           lambda F: F("dense", bandwidth=4),
           lambda F: F.block_sparse(np.ones((2, 3), bool)),
           lambda F: F.banded(4).validate_for(64, lower=False),
           lambda F: F.banded(4).validate_for(64, transpose=True),
           lambda F: F.banded(64).validate_for(64),
           lambda F: F.block_sparse(np.eye(3, dtype=bool)).validate_for(64),
           lambda F: F.parse("banded"), lambda F: F.parse("butterfly")]
    for make in bad:
        with pytest.raises(ValueError) as jerr:
            make(jstructure.FactorStructure)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            make(FactorStructure)
    FactorStructure.dense().validate_for(64, lower=False, transpose=True)


def test_apply_block_mask_matches_reference_exactly():
    """torch.where, like the reference's jnp.where: NaN in a left-out
    block does not leak and -0.0 in a kept block keeps its sign, bit
    for bit; a stack is masked factor by factor; dense is a no-op that
    returns L itself."""
    rng = np.random.default_rng(4)
    bm = _random_mask(4, 3)
    st = FactorStructure.block_sparse(bm)
    jst = jstructure.FactorStructure.block_sparse(bm)
    elem = np.repeat(np.repeat(bm, 8, 0), 8, 1)
    L = rng.standard_normal((2, 32, 32)).astype(np.float32)
    L = np.where(elem | ~np.tri(32, dtype=bool), L, np.nan)
    assert np.isnan(L).any()
    L[:, 0, 0] = -0.0
    L[:, 5, 20] = np.inf                      # above the diagonal
    got = apply_block_mask(torch.from_numpy(L), st, 8).numpy()
    want = np.stack([np.asarray(jstructure.apply_block_mask(
        jnp.asarray(Li), jst, 8)) for Li in L])
    assert got.tobytes() == want.tobytes()
    assert np.signbit(got[:, 0, 0]).all() and not np.isnan(got).any()
    x = torch.from_numpy(L)
    assert apply_block_mask(x, FactorStructure.dense(), 8) is x


# ------------------------------ kernel B4 ------------------------------

def test_trmm_masked_plain_matches_reference_kernel():
    """The plain version of the block-masked product against
    ``repro.kernels.ops.trmm(block_mask=)`` in interpret mode, n = 128,
    bt = 32; NaN planted in the skipped tiles (and above the diagonal)
    reaches neither."""
    rng = np.random.default_rng(11)
    n, k, bt = 128, 64, 32
    mask = FactorStructure.banded(bt).block_mask(n, bt)
    elem = np.repeat(np.repeat(mask, bt, 0), bt, 1)
    L = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    X = rng.standard_normal((n, k)).astype(np.float32)
    poison = np.where(elem & np.tri(n, dtype=bool), L, np.nan)
    jmask = jnp.asarray(mask, jnp.int32)
    want = np.asarray(jops.trmm(jnp.asarray(np.where(elem, L, 0.0)),
                                jnp.asarray(X), bt=bt, bn=32))
    jpoison = np.asarray(jops.trmm(jnp.asarray(np.tril(poison)),
                                   jnp.asarray(X), bt=bt, bn=32,
                                   block_mask=jmask))
    np.testing.assert_array_equal(jpoison, want)
    tmask = torch.as_tensor(mask.astype(np.int32))
    got = trmm.trmm_masked_plain(torch.from_numpy(L), torch.from_numpy(X),
                                 tmask, bt)
    got_p = trmm.trmm(torch.from_numpy(poison), torch.from_numpy(X),
                      block_mask=tmask, bt=bt)
    assert got_p.numpy().tobytes() == got.numpy().tobytes()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())
    # the oracle, and the product without the mask's blocks is far away
    oracle = ref.trmm_masked_ref(torch.from_numpy(L).double(),
                                 torch.from_numpy(X).double(), tmask, bt)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())
    dense = np.tril(L).astype(np.float64) @ X
    assert np.abs(dense - want).max() > 100 * 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_trmm_masked_plain_batched_dtypes_and_no_launch(dtype):
    """Batches share one mask; the result has X's dtype with fp32
    (fp64) partial sums; on CPU tensors nothing is launched."""
    g = torch.Generator().manual_seed(5)
    b, n, k, bt = 3, 64, 5, 8
    L = torch.randn((b, n, n), generator=g).to(dtype)
    X = torch.randn((b, n, k), generator=g).to(dtype)
    mask = torch.as_tensor(_random_mask(n // bt, 6).astype(np.int32))
    launches = (trmm.trmm.launches, trmm.trmm_masked.launches)
    got = trmm.trmm_masked(L, X, mask, bt)
    assert got.dtype == dtype and got.shape == (b, n, k)
    want = ref.trmm_masked_ref(L.double(), X.double(), mask, bt)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.double(), want, rtol=tol,
                               atol=tol * want.abs().max().item())
    assert (trmm.trmm.launches, trmm.trmm_masked.launches) == launches


# ------------------------ structured solves ------------------------

@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16_refine"])
@pytest.mark.parametrize("kind,arg", [("banded", 8),
                                      ("block_sparse", _random_mask(8, 7))])
def test_structured_solver_matches_reference(precision, kind, arg):
    """Solver.from_factor(structure=) in both packages on a dense factor:
    admission masks it, so both solve against the masked operator."""
    n, k, n0 = 64, 8, 8
    L, rng = _factor(n, seed=8)
    B = rng.standard_normal((n, k)).astype(np.float32)
    st, jst = _both(kind, arg)
    kw = dict(method="inv", n0=n0, precision=precision)
    jsolver = japi.Solver.from_factor(L, JGRID, structure=jst,
                                      block_inv=jops.block_inv_kernel, **kw)
    solver = api.Solver.from_factor(L, CPU, structure=st, **kw)
    assert solver.spec_for(k).structure == st
    want = _np(jsolver.solve(B, donate=False))
    got = solver.solve(B)
    assert_close(got, want, TOL[precision])
    # against the masked operator, in float64
    Lm = _masked(L.astype(np.float64), st, n0)
    relres = np.linalg.norm(Lm @ got.double().numpy() - B) \
        / np.linalg.norm(B)
    assert relres < (1e-2 if precision == "bf16" else 1e-5), relres


def test_structured_rec_matches_reference():
    n, k, n0 = 64, 8, 16
    L, rng = _factor(n, seed=9)
    B = rng.standard_normal((n, k)).astype(np.float32)
    st, jst = _both("banded", 16)
    kw = dict(method="rec", n0=n0, precision="bf16_refine")
    jsolver = japi.Solver.from_factor(L, JGRID, structure=jst, **kw)
    solver = api.Solver.from_factor(L, CPU, structure=st, **kw)
    assert_close(solver.solve(B), _np(jsolver.solve(B, donate=False)),
                 TOL["bf16_refine"])


@pytest.mark.parametrize("method", ["inv", "rec"])
def test_structured_fp64_refine_against_scipy(method):
    n, k, n0 = 64, 4, 8
    L, rng = _factor(n, seed=10)
    L = L.astype(np.float64)
    B = rng.standard_normal((n, k))
    st = FactorStructure.parse("block-sparse")
    X = api.Solver.from_factor(L, CPU, method=method, n0=n0, structure=st,
                               precision="fp64_refine").solve(B)
    Lm = _masked(L, st, n0)
    want = scipy.linalg.solve_triangular(Lm, B, lower=True)
    relres = np.linalg.norm(Lm @ X.numpy() - B) / np.linalg.norm(B)
    assert X.dtype == torch.float64 and relres < 1e-11, relres
    np.testing.assert_allclose(X.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("precision", ["fp32", "bf16_refine",
                                       "fp64_refine"])
@pytest.mark.parametrize("method", ["inv", "rec"])
def test_full_mask_block_sparse_is_bitwise_dense(precision, method):
    """A structure that leaves out no block at n0 builds the dense
    program: X equal bit for bit, while the spec keeps its structure."""
    n, k, n0 = 64, 8, 16
    L, rng = _factor(n, seed=2)
    B = rng.standard_normal((n, k))
    m = n // n0
    full = FactorStructure.block_sparse(np.tril(np.ones((m, m), bool)))
    dense = api.Solver.from_factor(L, CPU, method=method, n0=n0,
                                   precision=precision)
    solver = api.Solver.from_factor(L, CPU, method=method, n0=n0,
                                    precision=precision, structure=full)
    assert solver.spec_for(k).structure == full
    assert solver.spec_for(k) != dense.spec_for(k)
    Xd, Xf = dense.solve(B), solver.solve(B)
    assert Xd.numpy().tobytes() == Xf.numpy().tobytes()


def test_dense_normalizes_to_the_unstructured_key():
    n, k = 64, 8
    L, rng = _factor(n, seed=3)
    B = rng.standard_normal((n, k)).astype(np.float32)
    cache = api.CompiledSolverCache()
    plain = api.Solver.from_factor(L, CPU, n0=16, precision="bf16_refine",
                                   cache=cache)
    X0 = plain.solve(B)
    spec = plain.spec_for(k)
    builds = session.BUILD_COUNTS[spec]
    dense = api.Solver.from_factor(L, CPU, n0=16, precision="bf16_refine",
                                   structure=FactorStructure.dense(),
                                   cache=cache)
    assert dense.spec_for(k) == spec and dense.spec_for(k).structure is None
    assert dense.solve(B).numpy().tobytes() == X0.numpy().tobytes()
    assert session.BUILD_COUNTS[spec] == builds and len(cache) == 1
    spec_d = api.SolveSpec.auto(n, k, p=1, hoisted=True,
                                structure=api.FactorStructure.dense())
    assert spec_d.structure is None
    assert spec_d == api.SolveSpec.auto(n, k, p=1, hoisted=True)


def test_structured_bank_rejects_cyclic_and_other_operators():
    st, jst = _both("banded", 4)
    L, _ = _factor(32)
    bank = api.FactorBank(CPU, 32, n0=8, structure=st)
    jbank = japi.FactorBank(JGRID, 32, n0=8, structure=jst)
    with pytest.raises(ValueError) as jerr:
        jbank.admit_cyclic(L)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        bank.admit_cyclic(L)
    for kw in (dict(lower=False), dict(transpose=True)):
        with pytest.raises(ValueError, match="lower=True"):
            japi.FactorBank(JGRID, 32, n0=8, structure=jst, **kw)
        with pytest.raises(ValueError, match="lower=True"):
            api.FactorBank(CPU, 32, n0=8, structure=st, **kw)
        with pytest.raises(ValueError, match="lower=True"):
            api.SolveSpec(n=32, k=4, grid=CPU, policy=api.PRESETS["fp32"],
                          n0=8, structure=st, **kw).validate()
    # an unstructured bank's cyclic ingestion is ported (capacity banks)
    assert api.FactorBank(CPU, 32, n0=8).admit_cyclic(L) == 0


def test_level_scheduled_sweep_runs_only_the_kept_updates(monkeypatch):
    """update_cols update GEMMs per sweep (a column without a dependent
    block issues none), one masked residual product per refinement
    pass, and NaN planted in the dropped blocks changes no bit of X."""
    n, k, n0 = 64, 4, 8
    L, rng = _factor(n, seed=12)
    B = rng.standard_normal((n, k)).astype(np.float32)
    st = FactorStructure.block_sparse(_random_mask(n // n0, 13))
    info = analyze(st, n, n0)
    assert info.update_cols < n // n0 - 1
    calls = {"update": 0, "residual": 0}
    real_mm, real_masked = inv_trsm.matmul_as, trmm.trmm_masked_plain

    def count_update(*a):
        calls["update"] += 1
        return real_mm(*a)

    def count_residual(*a):
        calls["residual"] += 1
        return real_masked(*a)

    monkeypatch.setattr(inv_trsm, "matmul_as", count_update)
    monkeypatch.setattr(trmm, "trmm_masked_plain", count_residual)
    solver = api.Solver.from_factor(L, CPU, n0=n0, structure=st,
                                    precision="bf16_refine")
    X = solver.solve(B)
    passes = solver.policy.refine_steps + 1
    assert calls == {"update": info.update_cols * passes,
                     "residual": solver.policy.refine_steps}
    elem = np.repeat(np.repeat(info.mask_array(), n0, 0), n0, 1)
    poisoned = np.where(elem | ~np.tri(n, dtype=bool), L, np.nan)
    Xp = api.Solver.from_factor(poisoned.astype(np.float32), CPU, n0=n0,
                                structure=st,
                                precision="bf16_refine").solve(B)
    assert Xp.numpy().tobytes() == X.numpy().tobytes()


# ------------------------------ planner ------------------------------

@pytest.fixture
def tpu_default(monkeypatch):
    """Both packages' default machine pinned to the TPU preset: the
    structured serving_n0 prices with it in both."""
    monkeypatch.setattr(jtuning, "default_machine", lambda: jcm.tpu_v5e())
    monkeypatch.setattr(tuning, "default_machine", lambda: cm.tpu_v5e())


def _c(c):
    return (c.s, c.w, c.f)


@pytest.mark.parametrize("kind,arg", STRUCTURES)
@pytest.mark.parametrize("n", [256, 1024])
def test_structured_planner_matches_reference(tpu_default, kind, arg, n):
    st, jst = _both(kind, arg, n)
    m, jm = cm.tpu_v5e(), jcm.tpu_v5e()
    for p1, p2 in ((1, 1), (2, 1), (2, 2)):
        g, jg = api.plan_grid(p1, p2), japi.plan_grid(p1, p2)
        n0 = tuning.serving_n0(n, g, structure=st)
        assert n0 == jtuning.serving_n0(n, jg, structure=jst)
        for k in (1, 16, 512):
            for ov in (False, True):
                c = cm.it_inv_trsm_steady_cost(n, k, n0, p1, p2,
                                               structure=st, overlap=ov)
                jc = jcm.it_inv_trsm_steady_cost(n, k, n0, p1, p2,
                                                 structure=jst,
                                                 overlap=ov)
                assert _c(c) == _c(jc) and c.time(m) == jc.time(jm)
            for model in ("paper", "tang2024"):
                assert _c(cm.rec_trsm_cost(n, k, p1 * p1 * p2, model,
                                           structure=st)) \
                    == _c(jcm.rec_trsm_cost(n, k, p1 * p1 * p2, model,
                                            structure=jst))
                assert tuning.choose_serving_method(
                    n, k, g, m, rec_model=model, structure=st) \
                    == jtuning.choose_serving_method(
                        n, k, jg, jm, rec_model=model, structure=jst)
            assert tuning.serving_steady_s(n, k, g, machine=m,
                                           structure=st) \
                == jtuning.serving_steady_s(n, k, jg, machine=jm,
                                            structure=jst)
        for kw in (dict(p=1), dict(p=16, bank_width=2),
                   dict(grid=(1, 1), hoisted=True),
                   dict(grid=(1, 1), method="inv", bank_width=1)):
            kw = dict(kw)
            grid = kw.pop("grid", None)
            got = api.SolveSpec.auto(
                n, 16, machine=m, structure=st,
                grid=api.plan_grid(*grid) if grid else None, **kw)
            want = japi.SolveSpec.auto(
                n, 16, machine=jm, structure=jst,
                grid=japi.plan_grid(*grid) if grid else None, **kw)
            assert (got.method, got.n0, got.grid.p1, got.grid.p2) \
                == (want.method, want.n0, want.grid.p1, want.grid.p2)
            assert got.structure == st


def test_h100_prices_the_executed_steps():
    """The H100 machine's launch term counts each step the structured
    sweep executes, m + update_cols, on top of the reference's alpha
    per step; the argmin is the brute-force minimum."""
    mach, g = cm.h100(), api.plan_grid(1, 1)
    n = 1024
    for text in ("banded", "block-sparse"):
        st = FactorStructure.parse(text, n=n)
        assert st.bandwidth in (None, 128)
        brute = []
        for n0 in (c for c in tuning._feasible_n0(n, 1, 1) if c <= n // 2):
            info = analyze(st, n, n0)
            steps = info.m + info.update_cols
            t = cm.it_inv_trsm_steady_cost(n, 16, n0, 1, 1, structure=st,
                                           overlap=True).time(mach)
            brute.append((t + (mach.alpha + mach.launch) * steps, -n0))
        assert tuning.serving_n0(n, g, structure=st) == -min(brute)[1]
        n0 = tuning.serving_n0(n, g, structure=st)
        info = analyze(st, n, n0)
        assert tuning.serving_steady_s(n, 16, g, structure=st) == \
            cm.it_inv_trsm_steady_cost(n, 16, n0, 1, 1, structure=st,
                                       overlap=True).time(mach) \
            + mach.launch * (info.m + info.update_cols)


# ------------------------------ front ends ------------------------------

def test_readme_structured_quickstart_runs_on_the_cpu():
    """The port's structured block in README.md, run as written (the
    p > 1 block, which starts a process group, runs in four processes in
    tests/test_torch_docs.py)."""
    text = (ROOT / "README.md").read_text()
    blocks = [b for b in re.findall(r"```python\n(.*?)```", text, re.S)
              if "from repro_torch import api" in b
              and "FactorStructure" in b
              and "init_process_group" not in b]
    assert len(blocks) == 1
    exec(compile(blocks[0], "README.md:repro_torch-structure", "exec"), {})


def test_serve_cli_structure_on_the_cpu(capsys):
    from repro_torch.launch import serve
    for text in ("banded:8", "block-sparse"):
        serve.main(["--workload", "trsm", "--n", "64", "--n0", "8",
                    "--requests", "4", "--precision", "bf16_refine",
                    "--device", "cpu", "--structure", text])
        out = capsys.readouterr().out
        assert "served 4 solve requests" in out and text in out
