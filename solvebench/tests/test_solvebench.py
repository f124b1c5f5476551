"""Tests of the benchmark itself, on the CPU at tiny sizes (the program's
plain kernels), and of its controls on the card (marked ``gpu``).

    PYTHONPATH=src python -m pytest -q solvebench/tests
"""

from __future__ import annotations

import ast
import copy
import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from solvebench import harness, reference, roofline, statistics  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cfg: dict) -> dict:
    """The configuration at a size the CPU runs in seconds, with the
    same pattern of eligible weights (the MLP's sides over max_dim
    where the full configuration's are)."""
    cfg = copy.deepcopy(cfg)
    mlp = cfg["intermediate_size"] <= cfg["kfac"]["max_dim"]
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96 if mlp else 160, num_hidden_layers=2)
    cfg["kfac"] = dict(cfg["kfac"], max_dim=128)
    return cfg


def run_tiny(cell: str, *, seed: int = 3, seconds: float = 0.3,
             traffic_update=None, **kw) -> dict:
    bench, c, cfg, traffic = harness.load_cell(ROOT, cell)
    traffic = dict(traffic, **(traffic_update or {}))
    return harness.run_cell(bench, c, tiny(cfg), traffic, seed=seed,
                            seconds=seconds, trace=False, device="cpu",
                            t_start=time.monotonic(), **kw)


# ------------------------------ by name ------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    bench, c, cfg, traffic = harness.load_cell(ROOT, cell)
    assert cfg["name"] == c["config"]
    assert (ROOT / "solvebench" / "loops" / f"{traffic['loop']}.py").exists()
    for m in harness.metrics_for(bench, c, False) + \
            harness.metrics_for(bench, c, True):
        assert callable(harness.metric_reader(m["name"]))


def test_every_metric_file_has_a_reader():
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in BENCH[k]]
    assert sorted(p.stem for p in (ROOT / "solvebench" / "metrics")
                  .glob("*.py")) == sorted(names)


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix and a metric added as new files
    and entries of BENCHMARK.json run with no existing file edited."""
    shutil.copytree(ROOT / "solvebench", tmp_path / "solvebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = copy.deepcopy(BENCH)
    cfg = json.loads((ROOT / "solvebench/configs/smollm-360m-kfac.json")
                     .read_text())
    cfg = dict(tiny(cfg), name="tiny-kfac")
    (tmp_path / "solvebench/configs/tiny-kfac.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((ROOT / "solvebench/traffic/precondition.json")
                         .read_text())
    (tmp_path / "solvebench/traffic/narrow.json").write_text(
        json.dumps(dict(traffic, columns=4)))
    (tmp_path / "solvebench/metrics/steps_seen.py").write_text(
        "def read(ctx):\n    return ctx.get('steps')\n")
    bench["configs"].append({"name": "tiny-kfac", "source": "test",
                             "file": "solvebench/configs/tiny-kfac.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-kfac.narrow",
                               "config": "tiny-kfac", "traffic": "narrow",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_seen", "unit": "steps",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-kfac.narrow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b, c, cfg2, tr = harness.load_cell(tmp_path, "tiny-kfac.narrow")
    out = harness.run_cell(b, c, cfg2, tr, seed=5, seconds=0.2,
                           trace=False, device="cpu",
                           t_start=time.monotonic(), root=tmp_path)
    assert out["correct"], out
    assert set(out["metrics"]) == {"steps_seen", "setup_s"}
    assert out["metrics"]["steps_seen"]["value"] >= 1


# ------------------------------ the loops ------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    bench = harness.load_cell(ROOT, cell)[0]
    names = {m["name"] for m in bench["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())


def _broken_solve(kind):
    """A Solver.solve broken underneath the harness: the answer left as
    it came in, half of the batch left out, or every answer altered."""
    from repro_torch.core.solver import Solver
    sound = Solver.solve

    def solve(self, B, *, donate=True):
        if kind == "unchanged":
            return torch.as_tensor(B).clone()
        X = sound(self, B, donate=donate)
        if kind == "half":
            X = X.clone()
            X[X.shape[0] // 2:] = 0
            return X
        return X * (1 + 1e-2)
    return solve


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_solve_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core.solver import Solver
    monkeypatch.setattr(Solver, "solve", _broken_solve(fault))
    out = run_tiny(cell)
    assert not out["correct"], out


def test_window_waits_on_nothing_of_the_host(monkeypatch):
    """The timed step copies nothing from the host: its sample indices
    are drawn on the device."""
    from solvebench.loops import closed_solve
    window = closed_solve.Runner.window

    def guarded(self, prof):
        def refusing(make):
            def wrapped(data, *a, **kw):
                if not isinstance(data, torch.Tensor):
                    raise AssertionError(
                        f"a tensor made from host data in the window: "
                        f"{type(data).__name__}")
                return make(data, *a, **kw)
            return wrapped
        with monkeypatch.context() as m:
            m.setattr(torch, "as_tensor", refusing(torch.as_tensor))
            m.setattr(torch, "tensor", refusing(torch.tensor))
            return window(self, prof)
    monkeypatch.setattr(closed_solve.Runner, "window", guarded)
    assert run_tiny(CELLS[0])["correct"]


# ------------------------------ arithmetic ------------------------------

@pytest.mark.parametrize("config, banks", [
    ("granite-8b-kfac", {(4096, 4096): 4, (4096, 1024): 2,
                         (1024, 4096): 2}),
    ("smollm-360m-kfac", {(960, 960): 4, (960, 320): 2, (320, 960): 2,
                          (960, 2560): 3, (2560, 960): 3})])
def test_each_factor_takes_its_gradients_width(config, banks):
    """A layer's factors by (order, columns): a factor of order r of a
    weight (r, c) solves the c-wide gradient, one of order c the r-wide
    one, and a group of like-shaped weights banks one width per order."""
    from solvebench import loops
    cfg = harness.load_json(ROOT / "solvebench/configs" / f"{config}.json")
    traffic = harness.load_traffic(ROOT, "precondition")
    seen: dict = {}
    for pair, weights in statistics.weight_groups(cfg).items():
        for block, name in weights:
            shape = next(f(cfg) for b, n, f in statistics._WEIGHTS
                         if (b, n) == (block, name))
            for d, other in (shape, shape[::-1]):
                k = loops.columns(traffic["columns"], pair, d)
                assert k == other
                seen[(d, k)] = seen.get((d, k), 0) + 1
    assert seen == banks



def test_roofline_count_matches_a_hand_count():
    n, k = 4096, 4096
    assert roofline.solve_flops(n, k) == 4096 ** 3
    tri = 4096 * 4097 // 2 * 2
    assert roofline.solve_bytes(n, k) == tri + 2 * 4096 * 4096 * 4
    # 6.87e10 flops at 989 TFLOP/s (69.5 us) beat 1.68e8 bytes at 3.35 TB/s
    assert roofline.solve_bound_s(n, k) == pytest.approx(
        4096 ** 3 / 989e12)
    assert roofline.solve_bound_s(4096, 1) == pytest.approx(
        (tri + 2 * 4096 * 4) / 3.35e12)


def test_reference_agrees_with_a_float64_solve():
    g = torch.Generator().manual_seed(0)
    M = statistics.gram_stack(2, 48, g, samples=2, decay=1.0,
                              device="cpu")
    L = reference.factor64(M[0], 1e-3)
    Md = reference.damped(M[0].double(), 1e-3)
    assert torch.allclose(L @ L.T, Md, rtol=0, atol=1e-12 * Md.abs().max())
    B = torch.randn(48, 5, generator=g, dtype=torch.float64)
    X = torch.linalg.solve_triangular(L, B, upper=False)
    assert reference.relres(L, X, B).max() < 1e-14
    assert reference.relres(L, X * (1 + 1e-6), B).max() > 1e-7


def test_statistics_repeat_from_the_seed():
    cfg = tiny(json.loads((ROOT / "solvebench/configs/granite-8b-kfac.json")
                          .read_text()))
    a = statistics.make_state(cfg, 2**31 + 7, 1, "cpu")
    b = statistics.make_state(cfg, 2**31 + 7, 1, "cpu")
    c = statistics.make_state(cfg, 2**31 + 7, 2, "cpu")
    ia, ib, ic = (statistics.factor_index(s) for s in (a, b, c))
    assert ia.keys() == ib.keys() == ic.keys()
    assert all(torch.equal(ia[k], ib[k]) for k in ia)
    assert not any(torch.equal(ia[k], ic[k]) for k in ia)
    orders = [int(M.shape[-1]) for M in ia.values()]
    assert {d: orders.count(d) for d in set(orders)} == {64: 12, 32: 4}


# ------------------------------ no JAX ------------------------------

def _imported_tops(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = list((ROOT / "solvebench").rglob("*.py"))
    assert files
    for f in files:
        bad = _imported_tops(f) & set(harness.FORBIDDEN)
        assert not bad, f"{f}: imports {bad}"
    code = ("import sys; sys.path[:0] = ['.', 'src']; import importlib, "
            "pathlib; [importlib.import_module('solvebench.' + '.'.join("
            "p.with_suffix('').parts[1:])) for p in pathlib.Path("
            "'solvebench').rglob('*.py') if 'tests' not in p.parts and "
            "p.name != '__init__.py' and p.parent.name != 'metrics']; "
            "from solvebench import harness; "
            "[harness.metric_reader(p.stem) for p in "
            "pathlib.Path('solvebench/metrics').glob('*.py')]; "
            "import repro_torch.api, repro_torch.optim.kfac_ca; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------ on the card ------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 exists only there")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    """Each cell's lower-precision control (``run.py --control``), at two
    layers, fails the check where the program at the same size passes
    it; PERF.md has its readings at the cells' own sizes."""
    bench, c, cfg, traffic = harness.load_cell(ROOT, cell)
    cfg = dict(cfg, num_hidden_layers=2)
    runs = {}
    for control in (False, True):
        runs[control] = harness.run_cell(
            bench, c, cfg, traffic, seed=11, seconds=1.0, trace=False,
            device="cuda", t_start=time.monotonic(), control=control)
    assert runs[False]["correct"], runs[False]["checks"]
    assert not runs[True]["correct"], runs[True]["checks"]
