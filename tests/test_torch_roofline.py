"""The port's analysis layer against the JAX package's: the analytic
roofline model, the H100 roofline, the Sec. IX table, the calibration
fit and the cost-trace collectives.

The analytic model is host arithmetic: its counts (flops, HBM bytes,
collective bytes, model flops) must equal the reference's exactly for
every applicable arch x shape, and its times the reference's times the
ratio of the two machines' peaks.  ``FlopCounterMode`` on the port's
smoke forward (meta tensors) must lie within the reference's own
0.6-1.6 band of ``forward_flops`` for the reference's three archs; the
MoE configs' excess is accounted for term by term, not admitted by a
wider band.
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import cost_model as jcm
from repro.roofline import analysis as janalysis
from repro.roofline import model as jmodel
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.core import comm
from repro_torch.core import cost_model as cm
from repro_torch.models import lm
from repro_torch.roofline import analysis, model

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
CELLS = [(a, s) for a in configs.ARCH_IDS for s in configs.SHAPES
         if configs.shape_applicable(configs.get(a), configs.SHAPES[s])[0]]


def test_h100_peaks():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) \
        == (989e12, 3.35e12, 450e9)
    # the link is the one cost_model.h100 prices a word with
    assert cm.h100().beta == 4 / analysis.LINK_BW


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_model_matches_reference(arch, shape):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    sh, jsh = configs.SHAPES[shape], jconfigs.SHAPES[shape]
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len)
    assert model.forward_flops(cfg, sh, tokens) \
        == jmodel.forward_flops(jcfg, jsh, tokens)
    assert analysis.model_flops_for(cfg, sh) \
        == janalysis.model_flops_for(jcfg, jsh)
    ratios = {"t_compute": janalysis.PEAK_FLOPS / analysis.PEAK_FLOPS,
              "t_memory": janalysis.HBM_BW / analysis.HBM_BW,
              "t_collective": janalysis.ICI_BW / analysis.LINK_BW}
    for mesh in MESHES:
        for mb, kv in ((1, 2.0), (4, 1.03)):
            got = model.cell_model(cfg, sh, mesh, microbatches=mb,
                                   kv_bytes=kv)
            want = jmodel.cell_model(jcfg, jsh, mesh, microbatches=mb,
                                     kv_bytes=kv)
            for key in ("flops", "hbm_bytes", "coll_bytes", "model_flops",
                        "chips", "useful_ratio"):
                assert getattr(got, key) == getattr(want, key), key
            for key, r in ratios.items():
                assert getattr(got, key) == pytest.approx(
                    getattr(want, key) * r, rel=1e-12), key


def test_roofline_terms_use_the_h100_peaks():
    r = analysis.Roofline(2e12, 3e9, 4e8, 256, model_flops=1e14)
    jr = janalysis.Roofline(2e12, 3e9, 4e8, 256, model_flops=1e14)
    assert r.t_compute == pytest.approx(jr.t_compute * 197e12 / 989e12)
    assert r.t_memory == pytest.approx(jr.t_memory * 819e9 / 3.35e12)
    assert r.t_collective == pytest.approx(jr.t_collective * 50e9 / 450e9)
    assert r.useful_flops_ratio == jr.useful_flops_ratio
    d = r.to_dict()
    assert d["bottleneck"] == max(("compute", "memory", "collective"),
                                  key=lambda k: d["t_" + k])
    assert r.roofline_fraction == pytest.approx(
        1e14 / 256 / max(r.t_compute, r.t_memory, r.t_collective) / 989e12)


def _smoke_forward_flops(arch, B=2, S=128):
    cfg = configs.get_smoke(arch)
    params = lm.init(cfg, 0, device="meta")
    tokens = torch.zeros((B, S), dtype=torch.int64, device="meta")
    got = analysis.counted_flops(
        lambda: lm.forward(params, cfg, tokens, dtype=torch.float32))
    return cfg, got, model.forward_flops(cfg, ShapeConfig("t", S, B,
                                                           "prefill"), B * S)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-8b", "xlstm-1.3b"])
def test_counted_flops_match_the_analytic_model(arch):
    """The reference's band (tests/test_roofline.py): matmul-dominated
    accounting, elementwise work uncounted, attention's causal average
    against the full score matrix the forward forms."""
    _, got, want = _smoke_forward_flops(arch)
    assert 0.6 * want < got < 1.6 * want, (arch, got / want)


@pytest.mark.parametrize("arch,ratio", [("grok-1-314b", 2.311),
                                        ("arctic-480b", 2.176)])
def test_moe_counted_flops_excess_is_dispatch_and_capacity(arch, ratio):
    """The MoE forward counts 2.31x (grok) and 2.18x (arctic) the
    analytic flops at smoke size: ``forward_flops`` prices topk experts
    a token, while ``moe_apply`` runs every expert on its capacity of
    capacity_factor * topk * T / e slots (1.25x the routed tokens) and
    forms dispatch and combine as dense one-hot einsums over (T, e,
    cap), 2 T e cap d flops each.  Take those two terms out and the
    rest lies in the band."""
    cfg, got, want = _smoke_forward_flops(arch)
    assert got / want == pytest.approx(ratio, abs=1e-3)
    T = 2 * 128
    e, k, d, f = cfg.n_experts, cfg.topk, cfg.d_model, cfg.moe_d_ff
    cap = int(cfg.moe_capacity * k * T / e)
    layers = model._block_counts(cfg)["attn"]
    capacity = (e * cap - k * T) * 2 * 3 * d * f * layers
    dispatch = 2 * (2 * T * e * cap * d) * layers
    rest = got - capacity - dispatch
    assert 0.6 * want < rest < 1.6 * want, (arch, rest / want)


@pytest.mark.parametrize("n,k,p", [(64, 4096, 64), (1 << 20, 64, 64),
                                   (1 << 14, 1 << 10, 512),
                                   (1 << 16, 1 << 10, 512), (512, 512, 1)])
def test_paper_table_row_matches_reference(n, k, p):
    assert cm.paper_table_row(n, k, p) == jcm.paper_table_row(n, k, p)


def test_paper_table_covers_every_regime():
    regimes = {cm.paper_table_row(n, k, 512)["regime"]
               for n, k in ((64, 1 << 16), (1 << 12, 1 << 10),
                            (1 << 19, 1 << 10))}
    assert regimes == {"1D", "2D", "3D"}


def test_tpu_v5e_dcn_matches_reference():
    for b in (2, 4):
        m, jm = cm.tpu_v5e_dcn(b), jcm.tpu_v5e_dcn(b)
        assert (m.name, m.alpha, m.beta, m.gamma, m.launch) \
            == (jm.name, jm.alpha, jm.beta, jm.gamma, 0.0)


def test_fit_calibration_recovers_synthetic_scales():
    base = cm.h100()
    truth = cm.Calibration(a=3.0, b=0.5, g=2.0)
    tm = truth.apply(base)
    assert tm.launch == base.launch and tm.name == "h100+cal"
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(12):
        s = float(rng.uniform(10, 1e4))
        w = float(rng.uniform(1e4, 1e8))
        f = float(rng.uniform(1e6, 1e12))
        c = cm.Cost(s=s, w=w, f=f)
        rows.append(dict(s=s, w=w, f=f, measured_s=c.time(tm),
                         predicted_s=c.time(base)))
    cal = cm.fit_calibration(rows, base, dispatch_s=1e-5)
    jcal = jcm.fit_calibration(rows, jcm.Machine(
        base.name, base.alpha, base.beta, base.gamma), dispatch_s=1e-5)
    assert (cal.a, cal.b, cal.g, cal.dispatch_s) \
        == (jcal.a, jcal.b, jcal.g, jcal.dispatch_s)
    assert cal.a == pytest.approx(truth.a, rel=1e-6)
    assert cal.b == pytest.approx(truth.b, rel=1e-6)
    assert cal.g == pytest.approx(truth.g, rel=1e-6)
    calm = cal.apply(base)
    err0 = np.median([abs(r["predicted_s"] - r["measured_s"])
                      / r["measured_s"] for r in rows])
    err1 = np.median([abs(cm.Cost(r["s"], r["w"], r["f"]).time(calm)
                          - r["measured_s"]) / r["measured_s"]
                      for r in rows])
    assert err1 * 2 <= err0


def test_load_calibration_roundtrip(tmp_path):
    # loads are cached per path: missing and corrupt files on their own
    assert cm.load_calibration(tmp_path / "absent.json") is None
    p = tmp_path / "h100_calibration.json"
    p.write_text(json.dumps(dict(calibration=dict(
        a=1.5, b=0.8, g=1.1, dispatch_s=2e-5))))
    assert cm.load_calibration(p) == cm.Calibration(
        a=1.5, b=0.8, g=1.1, dispatch_s=2e-5)
    junk = tmp_path / "junk.json"
    junk.write_text("{not json")
    assert cm.load_calibration(junk) is None
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"calibration": None}))
    assert cm.load_calibration(empty) is None
    # the default path is the port's own, never the reference's file
    assert cm.CALIBRATION_PATH.parent == pathlib.Path(cm.__file__).parent
    assert "BENCH_overlap" not in str(cm.CALIBRATION_PATH)


def test_collectives_from_trace():
    # each record's words at its own operand's element size
    t = comm.CostTrace([
        comm.Record("allgather", "x", 4, 64, 2, 64, 0, 1.0, itemsize=4),
        comm.Record("allgather", "y", 4, 32, 2, 32, 0, 3.0, itemsize=2),
        comm.Record("allreduce", "z", 2, 10, 2, 20, 10, 1.0, itemsize=4),
        comm.Record("permute", "x", 1, 8, 1, 8, 0, 2.0, itemsize=8)])
    want = {"allgather": {"bytes": 64 * 4 + 96 * 2, "count": 4.0},
            "allreduce": {"bytes": 80, "count": 1.0},
            "permute": {"bytes": 128, "count": 2.0}}
    assert analysis.collectives_from_trace(t) == want
    roof, colls = analysis.from_counts(1e9, 2e6, t, 4, 5e8)
    assert colls == want
    assert roof.coll_bytes_per_dev == 448 + 80 + 128
    assert roof.flops_per_dev == 1e9 and roof.useful_flops_ratio == 5e8 / 4e9


NEW_FILES = ["src/repro_torch/roofline/analysis.py",
             "src/repro_torch/roofline/model.py",
             "src/repro_torch/launch/dryrun.py",
             "src/repro_torch/core/comm.py",
             "src/repro_torch/core/cost_model.py",
             "src/repro_torch/core/tuning.py",
             "experiments/torch_trsm_scale_dryrun.py",
             "examples/torch_quickstart.py", "examples/torch_trsm_demo.py",
             "examples/torch_serve_lm.py", "examples/torch_train_lm.py"]


@pytest.mark.parametrize("path", NEW_FILES)
def test_imports_neither_jax_nor_the_reference(path):
    text = (pathlib.Path(__file__).parent.parent / path).read_text()
    bad = re.findall(r"^\s*(?:from|import)\s+(jax|repro)\b", text,
                     flags=re.M)
    assert not bad, (path, bad)
