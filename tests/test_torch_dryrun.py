"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

* ``--spec`` (dense and structured, each ``--overlap``) and ``--fleet``
  print the reference's methods, grids, n0, modeled times and bucket
  tables when both price with the TPU preset: both packages'
  ``tuning.default_machine`` patched to ``tpu_v5e()``, the reference's
  calibration to None and the port's nominal machine to the same
  preset.  The reference runs in a subprocess (its dry run forces 512
  host devices at import).
* One smoke LM cell per block family (dense, MoE, RG-LRU, xLSTM, the
  encoder-decoder, the embedded-input VLM) runs as rank 0 of the
  abstract production mesh at a small shape and writes its artifact;
  its counted flops are one device's step on that rank's rows (the
  port's design: storage sharded, compute whole), and another rank
  records the same collectives.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.core import comm
from repro_torch.core import cost_model as pcm
from repro_torch.core import tuning as ptuning
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.models import lm, whisper
from repro_torch.models import sharding as shard_rules
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.roofline import analysis

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OVERLAPS = ["auto", "on", "off"]
TRIPLES = [None, ["8192,16,4", "4096,64,16", "65536,256,256"]]
# (structure, overlap, triples): every overlap unstructured and banded;
# block-sparse once (its block mask is a Python loop over block pairs in
# both packages, seconds a plan)
VARIANTS = [(None, o, t) for o in OVERLAPS for t in (0, 1)] \
    + [(s, o, 0) for s in ("dense", "banded") for o in OVERLAPS] \
    + [("banded:64", "auto", 1), ("block-sparse", "off", 0)]

REFERENCE = r'''
import contextlib, io, json, sys
from repro.core import cost_model as cm, tuning
from repro.launch import dryrun
tuning.default_machine = lambda: cm.tpu_v5e()
tuning.calibration = lambda: None
variants, triples = json.loads(sys.argv[1])
out = {}
for structure, overlap, t in variants:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.run_spec_smoke(
            [tuple(int(x) for x in s.split(",")) for s in triples[t]]
            if triples[t] else dryrun.SPEC_REGIMES,
            structure=structure, overlap=overlap)
    out[f"{structure}|{overlap}|{t}"] = buf.getvalue()
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    dryrun.run_fleet_smoke()
out["fleet"] = buf.getvalue()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", REFERENCE,
                          json.dumps([VARIANTS, TRIPLES])],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture
def tpu_preset(monkeypatch):
    monkeypatch.setattr(ptuning, "default_machine", lambda: pcm.tpu_v5e())
    monkeypatch.setattr(ptuning, "calibration", lambda: None)
    monkeypatch.setattr(pcm, "h100", pcm.tpu_v5e)


def _lines(text):
    """The printed plan lines, the calibration note cut (the two
    packages name their calibration files)."""
    return [re.sub(r" calibrated=.*", "", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("structure,overlap,t", VARIANTS)
def test_spec_matches_reference(reference, tpu_preset, capsys, structure,
                                overlap, t):
    triples = TRIPLES[t] or []
    args = ["--spec", *triples, "--overlap", overlap]
    if structure:
        args += ["--structure", structure]
    assert dryrun.main(args) == 0
    got = capsys.readouterr().out
    want = reference[f"{structure}|{overlap}|{t}"]
    assert got.count("[spec]") == want.count("[spec]") > 0
    assert _lines(got) == _lines(want)


def test_fleet_matches_reference(reference, tpu_preset, capsys):
    assert dryrun.main(["--fleet"]) == 0
    assert capsys.readouterr().out == reference["fleet"]


def test_spec_says_no_port_calibration(capsys):
    """Without a port calibration the steady line prices the nominal H100
    machine and says there is no calibration."""
    assert ptuning.calibration() is None
    assert dryrun.main(["--spec"]) == 0
    out = capsys.readouterr().out
    assert "(machine: h100)" in out
    assert "calibrated=n/a (no port calibration)" in out


# ------------------------------ LM cells ------------------------------

SMALL = {"train_4k": ShapeConfig("train_4k", 64, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 32, "decode")}
FAMILY_CELLS = [("qwen3-1.7b", "train_4k"), ("grok-1-314b", "prefill_32k"),
                ("recurrentgemma-2b", "decode_32k"),
                ("xlstm-1.3b", "train_4k"), ("whisper-tiny", "decode_32k"),
                ("qwen2-vl-72b", "prefill_32k")]


def _one_device_flops(cfg, sh, rows, microbatches):
    """Flops of one device's step on ``rows`` of the batch, whole
    parameters (meta tensors)."""
    from repro_torch import optim
    from repro_torch.train import serve_step, train_step
    init = whisper.init if cfg.enc_dec else lm.init
    params = init(cfg, 0, device="meta")
    sub = ShapeConfig(sh.name, sh.seq_len, rows, sh.kind)
    batch = dryrun.input_specs(cfg, sub)
    if sh.kind == "train":
        opt = optim.get("adamw")
        step = train_step.make_train_step(cfg, opt,
                                          microbatches=microbatches)
        return analysis.counted_flops(step, params, opt.init(params), batch)
    if sh.kind == "prefill":
        def fn():
            if cfg.enc_dec:
                enc = whisper.encode(params, cfg, batch["frames"])
                return whisper.decode(params, cfg, batch["tokens"], enc,
                                      last_only=True)
            return lm.forward(params, cfg, batch.get("tokens"),
                              embeds=batch.get("embeds"), last_only=True)
        return analysis.counted_flops(fn)
    init_cache = whisper.init_cache if cfg.enc_dec else lm.init_cache
    cache = init_cache(cfg, rows, sh.seq_len, device="meta")
    args = [params, cache, batch["tokens"] if "tokens" in batch
            else torch.empty((rows, 1), dtype=torch.int32, device="meta")]
    if cfg.enc_dec:
        args.append(batch["enc_states"])
    elif cfg.embed_inputs:
        args.append(batch["embeds"])
    return analysis.counted_flops(serve_step.make_decode_fn(cfg), *args)


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_smoke_cell_writes_its_artifact(tmp_path, monkeypatch, capsys, arch,
                                        shape):
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    args = ["--arch", arch, "--shape", shape, "--mesh", "single", "--smoke",
            "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    path = tmp_path / f"{arch}__{shape}__single__smoke.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256, rec
    cfg, sh = configs.get_smoke(arch), SMALL[shape]
    # one device's step on this rank's rows (batch over "data")
    rows = sh.global_batch // 16
    mb = rec.get("microbatches", 16)
    assert rec["counted"]["flops_per_dev"] == _one_device_flops(
        cfg, sh, rows, mb // 16)
    assert rec["memory"]["params_bytes"] < cfg.param_count * 4
    assert rec["memory"]["temp_size_in_bytes"] == "not measured"
    assert rec["collectives"]["allgather"]["bytes"] > 0
    assert set(rec["roofline"]) >= {"t_compute", "t_memory",
                                    "t_collective", "roofline_fraction"}
    # a model-parallel peer records the same collectives
    other = dryrun.run_cell(arch, shape, "single", cfg=cfg, rank=37)
    assert other["traced"] == rec["traced"]
    assert other["collectives"] == rec["collectives"]
    # --skip-existing keeps the artifact; --tag writes another
    assert dryrun.main(args + ["--skip-existing"]) == 0
    assert "exists, skipping" in capsys.readouterr().out
    assert dryrun.main(args + ["--tag", "t1"]) == 0
    assert (tmp_path / f"{arch}__{shape}__single__smoke__t1.json").exists()


def test_train_cell_prices_its_fp32_gathers_and_reductions(monkeypatch):
    """A train cell's collective bytes are what its step moves: every
    fp32 parameter piece gathered whole (4 bytes a word, one gather per
    split dimension, each priced at the words it ends with) and every
    fp32 gradient all-reduced over "data" (2n words), the loss's too."""
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    cfg = configs.get_smoke("qwen3-1.7b")
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", "single", cfg=cfg)
    assert rec["status"] == "ok", rec
    mesh = comm.abstract_mesh(*PRODUCTION[False], rank=0)
    params = lm.init(cfg, 0, device="meta")
    assert {t.dtype for t in leaves(params)} == {torch.float32}
    shardings = shard_rules.named(
        shard_rules.param_specs(cfg, params, mesh), mesh)
    gathered = []

    def gather_bytes(t, sh):
        words = t.numel()
        split = shard_rules._split(sh.spec, t.ndim, ())
        for _, axes in split:
            words //= mesh.size(axes)
        for _, axes in split:
            words *= mesh.size(axes)
            if mesh.size(axes) > 1:
                gathered.append(words * 4)
    tree_map(gather_bytes, params, shardings)
    assert gathered
    n = sum(t.numel() for t in leaves(params))
    colls = rec["collectives"]
    assert colls["allgather"]["bytes"] == sum(gathered)
    assert colls["allgather"]["count"] == len(gathered)
    assert colls["allreduce"]["bytes"] == 2 * 4 * (n + 1)
    assert rec["counted"]["coll_bytes_per_dev"] == sum(
        v["bytes"] for v in colls.values())


def test_multi_pod_cell_and_skipped_shape(tmp_path, monkeypatch):
    """The 512-rank mesh splits the batch over ("pod", "data"); a
    full-attention arch skips the 500k decode, as in the reference."""
    monkeypatch.setattr(dryrun, "SHAPES", dict(
        SMALL, long_500k=ShapeConfig("long_500k", 64, 32, "decode")))
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", "multi",
                          cfg=configs.get_smoke("qwen3-1.7b"))
    assert rec["status"] == "ok" and rec["n_chips"] == 512
    assert rec["counted"]["flops_per_dev"] == _one_device_flops(
        configs.get_smoke("qwen3-1.7b"), SMALL["train_4k"], 1,
        rec["microbatches"] // 32)
    skip = dryrun.run_cell("qwen3-1.7b", "long_500k", "single",
                           cfg=configs.get_smoke("qwen3-1.7b"))
    assert skip["status"] == "skipped"
