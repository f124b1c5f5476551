"""The port's sharding rules (``repro_torch.models.sharding``,
``train.train_step.opt_state_specs``) against the reference's, leaf for
leaf, on every full config.

Meshes: the abstract production meshes (16, 16) and (2, 16, 16) and the
debug meshes (2, 2) and (2, 4), abstract on both sides.  Shapes: the
reference's from ``jax.eval_shape`` of its ``init`` (one a config,
shared through a module fixture), the port's from ``init`` on the meta
device.  A spec is compared as the tuple of its entries, exactly.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import abstract_mesh as jabstract_mesh
from repro.models import lm as jlm
from repro.models import sharding as jsr
from repro.models import whisper as jwhisper
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.core import comm
from repro_torch.models import lm, whisper
from repro_torch.models import sharding as sr
from repro_torch.optim.tree import leaves_with_path
from repro_torch.train import train_step as ts

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "debug22": ((2, 2), ("data", "model")),
          "debug24": ((2, 4), ("data", "model"))}
joptim = importlib.import_module("repro.optim")
optim = importlib.import_module("repro_torch.optim")
# the decode cache: decode_32k's batch at a short sequence (the specs
# depend on divisibility only) and an odd batch that _fit replicates
CACHE_SHAPES = ((128, 64), (3, 64))


def _meshes(name):
    shape, axes = MESHES[name]
    return jabstract_mesh(shape, axes), comm.abstract_mesh(shape, axes)


def _entries(spec) -> tuple:
    return tuple(spec)


def _same_specs(got, want):
    """A port spec tree against the reference's: same paths, entries."""
    g = [(p, _entries(s)) for p, s in leaves_with_path(got)]
    w = [(jax.tree_util.keystr(p), _entries(s))
         for p, s in jax.tree_util.tree_leaves_with_path(
             want, is_leaf=lambda x: isinstance(
                 x, jax.sharding.PartitionSpec))]
    assert [p for p, _ in g] == [p for p, _ in w]
    bad = [(p, a, b) for (p, a), (_, b) in zip(g, w) if a != b]
    assert not bad, bad[:5]


@pytest.fixture(scope="module")
def shapes():
    """{arch: (reference params, port params, reference cache shapes,
    port cache shapes)}: one eval_shape a config, computed once."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg, cfg = jconfigs.get(arch), configs.get(arch)
            jinit = jwhisper.init if jcfg.enc_dec else jlm.init
            init = whisper.init if cfg.enc_dec else lm.init
            jcache = jwhisper.init_cache if jcfg.enc_dec else jlm.init_cache
            cache = whisper.init_cache if cfg.enc_dec else lm.init_cache
            out[arch] = (
                jax.eval_shape(lambda: jinit(jcfg, jax.random.key(0))),
                init(cfg, device="meta"),
                [jax.eval_shape(lambda b=b, s=s: jcache(jcfg, b, s))
                 for b, s in CACHE_SHAPES],
                [cache(cfg, b, s, device="meta") for b, s in CACHE_SHAPES])
        return out[arch]
    return get


CASES = [(a, m) for a in configs.ARCH_IDS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_match_reference(shapes, arch, mesh):
    jparams, params = shapes(arch)[:2]
    jmesh, pmesh = _meshes(mesh)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for mode in ("2d", "fsdp_all"):
        _same_specs(sr.param_specs(cfg, params, pmesh, mode),
                    jsr.param_specs(jcfg, jparams, jmesh, mode))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_opt_state_specs_match_reference(shapes, arch, mesh):
    """adamw's and kfac_ca's states (kfac_ca's Kronecker factors up to
    its default max_dim 8192), each leaf inheriting its parameter's spec
    or replicated, as the reference's rule says."""
    jparams, params = shapes(arch)[:2]
    jmesh, pmesh = _meshes(mesh)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    pspecs = sr.param_specs(cfg, params, pmesh)
    jpspecs = jsr.param_specs(jcfg, jparams, jmesh)
    for name in ("adamw", "kfac_ca"):
        jstate = jax.eval_shape(joptim.get(name).init, jparams)
        state = optim.get(name).init(params)
        _same_specs(ts.opt_state_specs(state, params, pspecs),
                    jts.opt_state_specs(jstate, jparams, jpspecs))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_specs_match_reference(shapes, arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    cfg = configs.get(arch)
    for jcache, cache in zip(*shapes(arch)[2:]):
        _same_specs(sr.cache_specs(cfg, cache, pmesh),
                    jsr.cache_specs(jconfigs.get(arch), jcache, jmesh))


def _batch(cfg, B, S):
    shapes = {"tokens": (B, S), "labels": (B, S)}
    if cfg.embed_inputs:
        shapes = {"embeds": (B, S, cfg.d_model), "labels": (B, S)}
    if cfg.enc_dec:
        shapes["frames"] = (B, cfg.enc_frames, cfg.d_model)
    return ({k: jax.ShapeDtypeStruct(v, np.float32)
             for k, v in shapes.items()},
            {k: torch.empty(v, device="meta") for k, v in shapes.items()})


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-vl-72b",
                                  "whisper-tiny"])
def test_batch_specs_match_reference(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    cfg = configs.get(arch)
    for B, S in ((256, 4096), (2, 64), (3, 5)):
        jb, b = _batch(cfg, B, S)
        for mode in ("2d", "fsdp_all"):
            _same_specs(sr.batch_specs(b, pmesh, mode),
                        jsr.batch_specs(jb, jmesh, mode))


def test_ep_falls_back_to_tp_when_experts_do_not_divide(shapes):
    """grok's 8 experts on a 16-way model axis shard the expert FFN
    width over "model"; arctic's 128 keep EP on the expert dim."""
    jparams, params = shapes("grok-1-314b")[:2]
    _, pmesh = _meshes("single")
    spec = sr.param_specs(configs.get("grok-1-314b"), params, pmesh)
    assert _entries(spec["units"]["b0"]["moe"]["gate"]) == (
        None, None, "data", "model")
    assert _entries(spec["units"]["b0"]["moe"]["down"]) == (
        None, None, "model", "data")
    spec = sr.param_specs(configs.get("arctic-480b"),
                          shapes("arctic-480b")[1], pmesh)
    assert _entries(spec["units"]["b0"]["moe"]["gate"]) == (
        None, "model", "data", None)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fit_on_whisper_vocab(mesh):
    """``_fit`` on whisper-tiny's 51865-word vocabulary (odd: replicated
    on every mesh) and its padded 51968 rows (split where the axes
    divide it), as the reference's."""
    jmesh, pmesh = _meshes(mesh)
    cfg = configs.get("whisper-tiny")
    assert (cfg.vocab, cfg.vocab_padded) == (51865, 51968)
    for rows in (cfg.vocab, cfg.vocab_padded):
        for dims in (("model", None), (None, "model"), ("model", "data"),
                     (("data", "model"), None)):
            shape = (rows, cfg.d_model)
            got = _entries(sr._fit(pmesh, shape, dims))
            assert got == _entries(jsr._fit(jmesh, shape, dims)), dims
            if rows == cfg.vocab:
                assert got[0] is None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_shapes_tile_the_tensor(shapes, mesh):
    """Every rank's piece under qwen3-1.7b's specs: the pieces of every
    leaf are disjoint and cover it (ranks counted once a distinct
    piece)."""
    params = shapes("qwen3-1.7b")[1]
    dims, axes = MESHES[mesh]
    pmesh = comm.abstract_mesh(dims, axes)
    specs = sr.param_specs(configs.get("qwen3-1.7b"), params, pmesh)
    for (path, leaf), (_, spec) in zip(leaves_with_path(params),
                                       leaves_with_path(specs)):
        cover = set()
        for r in range(int(np.prod(dims))):
            pmesh.rank = r
            cut = sr.local_slices(leaf.shape, spec, pmesh)
            cover.add(tuple((s.start, s.stop) for s in cut))
        sizes = [np.prod([(b if b is not None else n) - (a or 0)
                          for (a, b), n in zip(c, leaf.shape)])
                 for c in cover]
        assert sum(sizes) == np.prod(leaf.shape), path
