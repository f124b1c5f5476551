"""The loops that drive the program, one module per ``loop`` of a
traffic file, and what they share: the program's entry points, the
statistics' streams and the sample of factors the check reads."""

from __future__ import annotations

import importlib

import numpy as np

# fixed stream numbers under the run's seed (statistics.generator)
STATS = 1            # the statistics the banks are built from
RHS = 10             # right-hand sides
SCHEDULE = 20        # the check's candidate slots (numpy)
SAMPLE = 21          # the slots and columns kept of each step (device)


def program():
    """The program's modules the loops call: the optimizer's banking
    (``kfac_ca``) and the core API."""
    from repro_torch import api
    kfac = importlib.import_module("repro_torch.optim.kfac_ca")
    return api, kfac


def grid(device: str):
    api, _ = program()
    return api.make_trsm_mesh(1, 1, device=device)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


def bank_kwargs(cfg: dict) -> dict:
    k = cfg["kfac"]
    return dict(damping=k["damping"], precision=k["precision"],
                method=k["method"], capacity=k["capacity"])


def candidates(manifest: dict, per_bank: int, gen) -> dict:
    """{bank: [slot, ...]}: the slots whose answers the check reads,
    ``per_bank`` of each bank drawn from the seed, one from each of
    ``per_bank`` equal runs of the bank's slots, so every part of the
    bank is read."""
    out = {}
    for key, tags in sorted(manifest.items()):
        edges = np.linspace(0, len(tags), min(per_bank, len(tags)) + 1)
        out[key] = sorted({int(gen.integers(int(a), max(int(a) + 1, int(b))))
                         for a, b in zip(edges[:-1], edges[1:])})
    return out


def columns(spec, pair: tuple, order: int) -> int:
    """A traffic file's column count for a factor of ``order`` banked
    from weights of shape ``pair`` (either way round): a number, or
    "gradient", the width of the gradient that K-FAC preconditions with
    that factor, which is the weight's other side."""
    if spec == "gradient":
        return sum(pair) - order
    return int(spec)


def solve_control(cfg: dict) -> None:
    """Switch on the configuration's lower-precision control of the
    solve: its float32 products in TF32, the step below the IEEE
    float32 that the configurations state."""
    import torch
    if cfg["control"]["solve"] != "tf32":
        raise ValueError(f"unknown solve control "
                         f"{cfg['control']['solve']!r}")
    torch.backends.cuda.matmul.allow_tf32 = True
