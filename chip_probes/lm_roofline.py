#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py`` phase 19 (a)'s two roofline
steps goes: qwen3-1.7b at its published width, 28 layers, bf16 weights
on one card, the prefill (batch 1, a 4096-token prompt, the last
position's logits) and a decode step (batch 4 against a 32768-position
cache).  Each step is timed under CUDA events as phase 19 times it
(``chip_smoke.roofline_run``: counted flops, the analytic bound, the
measured share), then run once more under torch.profiler (device
activity): device ms, the busy share of its wall time and the top
kernels.  One JSON line a step.

    PYTHONPATH=src python3 chip_probes/lm_roofline.py
"""

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "chip_probes")]
import chip_smoke  # noqa: E402
from lm_train import profile_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.tree import tree_map  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_roofline: needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    cfg = configs.get(chip_smoke.LM_ARCH)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.ROOF_SEED)
    bf16 = torch.bfloat16
    params = tree_map(lambda t: t.to(bf16), lm.init(cfg, g, device=dev))
    torch.cuda.empty_cache()
    B, S = chip_smoke.ROOF_PREFILL
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    Bd, C = chip_smoke.ROOF_DECODE
    cache = lm.init_cache(cfg, Bd, C, dtype=bf16, device=dev)
    tok = torch.zeros((Bd, 1), dtype=torch.long, device=dev)
    for what, fn, sh, need in (
            ("prefill", lambda: lm.forward(params, cfg, tokens, dtype=bf16,
                                           last_only=True),
             ShapeConfig("prefill", S, B, "prefill"),
             chip_smoke.step_bytes(params)),
            ("decode", lambda: lm.decode_step(params, cfg, tok, cache,
                                              dtype=bf16),
             ShapeConfig("decode", C, Bd, "decode"),
             chip_smoke.step_bytes(params, cache, C))):
        rec = chip_smoke.roofline_run(what, fn, cfg, sh, card, need)
        rec["profile"] = profile_step(fn)
        print(json.dumps({"lm_roofline": rec}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
