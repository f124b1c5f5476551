#!/usr/bin/env python3
"""Kernel B5 (``tri_inv_blocks(valid=)``) at ``chip_smoke.py`` phase 2's
main case, (2, 4096, 4096) fp32, under each mask of two blocks, beside
B1 on the same stack and B1 on its first block alone.

    python3 chip_probes/b5_masks.py

Five measurements each, one after another, every one the CUDA-event
median of 10 runs with the L2 flushed before each
(``chip_smoke.Timer``); blocks tril(randn) + n0 I from seed 0, as phase
2's.  Prints the card's name, power limit, SM clock and temperature,
then one JSON line per mask and one for B1 on one block.  It tells a
slow reading of one call from the kernel's own cost under a mask: phase
2 times the mask [1, 0] once, with 5 runs.
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, tri_inv_block  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("b5_masks: needs a CUDA card", file=sys.stderr)
        return 1
    build.build_all()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    Ls = torch.randn((2, 4096, 4096), generator=g, device=dev).tril_()
    Ls.diagonal(dim1=-2, dim2=-1).add_(4096)
    timer = chip_smoke.Timer(dev)
    for mask in ([1, 0], [0, 1], [1, 1]):
        v = torch.tensor(mask, dtype=torch.int32, device=dev)
        b5 = [timer.ms(lambda: tri_inv_block.tri_inv_blocks(Ls, v), 10)
              for _ in range(5)]
        b1 = [timer.ms(lambda: tri_inv_block.tri_inv_blocks(Ls), 10)
              for _ in range(5)]
        print(json.dumps(dict(mask=mask, b5_ms=b5, b1_ms=b1)), flush=True)
    one = Ls[:1].contiguous()
    print(json.dumps(dict(b1_one_block_ms=[
        timer.ms(lambda: tri_inv_block.tri_inv_blocks(one), 10)
        for _ in range(5)])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
