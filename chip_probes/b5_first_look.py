#!/usr/bin/env python3
"""First look at kernel B5 on the card: builds the kernels (nvcc's
``-Xptxas -v`` register and shared-memory report of the gated
instantiations is printed) and runs ``chip_smoke.valid_inv_phase``, B5
against its plain version at the padded admission's shapes, with NaN
in the flagged blocks and an all-ones mask against B1.

    PYTHONPATH=src python3 chip_probes/b5_first_look.py
"""

import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print("card:", chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)
    log = (build.BUILD_DIR / f"{libs['tri_inv_levels'].stem}.log").read_text()
    for line in log.splitlines():
        if "tri_inv_leaf" in line or "Lb1E" in line or "registers" in line:
            print(line)
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(1)
    chip_smoke.valid_inv_phase(device, chip_smoke.Timer(device), g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
