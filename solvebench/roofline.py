"""The card's peaks and the work a solve needs, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W
power limit (dense rates, no sparsity), as ``roofline/analysis.py`` of
the port has them.  A solve's work is counted from its shapes alone, so
it reads the same whatever implements the solve:

* flops: n^2 k for op(L) X = B with L (n, n) triangular and B (n, k);
* bytes: the triangle of L at 2 bytes (bfloat16, the narrowest storage
  the bf16_refine preset allows) read once, B read once and X written
  once at the 4 bytes of the float32 the caller hands in and gets back.

The bound is taken against the lowest precision the preset allows,
bfloat16 on the tensor cores, so a later change that stores less or
moves work onto the tensor cores still cannot read over 100%.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "float64": 67e12}
PEAK_BYTES_PER_S = 3.35e12
FACTOR_BYTES = 2
IO_BYTES = 4


def solve_flops(n: int, k: int) -> float:
    return float(n) * n * k


def solve_bytes(n: int, k: int) -> float:
    return n * (n + 1) / 2 * FACTOR_BYTES + 2.0 * n * k * IO_BYTES


def solve_bound_s(n: int, k: int) -> float:
    """The least time the card could take for one solve: the larger of
    its flops over the bfloat16 peak and its bytes over the bandwidth."""
    return max(solve_flops(n, k) / PEAK_FLOPS["bfloat16"],
               solve_bytes(n, k) / PEAK_BYTES_PER_S)
