"""Three-term roofline analysis of one rank's step on an NVIDIA H100.

    compute term    = flops_per_device / peak flops
    memory term     = bytes_per_device / HBM bandwidth
    collective term = collective_bytes_per_device / link bandwidth

Sources: ``FlopCounterMode`` over one rank's step on meta tensors
(:func:`counted_flops`: eager torch unrolls every loop, so every trip
is counted, unlike a compiled program's ``while`` bodies, counted
once); the collective bytes from the cost trace of that step
(``comm.traced_cost``, :func:`collectives_from_trace`); the memory
term from bytes the caller counts (per-rank arguments, or the
analytic model's HBM traffic).

Hardware model: NVIDIA H100 SXM5 at its 700 W limit, data-sheet
peaks, not measured: 989 TFLOP/s bf16 dense (no sparsity), 3.35 TB/s
HBM3, and one direction of NVLink 4 (450 GB/s, the figure
``cost_model.h100`` prices a word with; we charge one link, the
conservative serialization bound).
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s, one direction of NVLink 4


def collectives_from_trace(trace) -> dict:
    """-> {op: {"bytes": float, "count": float}} of a ``comm.CostTrace``:
    each op's critical-path words (the paper's W, loop multipliers
    applied), each at its own operand's element size (an fp32 gather
    moves 4 bytes a word, a bf16 one 2), and its call count."""
    out: dict[str, dict] = {}
    for r in trace.records:
        d = out.setdefault(r.op, {"bytes": 0.0, "count": 0.0})
        d["bytes"] += r.w * r.mult * r.itemsize
        d["count"] += r.mult
    return out


def counted_flops(fn, *args, **kwargs) -> float:
    """The flops ``FlopCounterMode`` counts in ``fn(*args, **kwargs)``
    (matmuls, convolutions and attention; elementwise work is not
    counted).  On meta tensors nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    n_chips: int
    model_flops: float = 0.0          # 6*N*D (train) / 2*N*D (inference)

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_dev * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's peak the step achieves under the
        max-term execution model: t_bound = max(3 terms); achievable
        MFU = (useful flops / chips / t_bound) / peak."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t == 0:
            return 0.0
        per_chip = self.model_flops / self.n_chips / t
        return per_chip / PEAK_FLOPS

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counts(flops_per_dev: float, bytes_per_dev: float, trace,
                n_chips: int, model_flops: float) -> tuple:
    """-> (Roofline, collectives) of one rank's counted step: its flops
    (:func:`counted_flops`, every loop trip counted), its bytes, and
    the collectives of its cost trace (None: none)."""
    colls = collectives_from_trace(trace) if trace is not None else {}
    cb = sum(v["bytes"] for v in colls.values())
    return Roofline(flops_per_dev, bytes_per_dev, cb, n_chips,
                    model_flops), colls


def model_flops_for(cfg, shape) -> float:
    """Useful model flops: 6*N*D (train) / 2*N*D (inference) with
    N = flop_param_count (matmul-participating active params; see
    configs.ModelConfig.flop_param_count) plus the encoder side for
    enc-dec archs (scales with enc_frames, not decoder tokens)."""
    n = cfg.flop_param_count
    mult = 6.0 if shape.kind == "train" else 2.0
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.seq_len * shape.global_batch
    f = mult * n * tokens
    if cfg.enc_dec and shape.kind != "decode":
        f += mult * cfg.enc_param_count * cfg.enc_frames \
            * shape.global_batch
    return f
