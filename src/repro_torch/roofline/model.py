"""Analytic roofline accounting per (arch x shape x mesh) cell.

The dry run records both one rank's counted step (``FlopCounterMode``
flops, traced collectives, per-rank argument bytes) and this analytic
model, whose flops the reference validates against an unrolled compile
and whose HBM and collective traffic are first order.  The counted
step shows the port's own design (storage sharded, compute on whole
gathered tensors), the analytic model the reference's tensor-parallel
one: their ratio is the port's redundant compute.

All formulas are per STEP and GLOBAL; ``per_device`` divides by chip
count at the end.  dtype = bf16 compute (2 bytes), f32 optimizer state.
The t_* terms use the H100's peaks (``analysis``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models.layers import (ATTN_CHUNK, MLSTM_CHUNK,  # noqa: F401
                                       MOE_GROUP)
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           model_flops_for)

BYTES = 2          # bf16 activations/weights in compute
OPT_BYTES = 4      # f32 master/moments


def _block_counts(cfg: ModelConfig) -> dict:
    pat = cfg.block_pattern
    n_units, tail = divmod(cfg.n_layers, len(pat))
    counts: dict[str, int] = {}
    for i, kind in enumerate(pat):
        counts[kind] = counts.get(kind, 0) + n_units + (1 if i < tail else 0)
    return counts


def _layer_matmul_params(cfg: ModelConfig, kind: str) -> float:
    """Matmul-weight element count of one block of ``kind``."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * cfg.n_heads * hd * 2 + 2 * d * cfg.n_kv * hd
    if kind == "attn":
        p = attn
        if cfg.n_experts:
            p += cfg.topk * 3 * d * cfg.moe_d_ff + d * cfg.n_experts
            if cfg.dense_residual:
                p += 3 * d * cfg.d_ff
        elif cfg.d_ff:
            p += (3 if cfg.family != "audio" else 2) * d * cfg.d_ff
        return p
    if kind == "rec":
        return 5 * d * d + 3 * d * cfg.d_ff
    if kind == "mlstm":
        return 5 * d * d
    if kind == "slstm":
        hd2 = d // cfg.n_heads
        return 4 * d * d + 4 * d * hd2 + d * d
    raise ValueError(kind)


def _attn_ctx(cfg, sh: ShapeConfig) -> float:
    """Average attended context length per query."""
    window = cfg.local_window or 0
    if sh.kind == "decode":
        ctx = sh.seq_len
        return min(window, ctx) if window else ctx
    ctx = sh.seq_len / 2.0                        # causal average
    return min(window, ctx) if window else ctx


@dataclasses.dataclass
class CellModel:
    flops: float            # global per step
    hbm_bytes: float        # global per step
    coll_bytes: float       # global per step (sum over devices)
    model_flops: float      # useful 6ND / 2ND flops
    chips: int

    @property
    def t_compute(self):
        return self.flops / self.chips / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.hbm_bytes / self.chips / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / self.chips / LINK_BW

    @property
    def bottleneck(self):
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_ratio(self):
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self):
        tb = max(self.t_compute, self.t_memory, self.t_collective)
        if tb == 0:
            return 0.0
        return self.model_flops / self.chips / tb / PEAK_FLOPS

    def to_dict(self):
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "coll_bytes": self.coll_bytes,
                "model_flops": self.model_flops, "chips": self.chips,
                "t_compute": self.t_compute, "t_memory": self.t_memory,
                "t_collective": self.t_collective,
                "bottleneck": self.bottleneck,
                "useful_ratio": self.useful_ratio,
                "roofline_fraction": self.roofline_fraction}


def forward_flops(cfg: ModelConfig, sh: ShapeConfig, tokens: float) -> float:
    """Global forward flops for ``tokens`` processed tokens."""
    counts = _block_counts(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    f = 0.0
    for kind, n in counts.items():
        f += 2.0 * tokens * _layer_matmul_params(cfg, kind) * n
        if kind == "attn":
            ctx = _attn_ctx(cfg, sh)
            f += 2.0 * 2.0 * tokens * ctx * cfg.n_heads * hd * n
        if kind == "mlstm":
            c = min(MLSTM_CHUNK, max(int(tokens // max(sh.global_batch, 1)),
                                     1))
            hd2 = d // cfg.n_heads
            f += 2.0 * 2.0 * tokens * min(c, 1024) * d * n   # intra-chunk
            f += 2.0 * tokens * hd2 * d * n                  # state update
        if kind == "slstm":
            hd2 = d // cfg.n_heads
            f += 2.0 * tokens * 4 * d * hd2 * n
    # logits (+ encoder for enc-dec)
    f += 2.0 * tokens * d * cfg.vocab
    if cfg.enc_dec:
        enc_tokens = sh.global_batch * cfg.enc_frames
        attn_enc = d * cfg.n_heads * hd * 2 + 2 * d * cfg.n_kv * hd
        f += (2.0 * enc_tokens * (attn_enc + 2 * d * cfg.d_ff)
              + 4.0 * enc_tokens * cfg.enc_frames * cfg.n_heads * hd) \
            * cfg.n_enc_layers
        # cross attention in every decoder layer
        f += (2.0 * tokens * attn_enc
              + 4.0 * tokens * cfg.enc_frames * cfg.n_heads * hd) \
            * cfg.n_layers
    return f


def cell_model(cfg: ModelConfig, sh: ShapeConfig, mesh_shape: dict,
               microbatches: int = 1, kv_bytes: float = BYTES) -> CellModel:
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    tp = mesh_shape.get("model", 1)
    dp = chips // tp
    pods = mesh_shape.get("pod", 1)

    B, S = sh.global_batch, sh.seq_len
    tokens = float(B * S) if sh.kind != "decode" else float(B)
    pbytes = cfg.param_count * BYTES
    counts = _block_counts(cfg)
    n_attn = counts.get("attn", 0)

    fwd = forward_flops(cfg, sh, tokens)
    if sh.kind == "train":
        flops = 3.0 * fwd + 10.0 * cfg.param_count     # bwd ~2x fwd + opt
    else:
        flops = fwd
    model_flops = model_flops_for(cfg, sh)

    # ---------------- HBM traffic (global) ----------------
    d = cfg.d_model
    act_io = 24.0 if sh.kind == "train" else 8.0       # bytes/(token*d*layer)
    hbm = act_io * tokens * d * cfg.n_layers
    if sh.kind == "train":
        # weights streamed per microbatch (fwd+bwd) + optimizer state rw
        hbm += 2.0 * microbatches * pbytes + 6.0 * cfg.param_count * OPT_BYTES
    else:
        hbm += pbytes
    if sh.kind == "decode":
        # KV cache read(+write) dominates
        ctx = _attn_ctx(cfg, sh)
        cache = n_attn * 2 * B * min(ctx, S) * cfg.n_kv * cfg.head_dim \
            * kv_bytes
        hbm += 2.0 * cache
        if "mlstm" in counts:
            hd2 = d // cfg.n_heads
            hbm += 2.0 * counts["mlstm"] * B * cfg.n_heads * hd2 * hd2 * 4
    if sh.kind in ("train", "prefill") and n_attn:
        # chunked attention re-reads KV once per query chunk
        ctx = _attn_ctx(cfg, sh)
        passes = max(S // ATTN_CHUNK, 1)
        hbm += n_attn * B * passes * min(2 * ctx, S) \
            * cfg.n_kv * cfg.head_dim * BYTES

    # ---------------- collective traffic (global) ----------------
    coll = 0.0
    # TP: 2 reduction points per block fwd (attn out, ffn out), x2 in bwd;
    # each moves ~2x payload (reduce-scatter + all-gather) per device ring.
    tp_payload = tokens * d * BYTES
    red_per_block = 2.0
    n_blocks = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    if tp > 1:
        factor = 4.0 if sh.kind == "train" else 2.0
        coll += factor * red_per_block * n_blocks * tp_payload \
            * (tp - 1) / tp * 2
    # FSDP: per microbatch all-gather layer shards fwd+bwd, reduce-scatter
    # grads (train only).
    if dp // pods > 1 and sh.kind == "train":
        coll += (2.0 * microbatches + 1.0) * (pbytes / tp) * dp
    # EP dispatch (MoE): tokens routed to experts and back, fwd+bwd
    if cfg.n_experts and tp > 1:
        moe_payload = tokens * d * BYTES * 2.0 * cfg.topk
        coll += (3.0 if sh.kind == "train" else 1.0) \
            * counts.get("attn", 0) * moe_payload
    # cross-pod gradient allreduce (2x shard bytes per device)
    if pods > 1 and sh.kind == "train":
        coll += 2.0 * (cfg.param_count * OPT_BYTES / (tp * dp // pods)) \
            * chips
    # logits reduction (head contraction sharded)
    if tp > 1:
        coll += tokens * min(cfg.vocab / tp, d) * 4 * 2

    return CellModel(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                     model_flops=model_flops, chips=chips)
