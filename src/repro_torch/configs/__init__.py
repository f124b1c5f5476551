"""Architecture registry: ``--arch <id>`` resolves here.

One module per assigned architecture with the exact published dims;
``get(arch)`` returns the full config, ``get_smoke(arch)`` a reduced
config of the same family for CPU tests.  ``SHAPES`` defines the four
assigned input-shape cells; ``cells()`` enumerates the 40 (arch x shape)
dry-run cells with applicability per DESIGN.md Sec. 6.

Plain data, kept as a copy of ``repro.configs`` (the port imports
nothing of the JAX package): every field and property is the
reference's, so a config names the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

ARCH_IDS = [
    "qwen3-1.7b", "granite-8b", "smollm-360m", "llama3-405b",
    "grok-1-314b", "arctic-480b", "recurrentgemma-2b", "qwen2-vl-72b",
    "xlstm-1.3b", "whisper-tiny",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # --- optional features ---
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple] = None      # qwen2-vl M-RoPE
    # MoE
    n_experts: int = 0
    topk: int = 0
    dense_residual: bool = False                # arctic: MoE + dense FFN
    moe_d_ff: int = 0                           # expert FFN width
    moe_capacity: float = 1.25                  # capacity factor (GShard)
    # hybrid/ssm pattern: repeating unit of block kinds
    block_pattern: tuple = ("attn",)            # e.g. ("rec","rec","attn")
    local_window: int = 0                       # local attention window
    conv_width: int = 4                         # RG temporal conv
    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500                      # stub frontend output len
    # vlm/audio stub frontend: inputs are precomputed embeddings
    embed_inputs: bool = False
    norm_eps: float = 1e-6
    head_dim_override: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding/head tables are allocated padded to a multiple of
        256 so the vocab dim shards over any mesh axis (whisper's 51865
        would otherwise replicate the logits gradient); padded logits
        are masked to -inf.  Config-level vocab is unchanged."""
        return (self.vocab + 255) // 256 * 256

    @property
    def sub_quadratic(self) -> bool:
        """Supports long-context decode with bounded state."""
        return self.family in ("hybrid", "ssm")

    def _block_param_counts(self, experts: int) -> int:
        """Sum of block parameters over the layer stack, pattern-aware.
        ``experts``: how many experts' FFNs to count per MoE block
        (n_experts for storage, topk for active)."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        ffn_mult = 2 if self.family == "audio" else 3
        per_kind = {}
        per_kind["attn"] = attn
        if self.n_experts:
            per_kind["attn"] += ffn_mult * d * self.moe_d_ff * experts \
                + d * self.n_experts
            if self.dense_residual:
                per_kind["attn"] += ffn_mult * d * self.d_ff
        elif self.d_ff:
            per_kind["attn"] += ffn_mult * d * self.d_ff
        per_kind["rec"] = 5 * d * d + 3 * d * self.d_ff
        hd2 = d // self.n_heads
        per_kind["mlstm"] = 5 * d * d + 2 * d * self.n_heads
        per_kind["slstm"] = 5 * d * d + 4 * d * hd2
        pat = self.block_pattern
        n_units, tail = divmod(self.n_layers, len(pat))
        total = 0
        for i, kind in enumerate(pat):
            total += per_kind[kind] * (n_units + (1 if i < tail else 0))
        if self.enc_dec:
            total += self.n_layers * attn          # decoder cross-attn
        return total

    @property
    def enc_param_count(self) -> int:
        """Encoder-stack params (enc-dec archs; processes enc_frames
        tokens, so its flops scale separately from decoder tokens)."""
        if not self.enc_dec:
            return 0
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        return self.n_enc_layers * (attn + 2 * d * self.d_ff)

    @property
    def param_count(self) -> int:
        """Parameter count (pattern-aware; used for 6ND model flops)."""
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self._block_param_counts(self.n_experts) + emb

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self._block_param_counts(self.topk) + emb

    @property
    def flop_param_count(self) -> int:
        """Matmul-participating active params per decoder token: block
        weights (top-k experts for MoE) + the output head, EXCLUDING the
        embedding gather (0 matmul flops) and the encoder stack (scales
        with enc_frames, not decoder tokens).  6*this*D is the 'useful
        flops' denominator that makes useful_ratio <= 1 meaningful."""
        return self._block_param_counts(self.topk) \
            + self.vocab * self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get(arch: str) -> ModelConfig:
    import importlib
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def get_smoke(arch: str) -> ModelConfig:
    import importlib
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.SMOKE


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Applicability per the assignment: long_500k only for sub-quadratic
    archs; every assigned arch has a decoder, so decode shapes all run."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense-attention decode is "
                       "quadratic-cost by definition (DESIGN.md Sec. 6)")
    return True, ""


def cells():
    """All 40 (arch x shape) cells with applicability verdicts."""
    out = []
    for a in ARCH_IDS:
        cfg = get(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
