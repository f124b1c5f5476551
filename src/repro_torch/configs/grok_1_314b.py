"""grok-1-314b [moe] — 8 experts top-2.  [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=0,
    vocab=131072, n_experts=8, topk=2, moe_d_ff=32768,
)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=0, vocab=256,
    n_experts=4, topk=2, moe_d_ff=128,
)
