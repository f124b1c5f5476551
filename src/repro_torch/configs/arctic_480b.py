"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, n_experts=128, topk=2, moe_d_ff=4864,
    dense_residual=True,
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96, vocab=256,
    n_experts=8, topk=2, moe_d_ff=96, dense_residual=True,
)
