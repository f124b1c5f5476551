"""qwen3-1.7b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144,
    vocab=151936, qk_norm=True, tie_embeddings=True, rope_theta=1e6,
    head_dim_override=128,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=256, qk_norm=True, tie_embeddings=True,
)
