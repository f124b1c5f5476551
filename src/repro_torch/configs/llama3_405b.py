"""llama3-405b [dense] — GQA, 128k vocab.  [arXiv:2407.21783; unverified]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv=8, d_ff=53248,
    vocab=128256, rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama3-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv=2, d_ff=320, vocab=512,
)
