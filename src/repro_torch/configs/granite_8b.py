"""granite-8b [dense] — llama-arch, code.  [arXiv:2405.04324; hf]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=49152, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=256,
)
