"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; hf]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680,
    vocab=256000, block_pattern=("rec", "rec", "attn"),
    local_window=2048, conv_width=4, head_dim_override=256,
)

SMOKE = ModelConfig(
    name="rg-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=2, n_kv=1, d_ff=128, vocab=256,
    block_pattern=("rec", "rec", "attn"), local_window=32, conv_width=4,
)
