"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (patch-embed stub:
inputs are precomputed patch embeddings per the assignment).
[arXiv:2409.12191; hf]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568,
    vocab=152064, mrope_sections=(16, 24, 24), embed_inputs=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
    mrope_sections=(4, 6, 6), embed_inputs=True,
)
