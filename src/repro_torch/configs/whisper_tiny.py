"""whisper-tiny [audio] — enc-dec transformer backbone; the conv/mel
frontend is a stub per the assignment (input_specs provides precomputed
frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536,
    vocab=51865, enc_dec=True, n_enc_layers=4, enc_frames=1500,
    embed_inputs=False,   # decoder consumes tokens; encoder takes frames
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
    enc_dec=True, n_enc_layers=2, enc_frames=64,
)
