"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM units).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv=2, d_ff=0, vocab=256,
    block_pattern=("mlstm", "slstm"),
)
