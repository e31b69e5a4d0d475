# Copied from src/repro/configs/xlstm_1_3b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""xlstm-1.3b [arXiv:2405.04517; unverified] — xLSTM[7:1]: 7 mLSTM blocks
per sLSTM block, d_ff = 0 (projections live inside the blocks)."""
from repro_torch.configs.base import MLSTM, ModelConfig, SLSTM

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    block_pattern=(MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, SLSTM),
)
