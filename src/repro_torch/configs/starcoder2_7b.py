# Copied from src/repro/configs/starcoder2_7b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""starcoder2-7b [arXiv:2402.19173; hf] — dense GQA (kv=4), RoPE."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    block_pattern=(ATTN,),
    rope_theta=1000000.0,
)
