# Copied from src/repro/configs/qwen2_7b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""qwen2-7b [arXiv:2407.10671; hf] — dense GQA (kv=4) with QKV bias."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1000000.0,
)
