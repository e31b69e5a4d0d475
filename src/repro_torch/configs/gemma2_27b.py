# Copied from src/repro/configs/gemma2_27b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""gemma2-27b [arXiv:2408.00118; hf] — local/global alternating attention
with logit softcaps.

The local layers (sliding window 4096) are the paper-technique showcase:
a bounded stencil on the sequence axis → KV halo exchange under sequence
parallelism (DESIGN.md §4).
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    block_pattern=(ATTN_LOCAL, ATTN),
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
)
