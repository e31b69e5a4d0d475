# Copied from src/repro/configs/yi_9b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""yi-9b [arXiv:2403.04652; hf] — llama-arch dense GQA (kv=4)."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    block_pattern=(ATTN,),
    rope_theta=10000.0,
)
