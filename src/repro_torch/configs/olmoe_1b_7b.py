# Copied from src/repro/configs/olmoe_1b_7b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""olmoe-1b-7b [arXiv:2409.02060; hf] — MoE, 64 experts top-8 every layer."""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    block_pattern=(ATTN,),
    moe=MoEConfig(num_experts=64, top_k=8),
    moe_every=1,
)
