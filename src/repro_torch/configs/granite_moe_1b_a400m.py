# Copied from src/repro/configs/granite_moe_1b_a400m.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base] — MoE,
32 experts top-8 every layer."""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    block_pattern=(ATTN,),
    moe=MoEConfig(num_experts=32, top_k=8),
    moe_every=1,
)
