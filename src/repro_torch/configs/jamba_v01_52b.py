# Copied from src/repro/configs/jamba_v01_52b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""jamba-v0.1-52b [arXiv:2403.19887; hf] — hybrid Mamba+attention 1:7
interleave with MoE (16 experts, top-2) every other layer.

Supercell of 8: attention at slot 4 (mid-block, per the Jamba paper),
Mamba elsewhere; MoE on odd slots (moe_every=2).
"""
from repro_torch.configs.base import ATTN, MAMBA, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    block_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    moe=MoEConfig(num_experts=16, top_k=2),
    moe_every=2,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
)
