# Copied from src/repro/configs/internvl2_2b.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""internvl2-2b [arXiv:2404.16821; hf] — InternViT + InternLM2 backbone.

The ViT frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (256 tokens at InternViT width 1024), which
the MLP projector maps into the LM's embedding space.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    block_pattern=(ATTN,),
    modality="vision",
    num_modality_tokens=256,
    modality_dim=1024,
)
