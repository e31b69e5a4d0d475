# Copied from src/repro/configs/seamless_m4t_large_v2.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — encoder-decoder
multimodal backbone (speech encoder + text decoder), MHA (kv=16).

The audio frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings at d_model.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    block_pattern=(ATTN,),
    is_encoder_decoder=True,
    n_encoder_layers=24,
    modality="audio",
    modality_dim=1024,
)
