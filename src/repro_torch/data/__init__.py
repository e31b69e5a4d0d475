"""The token data pipeline (``data/pipeline.py``)."""
from repro_torch.data.pipeline import DataConfig, FileTokens, PrefetchLoader, SyntheticTokens, make_source

__all__ = ["DataConfig", "FileTokens", "PrefetchLoader", "SyntheticTokens", "make_source"]
