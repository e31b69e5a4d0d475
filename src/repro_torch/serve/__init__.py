"""Serving (port of ``repro.serve``): the continuous-batching language-model
``Engine`` of ``repro_torch.serve.engine`` and the multi-tenant stencil
engine of ``repro_torch.serve.stencil``."""
from repro_torch.serve.engine import Engine, EngineConfig, Request  # noqa: F401
from repro_torch.serve.stencil import (  # noqa: F401
    Frame,
    RequestHandle,
    StencilEngine,
    StencilEngineConfig,
    StencilRequest,
)
