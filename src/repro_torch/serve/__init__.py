"""Serving (port of ``repro.serve``): the multi-tenant stencil engine of
``repro_torch.serve.stencil``.  The reference's language-model ``Engine``
is not ported yet."""
from repro_torch.serve.stencil import (  # noqa: F401
    Frame,
    RequestHandle,
    StencilEngine,
    StencilEngineConfig,
    StencilRequest,
)
