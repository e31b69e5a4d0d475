"""The stencil IR, its dialects and the shared pass pipeline (copied from
``repro.core``), plus the tensor executor ``core.lowering``."""
