"""Multi-tenant stencil-simulation serving (fingerprint-batched slot pools;
port of ``repro.serve.stencil``).

See ``engine.py`` for the execution model and DESIGN.md §9 for the
design rationale.
"""
from repro_torch.serve.stencil.engine import (  # noqa: F401
    StencilEngine,
    StencilEngineConfig,
)
from repro_torch.serve.stencil.metrics import EngineMetrics, StepMetrics  # noqa: F401
from repro_torch.serve.stencil.request import (  # noqa: F401
    DONE,
    QUEUED,
    RUNNING,
    Frame,
    RequestHandle,
    StencilRequest,
)
from repro_torch.serve.stencil.scheduler import (  # noqa: F401
    PoolSizer,
    PoolSizerConfig,
    Scheduler,
    SlotPool,
)
