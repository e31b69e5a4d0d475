# Copied from src/repro/core/dialects/__init__.py with repro. renamed to repro_torch.; keep its logic in step with that file.
from repro_torch.core.dialects import comm, dmp, stencil  # noqa: F401
