"""Stencil DSL frontends sharing one compilation stack (paper fig. 1b).

- ``devito_like`` — symbolic finite differences (Grid/TimeFunction/Eq);
- ``oec_like``    — direct stencil-dialect construction.

Both emit the same ``stencil`` IR as a ``repro_torch.api.Program`` and
compile through ``repro_torch.api.compile(program, target)``.  The
psyclone-like frontend is not ported yet.
"""
