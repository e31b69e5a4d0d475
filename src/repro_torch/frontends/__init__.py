"""Stencil DSL frontends sharing one compilation stack (paper fig. 1b).

- ``devito_like``   — symbolic finite differences (Grid/TimeFunction/Eq);
- ``psyclone_like`` — loop-nest recognition on the Python AST (fig 10);
- ``oec_like``      — direct stencil-dialect construction.

All three emit the same ``stencil`` IR as a ``repro_torch.api.Program``
and compile through ``repro_torch.api.compile(program, target)``.
"""
