"""DEPRECATED compile surface — thin shim over ``repro_torch.api``.

Port of ``repro.core.program``.  The user-facing API is
``repro_torch.api``'s three nouns:

    prog   = Program(func, boundary="periodic")       # or any frontend
    target = Target(backend="cuda")                   # the card
    step   = repro_torch.api.compile(prog, target)    # CompiledStencil

``StencilComputation`` and ``CompileOptions`` are kept so that code
written against the old surface runs on the port; they delegate to the new
surface (and therefore share its process-wide compile cache), with the
reference's ``DeprecationWarning``s.  ``CompileOptions`` carries the
port's ``Target`` fields minus mesh/strategy: ``backend`` is ``"torch"``
or ``"cuda"``, ``tile`` is K2's tile, and ``device`` picks the device
(``None``: the card).  ``StencilComputation.lower`` (the reference's
dry-run lowering) is not ported.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch import api
from repro_torch.api import time_loop, trivial_strategy  # noqa: F401  (legacy import path)
from repro_torch.core import ir
from repro_torch.core.passes import PassManager, PipelineContext, build_pipeline
from repro_torch.core.passes.decompose import SlicingStrategy
from repro_torch.dist import Mesh


@dataclasses.dataclass
class CompileOptions:
    """DEPRECATED flag bundle — the fields of ``repro_torch.api.Target``
    minus mesh/strategy.  Kept for source compatibility."""

    backend: str = "torch"  # "torch" | "cuda"
    fuse: bool = True
    cse: bool = True
    overlap: bool = False
    diagonal: bool = False
    # DEPRECATED no-op: the dmp→comm lowering is the canonical path and
    # always runs — every distributed compile executes comm ops.
    comm_dialect: bool = False
    tile: Optional[tuple] = None
    # Buffer donation (whole-state handover); opt in when the caller
    # rotates buffers.
    donate: bool = False
    # Explicit pipeline spec; overrides the fuse/cse/diagonal/overlap
    # flags when set.
    pipeline: Optional[str] = None
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.comm_dialect:
            warnings.warn(
                "CompileOptions.comm_dialect is a deprecated no-op: the "
                "dmp→comm lowering is the canonical path and always runs; "
                "use an explicit pipeline spec instead",
                DeprecationWarning,
                stacklevel=3,
            )

    def to_target(
        self,
        mesh: Optional[Mesh] = None,
        strategy: Optional[SlicingStrategy] = None,
        jit: bool = True,
    ) -> api.Target:
        return api.Target(
            mesh=mesh,
            strategy=strategy,
            backend=self.backend,
            pipeline=self.pipeline,
            fuse=self.fuse,
            cse=self.cse,
            overlap=self.overlap,
            diagonal=self.diagonal,
            tile=self.tile,
            device=self.device,
            donate=self.donate,
            jit=jit,
        )


def default_pipeline(opts: "CompileOptions") -> str:
    """The canonical pipeline spec the option flags denote (fig. 4)."""
    return opts.to_target().pipeline_spec()


class StencilComputation:
    """DEPRECATED shim: wraps a ``repro_torch.api.Program`` and delegates
    every compile to ``repro_torch.api.compile`` — one compile path, one
    cache."""

    def __init__(self, func: ir.FuncOp, boundary: str = "zero") -> None:
        warnings.warn(
            "StencilComputation is deprecated; use repro_torch.api.Program / "
            "Target / compile",
            DeprecationWarning,
            stacklevel=2,
        )
        self.program = api.Program(func, boundary=boundary)
        self.func = self.program.func
        self.boundary = boundary
        self.field_args = list(self.program.field_args)
        self.last_local: Optional[ir.FuncOp] = None  # for inspection/tests
        self.last_pipeline: Optional[str] = None
        self.last_timings: list = []  # (pass name, seconds) per stage

    def prepare_local(
        self,
        strategy: Optional[SlicingStrategy] = None,
        options: Optional[CompileOptions] = None,
    ) -> ir.FuncOp:
        """Run the shared pass pipeline; returns the rank-local,
        comm-lowered function.  (Unlike ``compile``, accepts a decomposed
        strategy without a mesh — IR-only inspection.)"""
        opts = options or CompileOptions()
        strategy = strategy or trivial_strategy(self.program.rank)
        spec = opts.pipeline or default_pipeline(opts)
        ctx = PipelineContext(strategy=strategy, boundary=self.boundary)
        pm = PassManager(build_pipeline(spec, ctx))
        local = pm.run(api._clone_func(self.func))
        self.last_local = local
        self.last_pipeline = spec
        self.last_timings = list(pm.timings)
        return local

    def compile(
        self,
        mesh: Optional[Mesh] = None,
        strategy: Optional[SlicingStrategy] = None,
        options: Optional[CompileOptions] = None,
        jit: bool = True,
    ) -> Callable:
        """Compile to a callable over *global* tensors (a CompiledStencil)."""
        opts = options or CompileOptions()
        artifact = api.compile(
            self.program, opts.to_target(mesh=mesh, strategy=strategy, jit=jit)
        )
        self.last_local = artifact.local_ir
        self.last_pipeline = artifact.pipeline_report.spec
        self.last_timings = list(artifact.pipeline_report.timings)
        return artifact

    def partition_specs(self, strategy: SlicingStrategy) -> list:
        return api.partition_specs(self.program, strategy)

    def lower(
        self,
        mesh: Mesh,
        strategy: SlicingStrategy,
        options: Optional[CompileOptions] = None,
        dtype=torch.float32,
    ) -> "api.LoweredCall":
        """For the dry run: compile for ``mesh``/``strategy`` and return one
        rank's call arguments as meta tensors with their bytes
        (``CompiledStencil.lower``: the port's stand-in for XLA's
        ``Lowered``; nothing is allocated)."""
        opts = options or CompileOptions()
        artifact = api.compile(self.program, opts.to_target(mesh=mesh, strategy=strategy))
        self.last_local = artifact.local_ir
        self.last_pipeline = artifact.pipeline_report.spec
        self.last_timings = list(artifact.pipeline_report.timings)
        return artifact.lower(dtype=dtype)

    def global_zeros(self, dtype=torch.float32, device="cuda") -> list:
        return self.program.global_zeros(dtype, device=device)


def _stored_fields(func: ir.FuncOp, field_args: Sequence[Any] = ()) -> list:
    # legacy helper signature; field_args was never needed
    return api._stored_fields(func)


def _clone_func(func: ir.FuncOp) -> ir.FuncOp:
    return api._clone_func(func)
