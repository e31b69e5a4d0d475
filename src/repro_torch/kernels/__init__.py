"""Kernel layer: hand-written CUDA kernels for the stencil hot spots.

Shared here (imported by ``api``, ``core.lowering`` and the kernels):

- :func:`has_cuda` — whether PyTorch sees a CUDA device.  There is no
  interpret flag: a kernel wrapper takes its plain PyTorch version only
  for tensors that lie on the CPU, and launches its kernel (or raises)
  for CUDA tensors.
- :func:`dispatch_stats` — per-process kernel counters.  ``*_calls``
  count calls of a kernel wrapper on any device (as the reference counts
  traced ``pallas_call``s; a CUDA graph replay adds the calls its capture
  made); ``*_launches`` count CUDA launches only, so a
  run can show that its path went through the kernel: a wrapper's own
  launches, and under a CUDA graph replay the K1 and K2 kernel nodes the
  replayed graph holds (counted from the graph, ``kernels.graphs``).
  ``apply_*`` is
  kernel K1 (``stencil.apply``), ``fused_epoch_*`` kernel K2 (one
  ``stencil.fused_epoch``).
"""
from __future__ import annotations

import dataclasses

import torch


def has_cuda() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


@dataclasses.dataclass
class DispatchStats:
    """Counts of kernel-wrapper calls and CUDA launches since the last reset."""

    apply_calls: int = 0     # stencil.apply wrapper calls (kernels/stencil_apply.py)
    apply_launches: int = 0  # CUDA kernel launches (a wrapper's, or a replayed graph's K1 nodes)
    fused_epoch_calls: int = 0     # stencil.fused_epoch wrapper calls (kernels/epoch_kernel.py)
    fused_epoch_launches: int = 0  # CUDA kernel launches (likewise, K2)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_DISPATCH = DispatchStats()


def dispatch_stats() -> DispatchStats:
    return _DISPATCH


def reset_dispatch_stats() -> None:
    for f in dataclasses.fields(DispatchStats):
        setattr(_DISPATCH, f.name, 0)
