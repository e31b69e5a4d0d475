"""Trace-time flags threaded through the model code (port of
``repro.models.flags``).

The reference unrolls its ``lax.scan`` s under ``unroll_scans`` because
XLA's ``cost_analysis`` counts a while-loop body once.  The port's models
loop in Python, so every supercell and chunk runs (and is counted by
``torch.utils.flop_counter``) as often as it runs: no loop is counted once,
and the flag changes nothing in the port.  The API stays so that callers
of the reference's dry-run code keep working.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

_UNROLL: ContextVar[bool] = ContextVar("unroll_scans", default=False)


def unroll_scans() -> bool:
    return _UNROLL.get()


@contextlib.contextmanager
def set_unroll_scans(value: bool):
    token = _UNROLL.set(value)
    try:
        yield
    finally:
        _UNROLL.reset(token)


def scan_unroll_arg() -> int | bool:
    """What the reference passes as ``lax.scan``'s ``unroll=``."""
    return True if _UNROLL.get() else 1
