"""Carrying state from the reference package into the port.

A program's IR is what weights are to a model: both packages build it
from the same frontend calls, and ``Program.fingerprint`` shows that the
two builds are the same program.  What crosses over at run time is the
time-loop state, as numpy arrays (what ``np.asarray`` makes of the
reference's ``jax.Array`` state).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.api import Program


def state_from_numpy(program: Program, arrays: Sequence, device="cuda") -> tuple:
    """The time-loop state of ``program`` (its input fields, oldest →
    newest) as float32 tensors on ``device``, copied from ``arrays``.

    Each array must be a float32 numpy array of its field's shape: this
    raises rather than casts or reshapes."""
    fields = program.input_fields
    if len(arrays) != len(fields):
        raise ValueError(
            f"{program.name!r} takes {len(fields)} state arrays "
            f"({[program.field_names[program.field_args.index(f)] for f in fields]}), "
            f"got {len(arrays)}"
        )
    out = []
    for f, a in zip(fields, arrays):
        name = program.field_names[program.field_args.index(f)]
        if not isinstance(a, np.ndarray):
            raise TypeError(f"state {name!r}: expected a numpy array, got {type(a).__name__}")
        if a.dtype != np.float32:
            raise TypeError(f"state {name!r}: dtype {a.dtype}, expected float32")
        if tuple(a.shape) != tuple(f.type.bounds.shape):
            raise ValueError(
                f"state {name!r}: shape {tuple(a.shape)}, expected "
                f"{tuple(f.type.bounds.shape)}"
            )
        out.append(torch.tensor(a, dtype=torch.float32, device=device))
    return tuple(out)
