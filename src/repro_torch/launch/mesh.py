"""The reference's production meshes, as port meshes (port of
``repro.launch.mesh``).

These are the reference's TPU topologies — a pod of (16, 16) = 256 chips
with axes (data, model) and two pods of (2, 16, 16) = 512 chips with axes
(pod, data, model) — used as a layout oracle: the dry run lays every
parameter, state and cache out over them and counts one rank's bytes.
They are not an H100 deployment.  The ranks' devices are ``cpu``,
repeated (nothing is allocated on them: the dry run's tensors are meta
tensors), or any devices the caller passes.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` with ``axes``; ranks on ``devices``
    (row-major, as many as the mesh has ranks) or all on ``cpu``."""
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    pool = [torch.device("cpu")] * n if devices is None else [torch.device(d) for d in devices]
    if len(pool) != n:
        raise ValueError(f"a mesh of {shape} needs {n} devices, got {len(pool)}")
    devs = np.empty(n, dtype=object)
    for i, d in enumerate(pool):
        devs[i] = d
    return Mesh(devs.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices: Optional[Sequence] = None) -> Mesh:
    """Single pod: (16, 16), axes (data, model).
    Multi-pod: (2, 16, 16), axes (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
