"""Carrying state and weights from the reference package into the port.

A program's IR is what weights are to a model: both packages build it
from the same frontend calls, and ``Program.fingerprint`` shows that the
two builds are the same program.  What crosses over at run time is the
time-loop state, as numpy arrays (what ``np.asarray`` makes of the
reference's ``jax.Array`` state).

A language model's parameters cross over the same way: the reference's
parameter pytree as numpy (``jax.tree.map(np.asarray, params)``), leaf for
leaf by path, and so does a whole train state (parameters, AdamW moments
and counters: a reference checkpoint resumed by the port's trainer).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.api import Program
from repro_torch.configs.base import ModelConfig


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


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda", mesh=None,
                      specs=None) -> dict:
    """The port's parameters of ``cfg`` (``repro_torch.models.lm``'s nested
    dict) as float32 tensors on ``device``, copied from ``tree``, the
    reference's parameter pytree as nested dicts of numpy arrays.  With
    ``mesh`` and ``specs`` (a spec tree, ``param_pspecs``) each leaf is
    placed instead (``dist.sharding.place``: this process's blocks, on the
    mesh's device).

    Leaves are matched by path (``cells.slot0.attn.wq``).  This raises on a
    missing or extra leaf, a shape that is not the leaf's, or a dtype that
    is not float32: it never casts or reshapes."""
    from repro_torch.models import lm

    want = lm.leaves(lm.init_params(cfg, device="meta"))
    got = lm.leaves(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing leaves {missing}, extra leaves {extra}")
    out = {}
    for path, like in want.items():
        a = got[path]
        if not isinstance(a, np.ndarray):
            raise TypeError(f"leaf {path!r}: expected a numpy array, got {type(a).__name__}")
        if a.dtype != np.float32:
            raise TypeError(f"leaf {path!r}: dtype {a.dtype}, expected float32")
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"leaf {path!r}: shape {tuple(a.shape)}, expected {tuple(like.shape)}")
        node = out
        *parents, name = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        if mesh is None:
            node[name] = torch.tensor(a, dtype=torch.float32, device=device)
        else:
            from repro_torch.dist.sharding import place

            spec = specs
            for k in path.split("."):
                spec = spec[k]
            node[name] = place(a, mesh, spec)
    return out


def train_state_from_numpy(cfg: ModelConfig, tree: dict, device="cuda", mesh=None,
                           specs=None) -> dict:
    """The port's train state of ``cfg`` (``repro_torch.train.train_step``:
    ``{"params", "opt_state": {"m", "v", "count"}, "step"}``) on
    ``device``, copied from ``tree``, the reference's train state as nested
    dicts of numpy arrays (``jax.tree.map(np.asarray, state)``, or what the
    port's ``Checkpointer.restore`` returns).

    ``params``, ``m`` and ``v`` go through :func:`params_from_numpy` (float32,
    every leaf by path; placed by ``specs``, a ``state_pspecs`` tree, on
    ``mesh`` where they are given); ``count`` and ``step`` must be int32
    scalars."""
    missing = sorted({"params", "opt_state", "step"} - set(tree))
    if missing:
        raise KeyError(f"{cfg.name}: train state without {missing}")
    opt_state = tree["opt_state"]

    def scalar(name, a):
        a = np.asarray(a) if isinstance(a, np.generic) else a
        if not isinstance(a, np.ndarray) or a.shape != () or a.dtype != np.int32:
            raise TypeError(f"{name!r}: expected an int32 scalar array, got {a!r}")
        return torch.tensor(a, dtype=torch.int32, device=device)

    if mesh is not None:
        device = mesh.device(mesh.process_rank if mesh.processes else 0)
    sp = specs or {"params": None, "opt_state": {"m": None, "v": None}}
    return {
        "params": params_from_numpy(cfg, tree["params"], device, mesh, sp["params"]),
        "opt_state": {
            "m": params_from_numpy(cfg, opt_state["m"], device, mesh, sp["opt_state"]["m"]),
            "v": params_from_numpy(cfg, opt_state["v"], device, mesh, sp["opt_state"]["v"]),
            "count": scalar("opt_state.count", opt_state["count"]),
        },
        "step": scalar("step", tree["step"]),
    }
