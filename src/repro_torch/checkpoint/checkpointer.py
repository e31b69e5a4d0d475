"""Sharded checkpointing with manifest + async writes + elastic restore
(port of ``repro.checkpoint.checkpointer``).

Layout:  <dir>/step_<n:08d>/
            manifest.json           — tree structure, shapes, dtypes,
                                      plus caller-provided ``extra``
                                      metadata (the resilience driver
                                      records program fingerprint, step,
                                      rotation phase, ret_indices here)
            <leaf-key>.npy          — one file per leaf
            COMMITTED               — written last; partial checkpoints
                                      (preemption mid-write) are ignored

The layout, the leaf keys (dict keys joined with ``/``, sequence indices
as ``[i]``) and the file names (``key.replace("/", "__") + ".npy"``) are
the reference's, so a snapshot written by either package restores in the
other.

A save copies every leaf to the host (page-locked memory for a card's
tensor) before it returns or starts its writer: a tensor is copied off
its device (a
:class:`~repro_torch.dist.ShardedTensor` is gathered to one global tensor
first), so the snapshot holds no reference to the caller's tensors and a
later epoch may overwrite them while an async write runs.  Restore
returns host (numpy) arrays: placing them on a device, on any mesh, is
the caller's job (``CompiledStencil.shard_state``), so a run
checkpointed over four ranks restores onto one device unchanged.  Async
saves run on a daemon thread; ``wait`` joins before the next save or
shutdown, and raises what the write raised.

Retention and crash hygiene: after each successful COMMITTED save, the
``keep_last`` newest committed snapshots are retained and older ones
pruned; construction garbage-collects leftovers of preempted writers —
``step_*.tmp`` staging dirs and uncommitted ``step_*`` dirs.  The
per-instance ``stats`` counters (saves / prunes / gcs) are truthful:
a prune is a committed snapshot aged out, a gc is a partial dir removed.
``last_save`` holds the seconds of the latest save's two parts: the copy
to the host and the write.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import ShardedTensor, gather


def _children(node) -> Optional[list]:
    """``[(path token, child), ...]`` of a container node in the
    reference's flatten order (dict keys sorted, as ``jax.tree_util``
    sorts them), or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _flatten(tree) -> dict:
    """``{key: leaf}`` in flatten order; ``None`` is an empty subtree."""
    out: dict = {}

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out["/".join(path)] = node
            return
        for token, child in kids:
            walk(child, path + [token])

    walk(tree, [])
    return out


def _unflatten(tree_like, leaves: dict):
    """``tree_like``'s structure with each leaf replaced by ``leaves[key]``."""

    def build(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return type(node)((k, build(node[k], path + [str(k)])) for k in node)
        if isinstance(node, (list, tuple)):
            return type(node)(build(c, path + [f"[{i}]"]) for i, c in enumerate(node))
        return leaves["/".join(path)]

    return build(tree_like, [])


def _to_host(x) -> np.ndarray:
    """A host copy of one leaf that shares no memory with it.  A card's
    tensor lands in page-locked memory: a copy into pageable memory runs
    at a fraction of the link's rate (PERF.md), and torch's host allocator
    keeps the freed buffers for the next snapshot."""
    if isinstance(x, ShardedTensor):
        x = gather(x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x).numpy()
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


@dataclasses.dataclass
class CheckpointStats:
    """Per-Checkpointer counters: committed saves, retention prunes of
    committed snapshots, and startup garbage collections of partial
    (uncommitted / staging) directories."""

    saves: int = 0
    prunes: int = 0
    gcs: int = 0
    restores: int = 0

    def as_dict(self) -> dict:
        return {
            "saves": self.saves,
            "prunes": self.prunes,
            "gcs": self.gcs,
            "restores": self.restores,
        }


# Process-wide mirror: every instance bump also lands here (``_bump``),
# so a registry sees checkpoint traffic without holding references to
# short-lived Checkpointer instances.  Writer threads bump too: the lock
# keeps each read-modify-write whole.
_GLOBAL_STATS = CheckpointStats()
_STATS_LOCK = threading.Lock()


def global_stats() -> CheckpointStats:
    return _GLOBAL_STATS


class Checkpointer:
    def __init__(
        self,
        directory: str,
        keep: int = 3,
        keep_last: Optional[int] = None,
    ):
        self.dir = directory
        # ``keep_last`` is the canonical retention knob; ``keep`` remains
        # as the original spelling (same meaning) for existing callers
        self.keep = int(keep_last if keep_last is not None else keep)
        if self.keep < 1:
            raise ValueError(f"keep_last must be >= 1, got {self.keep}")
        self.stats = CheckpointStats()
        self.last_save: dict = {}  # {"to_host_s": ..., "write_s": ...}
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._failed: Optional[BaseException] = None  # the last async write's error
        self._startup_gc()

    def _bump(self, field: str) -> None:
        # per-instance truth plus the process-wide mirror
        with _STATS_LOCK:
            setattr(self.stats, field, getattr(self.stats, field) + 1)
            setattr(_GLOBAL_STATS, field, getattr(_GLOBAL_STATS, field) + 1)

    def _startup_gc(self) -> None:
        """Remove leftovers of a preempted writer: ``step_*.tmp`` staging
        dirs and ``step_*`` dirs missing their COMMITTED marker.  A torn
        write is already *invisible* to restore; this reclaims its disk
        and keeps the directory listing honest."""
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if re.fullmatch(r"step_\d+\.tmp", name):
                shutil.rmtree(path, ignore_errors=True)
                self._bump("gcs")
            elif re.fullmatch(r"step_\d+", name) and not os.path.exists(
                os.path.join(path, "COMMITTED")
            ):
                shutil.rmtree(path, ignore_errors=True)
                self._bump("gcs")

    # -- save ------------------------------------------------------------
    def save(
        self,
        step: int,
        tree,
        blocking: bool = False,
        extra: Optional[dict] = None,
    ) -> None:
        """Snapshot ``tree`` (nested dicts, lists and tuples of tensors,
        sharded tensors or numpy arrays) as ``step``.  ``extra`` is a
        JSON-able dict merged into the manifest under ``"extra"`` —
        metadata a resumer needs but that is not an array leaf."""
        self.wait()
        t0 = time.perf_counter()
        flat = {key: _to_host(leaf) for key, leaf in _flatten(tree).items()}
        self.last_save = {"to_host_s": time.perf_counter() - t0}

        def write():
            t1 = time.perf_counter()
            path = os.path.join(self.dir, f"step_{step:08d}")
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            manifest: dict = {"step": step, "leaves": {}}
            if extra is not None:
                manifest["extra"] = extra
            for key, leaf in flat.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), leaf)
                manifest["leaves"][key] = {
                    "file": fname,
                    "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype),
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            shutil.rmtree(path, ignore_errors=True)
            os.rename(tmp, path)
            self._bump("saves")
            self._gc()
            self.last_save["write_s"] = time.perf_counter() - t1

        def write_async():
            try:
                write()
            except BaseException as e:  # raised again by wait(), in the caller
                self._failed = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write_async, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the pending async write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        failed, self._failed = self._failed, None
        if failed is not None:
            raise failed

    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True
            )
            self._bump("prunes")

    # -- restore ----------------------------------------------------------
    def available_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def manifest(self, step: Optional[int] = None) -> dict:
        """The manifest of ``step`` (default: latest committed) — leaf
        metadata plus whatever ``extra`` the saver recorded."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, tree_like, step: Optional[int] = None, shardings=None) -> Any:
        """Restore into the structure of ``tree_like`` as host (numpy)
        arrays.

        ``shardings`` is accepted for the reference's signature and must
        be ``None``: placement onto a device or a mesh is the caller's
        (``CompiledStencil.shard_state``).
        """
        if shardings is not None:
            raise ValueError(
                "Checkpointer.restore returns host arrays; place them with "
                "CompiledStencil.shard_state (shardings must be None)"
            )
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        loaded = {}
        for key in _flatten(tree_like):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            loaded[key] = np.load(os.path.join(path, meta["file"]))
        self._bump("restores")
        return _unflatten(tree_like, loaded)
