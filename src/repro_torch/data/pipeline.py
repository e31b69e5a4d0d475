"""Token data pipeline: synthetic stream + memory-mapped file backend,
sharded per data-parallel rank, with background host prefetch (port of
``repro.data.pipeline``: the same code, less the reference's unused JAX
imports).  Batches are numpy arrays on the host; the trainer's
``put_batch`` moves them to the device.

Determinism: the synthetic stream is keyed by (seed, step), so restarts
resume bit-identically from the checkpointed step — a fault-tolerance
requirement, not a convenience.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    path: Optional[str] = None        # tokenized uint32 flat file (memmap)
    modality_tokens: int = 0
    modality_dim: int = 0
    modality_is_frames: bool = False  # audio: frames span the whole seq


class SyntheticTokens:
    """Deterministic synthetic batches keyed by step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        n_text = cfg.seq_len - (
            0 if cfg.modality_is_frames else cfg.modality_tokens
        )
        out = {
            "tokens": rng.integers(
                0, cfg.vocab_size, (cfg.global_batch, n_text), dtype=np.int32
            )
        }
        if cfg.modality_tokens or cfg.modality_is_frames:
            m = cfg.seq_len if cfg.modality_is_frames else cfg.modality_tokens
            out["modality"] = rng.standard_normal(
                (cfg.global_batch, m, cfg.modality_dim), dtype=np.float32
            )
        return out


class FileTokens:
    """Flat uint32 token file, read as non-overlapping windows."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.windows = len(self.data) // cfg.seq_len

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        idx = (
            np.arange(cfg.global_batch) + step * cfg.global_batch
        ) % self.windows
        toks = np.stack(
            [
                self.data[i * cfg.seq_len : (i + 1) * cfg.seq_len]
                for i in idx
            ]
        ).astype(np.int32)
        return {"tokens": np.minimum(toks, cfg.vocab_size - 1)}


class PrefetchLoader:
    """Background-thread prefetch of host batches (depth-bounded)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            step, batch = self.q.get()
            yield step, batch

    def stop(self) -> None:
        self._stop.set()


def make_source(cfg: DataConfig):
    return FileTokens(cfg) if cfg.path else SyntheticTokens(cfg)
