"""Continuous-batching serving engine for the language models.

Port of ``repro.serve.engine``.  Slot-pool design (vLLM-style, ring caches
instead of paged blocks):

- a fixed pool of ``max_slots`` decode slots, each owning one row of the
  batched KV/state cache (``[cells, max_slots, T, ...]``);
- arriving requests are prefilled one at a time (one callable per
  prompt-length bucket) and their caches *inserted* into a free slot;
- every engine step runs ONE batched ``decode_step`` over all slots with
  **per-slot positions** (slots decode at different depths — the
  continuous part);
- finished slots (EOS / max_new_tokens) are freed and immediately
  reusable, so throughput does not stall on the longest request.

The engine runs on the device of its params (the card, unless they were
made on another device); its decode and prefill callables come from
``repro_torch.api``'s process-wide cache under the reference's keys, so
``cache_stats()`` counts them as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 4
    max_len: int = 256
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    greedy: bool = True
    temperature: float = 1.0
    prefill_buckets: tuple = (32, 64, 128, 256)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0            # next position to be written
    done: bool = False


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class Engine:
    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 rng: Optional[np.random.Generator] = None):
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.rng = rng or np.random.default_rng(0)
        self.device = params["embed"].device
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}   # slot -> request
        self.free = list(range(ecfg.max_slots))
        self.finished: list[Request] = []
        self._next_rid = 0

        # pooled cache: [cells, max_slots, T(or window), ...]
        self.cache = lm.init_cache(cfg, ecfg.max_slots, ecfg.max_len, device=self.device)
        self.positions = torch.zeros((ecfg.max_slots,), dtype=torch.long, device=self.device)
        self.last_token = torch.zeros((ecfg.max_slots,), dtype=torch.long, device=self.device)
        self.live = np.zeros((ecfg.max_slots,), bool)

        # The callables come from repro_torch.api's process-wide cache,
        # keyed on the model-config fingerprint (+ bucket): a new Engine
        # over the same config reuses them.
        self._cfg_fp = repr(cfg)
        self._decode = api.cached_callable(
            ("serve-decode", self._cfg_fp),
            lambda: lambda params, tok, pos, cache: lm.decode_step(params, cfg, tok, pos, cache),
        )

    # -- public API --------------------------------------------------------
    def add_request(self, prompt: list) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid=rid, prompt=[int(t) for t in prompt]))
        return rid

    def step(self) -> None:
        """Admit waiting requests into free slots, then one decode round."""
        while self.queue and self.free:
            self._admit(self.queue.pop(0), self.free.pop(0))
        if not self.active:
            return
        logits, self.cache = self._decode(self.params, self.last_token, self.positions, self.cache)
        next_tok = self._sample(logits)
        for slot, req in list(self.active.items()):
            t = int(next_tok[slot])
            req.out.append(t)
            req.pos += 1
            if (
                (self.ecfg.eos_id is not None and t == self.ecfg.eos_id)
                or len(req.out) >= self.ecfg.max_new_tokens
                or req.pos >= self.ecfg.max_len
            ):
                req.done = True
                self.finished.append(req)
                del self.active[slot]
                self.free.append(slot)
                self.live[slot] = False
        self.last_token = torch.as_tensor(next_tok, dtype=torch.long).to(self.device)
        live = torch.as_tensor(self.live).to(self.device)
        self.positions = torch.where(live, self.positions + 1, self.positions)

    def run(self, max_steps: int = 10_000) -> list:
        for _ in range(max_steps):
            if not self.queue and not self.active:
                break
            self.step()
        return self.finished

    @property
    def utilization(self) -> float:
        return len(self.active) / self.ecfg.max_slots

    # -- internals ----------------------------------------------------------
    def _prefill_fn(self, bucket: int) -> Callable:
        cfg = self.cfg

        def build() -> Callable:
            def fn(params, toks):
                return lm.forward_prefill(params, cfg, toks, q_chunk=min(bucket, 512))

            return fn

        return api.cached_callable(("serve-prefill", self._cfg_fp, bucket), build)

    def _needs_exact_prefill(self) -> bool:
        """Right-padded prefill poisons ring windows and recurrent states;
        only pure global-attention stacks can use length buckets."""
        return any(k != "attn" for k in self.cfg.block_pattern)

    def _admit(self, req: Request, slot: int) -> None:
        n = len(req.prompt)
        bucket = n if self._needs_exact_prefill() else _bucket(
            n, self.ecfg.prefill_buckets
        )
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = req.prompt
        toks[0, n:] = req.prompt[-1]  # right padding (discarded below)
        logits, cache1 = self._prefill_fn(bucket)(self.params, torch.from_numpy(toks).to(self.device))
        # insert only the first n cache entries (padding K/V discarded)
        self.cache = _insert_cache(
            self.cfg, self.cache, cache1, slot, n, bucket, self.ecfg.max_len
        )
        req.slot = slot
        self.active[slot] = req
        self.live[slot] = True
        first = self._first_token(req, n, bucket, logits)
        req.out.append(int(first))
        req.pos = n
        self.positions[slot] = n
        self.last_token[slot] = int(first)

    def _first_token(self, req: Request, n: int, bucket: int, padded_logits) -> int:
        """Logits at the true last prompt position.

        forward_prefill returns last-*bucket*-position logits; for padded
        prompts we rerun the last token through a single decode against
        the already-inserted cache (cheap, one token; the other live
        slots' cache writes are idempotent re-writes of values already
        present)."""
        if bucket == n:
            return int(self._sample(padded_logits)[0])
        tok = self.last_token.clone()
        tok[req.slot] = req.prompt[-1]
        pos = self.positions.clone()
        pos[req.slot] = n - 1
        logits, self.cache = self._decode(self.params, tok, pos, self.cache)
        return int(self._sample(logits)[req.slot])

    def _sample(self, logits) -> np.ndarray:
        logits = logits.float().cpu().numpy()[..., : self.cfg.vocab_size]
        if self.ecfg.greedy:
            return logits.argmax(-1)
        z = logits / max(self.ecfg.temperature, 1e-5)
        p = np.exp(z - z.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        return np.array([self.rng.choice(len(q), p=q) for q in p])


def _insert_cache(cfg, pool, cache1, slot, n, bucket, max_len):
    """Insert a single-request prefill cache (length ``bucket``, ``n``
    valid) into slot ``slot`` of the pooled cache (length ``max_len``), in
    place; returns the pool."""
    for key, sub in cache1.items():
        for name, new_leaf in sub.items():
            pool_leaf = pool[key][name]
            if pool_leaf.ndim >= 3 and new_leaf.shape[0] == pool_leaf.shape[0]:
                # attention K/V: [cells, 1, T_src, ...] -> pool [cells, S, T_dst, ...]
                if new_leaf.ndim == pool_leaf.ndim and new_leaf.shape[2] != pool_leaf.shape[2]:
                    T_dst = pool_leaf.shape[2]
                    # prefill ring layout: position p at index p % T_src.
                    # un-roll to position order, take first n, re-ring for T_dst
                    T_src = new_leaf.shape[2]
                    src = torch.roll(new_leaf, -(bucket % T_src), dims=2) if bucket % T_src else new_leaf
                    take = min(n, T_dst, T_src)
                    entries = src[:, :, :take] if n <= T_src else src[:, :, T_src - take:]
                    start_pos = 0 if n <= T_dst else n - take
                    idx = (start_pos + torch.arange(take, device=pool_leaf.device)) % T_dst
                    pool_leaf[:, slot, idx] = entries[:, 0]
                else:
                    pool_leaf[:, slot] = new_leaf[:, 0]
    return pool
