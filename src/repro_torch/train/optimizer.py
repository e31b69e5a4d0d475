"""AdamW with decoupled weight decay, global-norm clipping, and
warmup+cosine schedule (port of ``repro.train.optimizer``).

Parameters, gradients and moments are nested dicts of tensors (the port's
model parameters, ``repro_torch.models.lm``); a leaf's path is the tuple
of its dict keys, and the global norm sums the leaves in the reference's
pytree order (dict keys sorted).  The update is functional: it returns
new tensors and leaves its inputs as they were, so a caller can still
drop a step (the trainer's NaN guard).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.lm import tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def paths(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf), ...]`` of a nested dict in the reference's flatten
    order (dict keys sorted, as ``jax.tree_util`` sorts them)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def map_with_path(fn, tree, *rest, prefix: tuple = ()):
    """``fn(path, leaf, *matching leaves of rest)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), prefix=prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * (step + 1.0) / max(cfg.warmup_steps, 1)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.peak_lr * (
        cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    device = paths(params)[0][1].device
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for _, l in paths(tree)))


def _decay_mask(path: tuple) -> bool:
    """No weight decay on norms/biases/1-d scales."""
    last = str(path[-1]) if path else ""
    return not any(tok in last for tok in ("norm", "bias", "b_gates", "bf", "bq", "bk", "bv", "A_log", "D", "dt_bias"))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)

    count = opt_state["count"] + 1
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    def leaf(path, p, g, m, v):
        g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if _decay_mask(path):
            update = update + cfg.weight_decay * p
        return p - lr * update, m, v

    new = map_with_path(leaf, params, grads, opt_state["m"], opt_state["v"])

    def part(i):
        return tree_map(lambda t: t[i], new)

    return (
        part(0),
        {"m": part(1), "v": part(2), "count": count},
        {"grad_norm": gnorm, "lr": lr},
    )
