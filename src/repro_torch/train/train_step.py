"""Loss + train step construction (port of ``repro.train.train_step``).

``make_train_step`` builds the ``(state, batch) → (state, metrics)``
function: next-token cross-entropy (+ z-loss + MoE aux), optional
gradient-accumulation microbatching (a loop over microbatches, the
reference's ``lax.scan``), global-norm clip, AdamW.  Gradients come from
``torch.autograd``; ``TrainOptions.remat`` recomputes each supercell in
the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).  A step is functional: the state it is given is left
as it was.

A state is ``{"params", "opt_state": {"m", "v", "count"}, "step"}`` with
the parameters as ``repro_torch.models.lm``'s nested dict; a batch is
``{"tokens": [B, S] int, "modality"?: [B, M, D] float}`` of tensors on the
parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.train import optimizer as opt

Z_LOSS = 1e-4
MOE_LB_WEIGHT = 1e-2


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    remat: bool = True
    q_chunk: int = 1024
    microbatches: int = 1
    grad_compression: Optional[str] = None  # None | "int8" (dist/compression)


def cross_entropy_loss(cfg: ModelConfig, logits, tokens):
    """Next-token CE over text positions (skips modality prefix)."""
    S_tok = tokens.shape[1]
    prefix = logits.shape[1] - S_tok  # vision tokens prepended
    logits = logits[:, prefix:, :]
    pred = logits[:, :-1]
    tgt = tokens[:, 1:].long()
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, tgt[..., None])[..., 0]
    ce = (logz - gold).mean()
    zloss = Z_LOSS * torch.square(logz).mean()
    return ce, zloss


def make_loss_fn(cfg: ModelConfig, options: TrainOptions):
    def loss_fn(params, batch):
        logits, aux = lm.forward_train(
            params,
            cfg,
            batch["tokens"],
            batch.get("modality"),
            remat=options.remat,
            q_chunk=options.q_chunk,
        )
        ce, zloss = cross_entropy_loss(cfg, logits, batch["tokens"])
        loss = ce + zloss
        metrics = {"ce": ce, "z_loss": zloss}
        if aux:
            loss = loss + MOE_LB_WEIGHT * aux["moe_lb_loss"] + aux["moe_z_loss"]
            metrics.update(aux)
        return loss, metrics

    return loss_fn


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` through autograd:
    ``(params, batch) → ((loss, metrics), grads)``, every result detached
    and the gradients a nested dict like ``params``."""

    def run(params, batch):
        live = lm.tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            grads = iter(torch.autograd.grad(loss, list(lm.leaves(live).values())))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), lm.tree_map(lambda _: next(grads), live)

    return run


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: opt.OptimizerConfig,
    options: Optional[TrainOptions] = None,
):
    options = options or TrainOptions()
    loss_fn = make_loss_fn(cfg, options)
    grad_fn = value_and_grad(loss_fn)

    def compute_grads(params, batch):
        if options.microbatches <= 1:
            (loss, metrics), grads = grad_fn(params, batch)
            return loss, metrics, grads

        n = options.microbatches
        acc = lm.tree_map(torch.zeros_like, params)
        losses, metricses = [], []
        for i in range(n):
            mb = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
                  for k, x in batch.items()}
            (loss, metrics), grads = grad_fn(params, mb)
            acc = lm.tree_map(lambda a, g: a.add_(g / n), acc, grads)
            del grads
            losses.append(loss)
            metricses.append(metrics)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, acc

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt_state"]
        loss, metrics, grads = compute_grads(params, batch)
        if options.grad_compression == "int8":
            from repro_torch.dist.compression import int8_roundtrip

            grads = int8_roundtrip(grads)
        new_params, new_opt_state, om = opt.adamw_update(
            opt_cfg, grads, opt_state, params
        )
        metrics = dict(metrics, loss=loss, **om)
        new_state = {
            "params": new_params,
            "opt_state": new_opt_state,
            "step": state["step"] + 1,
        }
        return new_state, metrics

    return train_step


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig, device=None) -> dict:
    """Random float32 parameters (``lm.init_params`` from ``generator`` on
    ``device``, default the card; ``device="meta"`` gives the shapes
    alone), zero moments and step 0."""
    params = lm.init_params(cfg, generator=generator, device=device)
    dev = lm.default_device(device)
    return {
        "params": params,
        "opt_state": opt.init_opt_state(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
