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


class ShardedTrainStep:
    """``make_train_step`` tensor- and data-parallel over ``mesh``: the
    state and the batch are placed blocks (``dist.sharding.place``) of the
    reference's ``state_pspecs`` and of the batch spec (rows over the
    ``"batch"`` axes), and so is the new state.  The forward and the loss
    run in a tensor-parallel body (``models.tp``); the loss and the metrics
    are the global ones, the gradients psummed over the ranks that hold a
    block's copies, the clip norm the global norm; AdamW is elementwise on
    the blocks.  ``global_batch`` is the batch's global number of rows.

    ``options.microbatches = n`` accumulates the gradients of ``n``
    microbatches as the reference's scan does: microbatch ``i`` is the
    global rows ``[i·B/n, (i+1)·B/n)`` (not each data rank's rows split
    ``n`` ways: the MoE aux losses are not linear in the rows that share a
    microbatch), so :meth:`place_batch` lays a batch out as ``[n, B/n,
    ...]`` with ``B/n`` over the data axes, and each data rank holds its
    part of every microbatch; ``B/n`` must divide over the data ranks.
    The gradients accumulate ``g / n`` in microbatch order; the loss and
    the metrics are the means of the microbatches' global values.
    ``options.grad_compression = "int8"`` quantizes each gradient leaf with
    the scale of the whole leaf (a pmax of its blocks' maxima over the
    axes that shard it), so the result is the flat quantization's.

    On a single controller every rank is stacked on one device; on a
    process mesh each process holds its rank's blocks and every process
    calls the step, in the same order."""

    def __init__(self, cfg: ModelConfig, opt_cfg: opt.OptimizerConfig,
                 options: Optional[TrainOptions], mesh, global_batch: int, rules=None):
        import math

        from repro_torch.dist import param_specs as pspecs
        from repro_torch.dist.sharding import PartitionSpec as P
        from repro_torch.dist.sharding import _entry_axes, _valid_spec, default_rules

        options = options or TrainOptions()
        if options.grad_compression not in (None, "int8"):
            raise ValueError(f"unknown grad_compression {options.grad_compression!r}")
        self.cfg, self.opt_cfg, self.options, self.mesh = cfg, opt_cfg, options, mesh
        self.rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
        self.global_batch = global_batch
        shapes = init_train_state(None, cfg, device="meta")
        self.state_specs = pspecs.state_pspecs(shapes, self.rules, mesh)
        bax = self.rules.physical("batch")
        row = _valid_spec(mesh, P(bax), (global_batch,))[0]
        n = self.microbatches = max(1, int(options.microbatches))
        self.rows = global_batch // n  # one microbatch's global rows
        if n > 1:
            data = math.prod(mesh.shape[a] for a in _entry_axes(row))
            if global_batch % n or self.rows % data:
                raise ValueError(
                    f"{global_batch} rows in {n} microbatches of {global_batch / n:g} rows: a "
                    f"microbatch must split evenly over the {data} data ranks"
                )
        # one microbatch's tensors, and the placed batch ([n, B/n, ...] with
        # microbatches)
        self.mb_specs = {"tokens": P(row, None)}
        if cfg.modality in ("vision", "audio"):
            self.mb_specs["modality"] = P(row, None, None)
        self.batch_specs = self.mb_specs if n == 1 else {
            k: P(None, *tuple(s)) for k, s in self.mb_specs.items()}

    def place_batch(self, batch: dict) -> dict:
        """A global batch (tensors or numpy arrays) as this process's rows
        (with microbatches, its rows of every microbatch: ``[n, B/n, ...]``
        placed)."""
        from repro_torch.dist.sharding import place

        n = self.microbatches
        if n > 1:
            batch = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
        return {k: place(v, self.mesh, self.batch_specs[k]) for k, v in batch.items()}

    def place(self, state: dict, batch: dict) -> tuple:
        """A global train state and batch as the step takes them."""
        from repro_torch.dist.sharding import place_tree

        return place_tree(state, self.state_specs, self.mesh), self.place_batch(batch)

    def _microbatch(self, batch: dict, i: int) -> dict:
        """Microbatch ``i`` of a placed batch, placed as a batch of
        ``B/n`` rows is."""
        if self.microbatches == 1:
            return batch
        lead = 0 if self.mesh.processes else len(self.mesh.axis_names)
        return {k: v.select(lead, i).contiguous() for k, v in batch.items()}

    def _loss(self, params, batch):
        """The global ``(loss, metrics)`` of placed ``params`` on one placed
        microbatch; the caller enters the tensor-parallel body."""
        from repro_torch.dist.sharding import P, _map_specs, enter, leave
        from repro_torch.models import tp

        mesh, cfg = self.mesh, self.cfg
        body = _map_specs(lambda x, s: enter(x, mesh, s), params, self.state_specs["params"])
        tokens = enter(batch["tokens"], mesh, self.mb_specs["tokens"])
        modality = None
        if "modality" in batch:
            modality = enter(batch["modality"], mesh, self.mb_specs["modality"])
        logits, aux = tp.forward_train(body, cfg, tokens, modality, self.options.remat,
                                       self.options.q_chunk, mesh, self.rows)
        ce, zloss = tp.cross_entropy(cfg, logits, tokens, self.rows, mesh, Z_LOSS)
        del logits, body
        ce, zloss = leave(ce, mesh, P()), leave(zloss, mesh, P())
        loss = ce + zloss
        metrics = {"ce": ce, "z_loss": zloss}
        if aux:
            aux = {k: leave(v, mesh, P()) for k, v in aux.items()}
            loss = loss + MOE_LB_WEIGHT * aux["moe_lb_loss"] + aux["moe_z_loss"]
            metrics.update(aux)
        return loss, metrics

    @torch.no_grad()
    def loss(self, params, batch):
        """``(loss, metrics)`` of placed ``params`` on a placed batch, the
        forward alone (no gradients; with microbatches, the means over
        them)."""
        from repro_torch.dist.sharding import tensor_parallel

        with tensor_parallel(self.mesh, self.rules):
            outs = [self._loss(params, self._microbatch(batch, i))
                    for i in range(self.microbatches)]
        return _mean_of(outs)

    def _value_and_grad_one(self, params, batch):
        from repro_torch.dist.sharding import reduce_placed, tensor_parallel

        live = lm.tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad(), tensor_parallel(self.mesh, self.rules):
            loss, metrics = self._loss(live, batch)
            flat = lm.leaves(live)
            grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        spec_leaves = lm.leaves(self.state_specs["params"])
        grads = {k: reduce_placed(g, self.mesh, spec_leaves[k]) for k, g in grads.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), grads

    def value_and_grad(self, params, batch):
        """``((loss, metrics), grads)`` of placed ``params`` on a placed
        batch: the global loss and metrics on every process, the gradients
        placed as the parameters are (with microbatches, accumulated as
        ``g / n`` in microbatch order, the loss and metrics their means)."""
        n = self.microbatches
        if n == 1:
            (loss, metrics), grads = self._value_and_grad_one(params, batch)
            return (loss, metrics), _unflatten(grads)
        acc, outs = None, []
        for i in range(n):
            out, grads = self._value_and_grad_one(params, self._microbatch(batch, i))
            if acc is None:
                acc = {k: torch.zeros_like(g) for k, g in grads.items()}
            for k, g in grads.items():
                acc[k].add_(g / n)
            del grads
            outs.append(out)
        return _mean_of(outs), _unflatten(acc)

    def compress(self, grads):
        """``options.grad_compression`` of placed gradients (the identity
        without it)."""
        if self.options.grad_compression != "int8":
            return grads
        from repro_torch.dist.compression import int8_roundtrip

        return int8_roundtrip(grads, self.state_specs["params"], self.mesh)

    def __call__(self, state, batch):
        params, opt_state = state["params"], state["opt_state"]
        (loss, metrics), grads = self.value_and_grad(params, batch)
        grads = self.compress(grads)
        new_params, new_opt_state, om = opt.adamw_update(
            self.opt_cfg, grads, opt_state, params, specs=self.state_specs["params"],
            mesh=self.mesh)
        metrics = dict(metrics, loss=loss, **om)
        return {"params": new_params, "opt_state": new_opt_state,
                "step": state["step"] + 1}, metrics


def _mean_of(outs: list) -> tuple:
    """``(loss, metrics)`` of one microbatch, or the means of several's
    (the reference's mean over its scan's stacked values)."""
    if len(outs) == 1:
        return outs[0]
    losses, metricses = zip(*outs)
    metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
    return torch.stack(list(losses)).mean(), metrics


def _unflatten(flat: dict) -> dict:
    """``{"a.b.c": leaf}`` (``lm.leaves``) as nested dicts."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, name = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = v
    return out


def init_placed_train_state(generator: Optional[torch.Generator], cfg: ModelConfig, mesh,
                            specs, device=None) -> dict:
    """``init_train_state`` as this process's blocks of ``specs``: the
    parameters drawn whole on ``device`` (the same draws as
    ``init_train_state``) and placed leaf by leaf, the moments zeros of
    the blocks' shapes; no whole moment is ever made."""
    from repro_torch.dist.sharding import place

    params = lm.init_params(cfg, generator=generator, device=device)
    flat = lm.leaves(params)
    del params
    pspecs = lm.leaves(specs["params"])
    placed = {k: place(flat.pop(k), mesh, pspecs[k]) for k in list(flat)}
    dev = lm.default_device(device)

    def zeros():
        return _unflatten({k: torch.zeros_like(t) for k, t in placed.items()})

    return {
        "params": _unflatten(placed),
        "opt_state": {"m": zeros(), "v": zeros(),
                      "count": torch.zeros((), dtype=torch.int32, device=dev)},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
