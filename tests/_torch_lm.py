"""Language-model configs on both sides, for the port's tests: the
reference's parameters (``repro.models.lm.init_params``) and the port's
copy of them (``repro_torch.interop.params_from_numpy``), with inputs made
from seeds with numpy."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as rget_config
from repro.configs.base import reduced_config as rreduced
from repro.models import lm as rlm
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import lm

B, S = 2, 16


def cfgs(arch, **kw):
    return (
        dataclasses.replace(rreduced(rget_config(arch)), **kw),
        dataclasses.replace(reduced_config(get_config(arch)), **kw),
    )


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def flat(out):
    """The tensors of an output: logits, (logits, aux) or (logits, cache)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [v for _, v in sorted(lm.leaves(out).items())]
    return [t for o in out for t in flat(o)]


def batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n_text = S - (cfg.num_modality_tokens if cfg.modality == "vision" else 0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, n_text)).astype(np.int32)
    modality = None
    if cfg.modality == "vision":
        modality = rng.standard_normal((B, cfg.num_modality_tokens, cfg.modality_dim))
    elif cfg.modality == "audio":
        modality = rng.standard_normal((B, S, cfg.modality_dim))
    return tokens, None if modality is None else modality.astype(np.float32)


class Pair:
    """One config on both sides: the reference's params and the port's copy."""

    def __init__(self, arch, dtype="float32", seed=0):
        self.arch = arch
        self.rcfg, self.cfg = cfgs(arch, dtype=dtype)
        self.rparams = rlm.init_params(jax.random.PRNGKey(seed), self.rcfg)
        self.params = params_from_numpy(self.cfg, to_numpy(self.rparams), device="cpu")
        self.tokens, self.modality = batch(self.cfg, seed + 1)

    def inputs(self):
        rmod = None if self.modality is None else jnp.asarray(self.modality)
        mod = None if self.modality is None else torch.from_numpy(self.modality)
        return (jnp.asarray(self.tokens), rmod), (torch.from_numpy(self.tokens).long(), mod)

    def noise(self, run) -> float:
        """How far ``run(params)``'s outputs move when every parameter moves
        by a relative 2**-24 of seeded noise."""
        g = torch.Generator().manual_seed(0)
        moved = lm.tree_map(
            lambda a: a * (1 + 2.0**-24 * torch.randn(a.shape, generator=g)), self.params)
        return max(float((a - b).abs().max()) for a, b in zip(flat(run(self.params)), flat(run(moved))))

    @property
    def n(self) -> int:
        """Positions of the prompt (vision: patches and text)."""
        vis = self.cfg.num_modality_tokens if self.cfg.modality == "vision" else 0
        return self.tokens.shape[1] + vis
