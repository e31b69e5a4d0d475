"""The port's sharding rules, layout policy and spec trees
(``repro_torch.dist.sharding``, ``dist.param_specs``, ``launch.steps``)
against the reference's, spec for spec.

Both packages read a mesh only through ``.shape`` (and ``.axis_names`` for
the default rules), so one stand-in mesh of the production shapes — 16×16
(data, model) and 2×16×16 (pod, data, model) — serves both sides without
256 devices.  The trees are the ten configs at published width: the
reference's through ``jax.eval_shape``, the port's on meta tensors.
"""
import itertools

import jax
import pytest

from repro.configs import get_config as rget_config
from repro.dist import param_specs as rps
from repro.dist import sharding as rsh
from repro.launch import steps as rsteps
from repro.models import lm as rlm
from repro.train.train_step import init_train_state as rinit_train_state
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.dist import param_specs as ps
from repro_torch.dist import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.train.train_step import init_train_state


class StandIn:
    """A mesh as both packages read it: axis sizes by name."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": StandIn({"data": 16, "model": 16}),
    "2x16x16": StandIn({"pod": 2, "data": 16, "model": 16}),
}
SMALL = [StandIn({"data": 2, "model": 4}), StandIn({"data": 1, "model": 8}),
         StandIn({"data": 8, "model": 1}), StandIn({"pod": 2, "data": 2, "model": 2})]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: tuple(tree)}


def _rules(mesh):
    multi = "pod" in mesh.axis_names
    return rsh.default_rules(multi_pod=multi), sh.default_rules(multi_pod=multi)


def test_default_rules_equal():
    for multi in (False, True):
        assert dict(sh.default_rules(multi).table) == dict(rsh.default_rules(multi).table)


SPECS = [
    ("data", "model"), ("model", "model"), (("pod", "data"), None), (("data", "model"),),
    (None, "model", None), ("data", ("model", "pod")), ("nope", "data"), (("data", "nope", "model"),),
]
SHAPES = [(1,), (2, 3), (16, 256), (32, 16, 8), (4096, 4096), (128, 32768, 8, 128), (6, 10, 12)]


@pytest.mark.parametrize("mesh", list(MESHES.values()) + SMALL, ids=lambda m: str(m.shape))
def test_valid_spec_equals_reference(mesh):
    for spec, shape in itertools.product(SPECS, SHAPES):
        want = rsh._valid_spec(mesh, rsh.P(*spec), shape)
        got = sh._valid_spec(mesh, sh.P(*spec), shape)
        assert tuple(got) == tuple(want), (mesh.shape, spec, shape)


@pytest.mark.parametrize("mesh", list(MESHES.values()) + SMALL, ids=lambda m: str(m.shape))
def test_kv_cache_layout_equals_reference(mesh):
    seen = set()
    for B, T, Kh in itertools.product((1, 2, 3, 8, 32, 128), (1, 30, 64, 4096, 32768, 524288),
                                      (1, 2, 4, 8, 16, 32)):
        for multi in (False, True):
            rr, pr = rsh.default_rules(multi), sh.default_rules(multi)
            want = rsh.kv_cache_layout(B, T, Kh, mesh, rr)
            assert sh.kv_cache_layout(B, T, Kh, mesh, pr) == want, (mesh.shape, B, T, Kh, multi)
            seen.add(want)
    assert sh.kv_cache_layout(8, 64, 2, None) == rsh.kv_cache_layout(8, 64, 2, None) == "flat"
    if mesh.shape.get("model", 1) > 1:
        assert {"heads", "seq_all"} <= seen, seen
    if min(mesh.shape.values()) > 1:
        assert {"heads", "seq", "seq_all", "batch"} <= seen, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_pspecs_equal_reference(arch):
    rcfg, cfg = rget_config(arch), get_config(arch)
    rparams = jax.eval_shape(lambda: rlm.init_params(jax.random.PRNGKey(0), rcfg))
    rstate = jax.eval_shape(lambda: rinit_train_state(jax.random.PRNGKey(0), rcfg))
    params = lm.init_params(cfg, device="meta")
    state = init_train_state(None, cfg, device="meta")
    for mesh in MESHES.values():
        rr, pr = _rules(mesh)
        want = _flat(rps.param_pspecs(rparams, rr, mesh))
        got = _flat(ps.param_pspecs(params, pr, mesh))
        assert got == want, (arch, mesh.shape)
        want = _flat(rps.state_pspecs(rstate, rr, mesh))
        got = _flat(ps.state_pspecs(state, pr, mesh))
        assert got == want, (arch, mesh.shape)
        # some leaf really is split on every config
        assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_reference(arch):
    rcfg, cfg = rget_config(arch), get_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        shape = get_shape(shape_name)
        B, S = shape.global_batch, shape.seq_len
        mem = S if cfg.is_encoder_decoder else 0
        rcache = jax.eval_shape(lambda: rlm.init_cache(rcfg, B, S, memory_len=mem))
        cache = lm.init_cache(cfg, B, S, memory_len=mem, device="meta")
        for mesh in MESHES.values():
            rr, pr = _rules(mesh)
            want = _flat(rsteps.cache_pspecs(rcfg, rcache, mesh, rr))
            got = _flat(steps.cache_pspecs(cfg, cache, mesh, pr))
            assert got == want, (arch, shape_name, mesh.shape)


def test_shard_records_and_returns_input_unchanged():
    import torch

    x = torch.randn(4, 6, 8)
    assert sh.shard(x, "batch", "seq", "embed_act") is x  # no mesh: at once
    mesh = sh.Mesh([[torch.device("cpu")] * 4] * 2, ("data", "model"))
    with sh.use_mesh(mesh), sh.recording() as log:
        assert sh.active_mesh() is mesh
        y = sh.shard(x, "batch", None, "mlp_act")
    assert y is x and torch.equal(y, x)
    assert log == [((4, 6, 8), sh.P("data", None, "model"))]
    assert sh.active_mesh() is None
