"""The port's launch layer: the production meshes (``launch.mesh``), the
step builders (``launch.steps``), the dry run (``launch.dryrun``), the
roofline of its records (``launch.roofline``), ``lower()`` of a stencil
and the model flags.

The dry run's ``memory.argument_bytes`` is exact: for granite-moe-1b-a400m
train_4k on 16×16 and yi-9b decode_32k on 2×16×16 it equals the bytes of
one rank computed from the reference's own spec trees
(``jax.eval_shape`` + ``state_pspecs``/``param_pspecs``/``cache_pspecs``,
with a stand-in mesh of the production shape).
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.dist import param_specs as rps
from repro.dist import sharding as rsh
from repro.launch import steps as rsteps
from repro.models import lm as rlm
from repro.train.train_step import init_train_state as rinit_train_state
from repro_torch.configs import get_config, get_shape, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import Mesh
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import flags, lm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainOptions, init_train_state, make_train_step


class StandIn:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def test_production_meshes():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and tuple(m.shape.values()) == (16, 16)
    assert m.size == 256 and m.device_type == "cpu"
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and tuple(m.shape.values()) == (2, 16, 16)
    m = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch,shape_name", [
    ("granite-moe-1b-a400m", "train_4k"), ("qwen2-7b", "prefill_32k"), ("yi-9b", "decode_32k"),
])
def test_build_step_on_meta_tensors(arch, shape_name):
    cfg, shape = get_config(arch), get_shape(shape_name)
    mesh = make_production_mesh()
    fn, args, in_specs, out_specs = steps.build_step(cfg, shape, mesh)
    assert callable(fn) and len(args) == len(in_specs) == 2
    for a_tree, s_tree in zip(args, in_specs):
        a, s = list(_leaves(a_tree)), list(_leaves(s_tree))
        assert len(a) == len(s) and all(t.device.type == "meta" for t in a)
    batch = steps.input_specs(cfg, shape, mesh)
    if shape.kind == "decode":
        assert batch["token"].meta.shape == (shape.global_batch,)
        assert batch["token"].meta.dtype == torch.int32 and batch["pos"].meta.shape == ()
        k = batch["cache"]["slot0"]["k"]
        assert tuple(k.spec) == (None, "data", "model", None, None)  # yi: 4 KV heads → "seq"
        assert tuple(out_specs[0]) == ("data",)
    else:
        assert batch["tokens"].meta.shape == (shape.global_batch, shape.seq_len)
        assert tuple(batch["tokens"].spec) == ("data", None)
    if shape.kind == "train":
        assert out_specs[0] is in_specs[0]


def _ref_local_bytes(shapes, specs, mesh) -> int:
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, rsh.P))):
        n = 1
        for d, size in enumerate(leaf.shape):
            e = spec[d] if d < len(spec) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= size // math.prod(mesh.shape[a] for a in axes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _reference_argument_bytes(arch, shape_name, multi_pod) -> int:
    cfg, shape = rget_config(arch), get_shape(shape_name)
    mesh = StandIn({"pod": 2, "data": 16, "model": 16} if multi_pod
                   else {"data": 16, "model": 16})
    rules = rsh.default_rules(multi_pod)
    B, S = shape.global_batch, shape.seq_len
    bax = rules.physical("batch")
    if shape.kind == "train":
        st = jax.eval_shape(lambda: rinit_train_state(jax.random.PRNGKey(0), cfg))
        tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
        return (_ref_local_bytes(st, rps.state_pspecs(st, rules, mesh), mesh)
                + _ref_local_bytes(tokens, rsh._valid_spec(mesh, rsh.P(bax, None), (B, S)), mesh))
    params = jax.eval_shape(lambda: rlm.init_params(jax.random.PRNGKey(0), cfg))
    cache = jax.eval_shape(lambda: rlm.init_cache(cfg, B, S))
    token = jax.ShapeDtypeStruct((B,), jnp.int32)
    return (_ref_local_bytes(params, rps.param_pspecs(params, rules, mesh), mesh)
            + _ref_local_bytes(token, rsh._valid_spec(mesh, rsh.P(bax), (B,)), mesh)
            + 4
            + _ref_local_bytes(cache, rsteps.cache_pspecs(cfg, cache, mesh, rules), mesh))


@pytest.fixture(scope="module")
def dry_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = [dryrun.run_cell("granite-moe-1b-a400m", "train_4k", False, str(out)),
            dryrun.run_cell("yi-9b", "decode_32k", True, str(out))]
    return out, recs


def test_dry_run_argument_bytes_equal_the_reference_specs(dry_records):
    out, recs = dry_records
    for rec, mp in zip(recs, (False, True)):
        want = _reference_argument_bytes(rec["arch"], rec["shape"], mp)
        assert rec["memory"]["argument_bytes"] == want, rec["arch"]
        with open(out / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json") as f:
            assert json.load(f)["memory"]["argument_bytes"] == want


def test_dry_run_records_name_every_stand_in(dry_records):
    _, recs = dry_records
    granite, yi = recs
    for rec in recs:
        assert rec["ok"] and rec["cost"]["flops"] > 0
        assert rec["memory"]["temp_bytes"] is None and rec["memory"]["peak_bytes"] is None
        assert rec["cost"]["bytes_accessed"] is None
        for key in ("flops", "temp_bytes", "peak_bytes", "collective_bytes"):
            assert rec["notes"][key]
        assert rec["n_layout_constraints"] > 0
    assert granite["n_devices"] == 256 and yi["n_devices"] == 512
    # expert parallelism moves tokens by all-to-all; the seq-sharded decode
    # combines by all-reduce
    assert granite["collective_bytes"]["all-to-all"] > 0
    assert set(yi["collective_bytes"]) == {"all-reduce"}
    # a train step does at least the forward's 2·N·D of its active params
    tokens = 256 * 4096
    assert granite["cost"]["flops"] * 256 > 6 * granite["active_params"] * tokens


def test_roofline_reads_the_records(dry_records):
    out, _ = dry_records
    cells = roofline.load_cells(str(out))
    assert sorted((c.arch, c.mesh) for c in cells) == [
        ("granite-moe-1b-a400m", "16x16"), ("yi-9b", "2x16x16")]
    for c in cells:
        assert c.t_compute > 0 and c.t_memory_analytic > 0 and c.dominant
        assert 0 < c.roofline_fraction <= 1
    text = roofline.report(cells, mesh="16x16")
    assert "granite-moe-1b-a400m" in text and "yi-9b" not in text
    md = roofline.report(cells, markdown=True, mesh="2x16x16")
    assert md.startswith("| arch |") and "yi-9b" in md
    assert roofline.fmt_s(2.5) == "2.50s" and roofline.fmt_s(0.0025) == "2.5ms"


CPU_MESH = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(2, 4), ("data", "model"))


def _real(tree, gen):
    def one(t):
        if t.dtype == torch.int32:
            return torch.randint(0, 100, t.shape, generator=gen, dtype=torch.int32)
        return torch.randn(t.shape, generator=gen).to(t.dtype)
    return lm.tree_map(one, tree)


def test_build_step_runs_on_cpu_ranks():
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(reduced_config(get_config("granite-moe-1b-a400m")), dtype="float32")
    fn, args, _, _ = steps.build_step(cfg, ShapeConfig("t", 16, 4, "train"), CPU_MESH)
    state = init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
    batch = _real(args[1], gen)
    new, metrics = fn(state, batch)
    flat_new, flat_metrics = make_train_step(cfg, opt.OptimizerConfig(),
                                             TrainOptions(q_chunk=16))(state, batch)
    # the cross-entropy is the flat one; the aux losses differ by design
    # (data shard 0's under expert parallelism: tests/torch_lm_dist_worker.py)
    torch.testing.assert_close(metrics["ce"], flat_metrics["ce"], rtol=1e-5, atol=1e-5)
    assert int(new["step"]) == 1
    for k, v in lm.leaves(new["params"]).items():
        assert v.shape == lm.leaves(flat_new["params"])[k].shape and bool(v.isfinite().all()), k

    cfg = dataclasses.replace(reduced_config(get_config("yi-9b")), dtype="float32")
    params = lm.init_params(cfg, device="cpu")
    fn, args, _, _ = steps.build_step(cfg, ShapeConfig("p", 16, 4, "prefill"), CPU_MESH)
    batch = _real(args[1], gen)
    logits, cache = fn(params, batch)
    flat_logits, _ = lm.forward_prefill(params, cfg, batch["tokens"], q_chunk=16)
    assert torch.equal(logits, flat_logits)

    fn, args, _, out_specs = steps.build_step(cfg, ShapeConfig("d", 32, 4, "decode"), CPU_MESH)
    batch = _real(args[1], gen)
    batch["pos"] = torch.tensor(20, dtype=torch.int32)
    assert tuple(out_specs[1]["slot0"]["k"]) == (None, "data", "model", None, None)
    flat_cache = lm.tree_map(torch.clone, batch["cache"])
    flat_logits, _ = lm.decode_step(params, cfg, batch["token"], batch["pos"], flat_cache)
    logits, _ = fn(params, batch)
    torch.testing.assert_close(logits, flat_logits, rtol=2e-5, atol=2e-5)


def test_lower_gives_one_ranks_meta_arguments():
    import _torch_programs as P
    from repro_torch import api
    from repro_torch.core.passes.decompose import make_strategy_2d
    from repro_torch.core.program import CompileOptions, StencilComputation

    prog = P.heat("repro_torch", (64, 64), 4)
    mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    lowered = api.compile(prog, api.Target(mesh=mesh, strategy=make_strategy_2d((2, 2)),
                                           device="cpu")).lower()
    assert [tuple(a.shape) for a in lowered.args] == [(32, 32)] * len(prog.field_args)
    assert all(a.device.type == "meta" for a in lowered.args)
    assert lowered.argument_bytes == 32 * 32 * 4 * len(prog.field_args)
    assert api.compile(prog, api.Target(device="cpu")).lower().argument_bytes == (
        64 * 64 * 4 * len(prog.field_args))
    with pytest.warns(DeprecationWarning):
        sc = StencilComputation(prog.func, boundary=prog.boundary)
    got = sc.lower(mesh, make_strategy_2d((2, 2)), CompileOptions(device="cpu"))
    assert got.argument_bytes == lowered.argument_bytes and sc.last_local is not None


def test_flags_change_nothing_but_keep_the_api():
    assert flags.unroll_scans() is False and flags.scan_unroll_arg() == 1
    with flags.set_unroll_scans(True):
        assert flags.unroll_scans() is True and flags.scan_unroll_arg() is True
    assert flags.unroll_scans() is False
