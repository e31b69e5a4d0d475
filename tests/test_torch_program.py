"""The port's deprecated compile surface (``repro_torch.core.program``),
the devito-like frontend's legacy ``mesh``/``strategy``/``options``
spelling and the pipeline dump CLI (``python -m repro_torch.core.passes``)
against the reference's.

The shims delegate to ``repro_torch.api``: a step compiled through them is
the step ``repro_torch.api.compile`` builds for the same ``Target``, so
their results are bitwise the same.
"""
import re
import warnings

import numpy as np
import pytest
import torch

import _torch_programs as P
from repro.core import ir as rir
from repro.core import program as rprogram
from repro.core.passes import __main__ as rpasses_cli
from repro_torch import api
from repro_torch.api import Target
from repro_torch.core import ir
from repro_torch.core import program
from repro_torch.core.passes import __main__ as passes_cli
from repro_torch.core.passes.decompose import make_strategy_2d
from repro_torch.dist import Mesh
from repro_torch.frontends.devito_like import Eq, Grid, Operator, TimeFunction
from repro_torch.interop import state_from_numpy

CPU = dict(device="cpu")


def _heat_op(shape=(12, 10)):
    g = Grid(shape=shape, extent=(1.0, 1.0))
    u = TimeFunction(name="u", grid=g, space_order=2)
    return Operator(Eq(u.dt, 0.5 * u.laplace), dt=1e-4)


def _state(prog, seed=0):
    return state_from_numpy(prog, P.rand_state(prog, seed), device="cpu")


def test_shims_warn_as_the_reference_does():
    func = P.heat("repro_torch", (8, 8), 2).func
    with pytest.warns(DeprecationWarning, match="StencilComputation is deprecated"):
        program.StencilComputation(func)
    with pytest.warns(DeprecationWarning, match="comm_dialect is a deprecated no-op"):
        program.CompileOptions(comm_dialect=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        program.CompileOptions(backend="cuda", **CPU)  # no warning without the flag


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_stencil_computation_compile_is_api_compile(backend):
    """The shim's artifact is the cached ``api.compile`` artifact of the
    same Target, and its steps are bitwise the same."""
    prog = P.wave("repro_torch", (16, 12), 4)
    with pytest.warns(DeprecationWarning):
        sc = program.StencilComputation(prog.func)
    opts = program.CompileOptions(backend=backend, **CPU)
    got = sc.compile(options=opts)
    want = api.compile(sc.program, Target(backend=backend, **CPU))
    assert got is want
    assert sc.last_pipeline == want.pipeline_report.spec == program.default_pipeline(opts)
    assert [name for name, _ in sc.last_timings] == [
        name for name, _ in want.pipeline_report.timings
    ]
    assert ir.print_module(sc.last_local) == ir.print_module(want.local_ir)
    state = _state(prog)
    a = got.time_loop(state, 4)
    b = api.compile(prog, Target(backend=backend, **CPU)).time_loop(state, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    zeros = sc.global_zeros(**CPU)
    assert [tuple(z.shape) for z in zeros] == [(16, 12)] * len(prog.field_args)
    assert all(z.dtype == torch.float32 and z.device.type == "cpu" for z in zeros)


def test_prepare_local_and_partition_specs_match_the_reference():
    ref = P.heat("repro", (16, 16), 4)
    port = P.heat("repro_torch", (16, 16), 4)
    with pytest.warns(DeprecationWarning):
        rsc = rprogram.StencilComputation(ref.func)
    with pytest.warns(DeprecationWarning):
        sc = program.StencilComputation(port.func)
    strat = make_strategy_2d((2, 2))
    from repro.core.passes.decompose import make_strategy_2d as rmake

    opts = dict(overlap=True, diagonal=True)
    local = sc.prepare_local(strat, program.CompileOptions(**opts))
    rlocal = rsc.prepare_local(rmake((2, 2)), rprogram.CompileOptions(**opts))
    assert ir.print_module(local) == rir.print_module(rlocal)
    assert sc.last_pipeline == rsc.last_pipeline
    assert [tuple(s) for s in sc.partition_specs(strat)] == [
        tuple(s) for s in rsc.partition_specs(rmake((2, 2)))
    ]


@pytest.mark.parametrize(
    "flags",
    [
        {},
        {"fuse": False},
        {"cse": False},
        {"overlap": True},
        {"diagonal": True, "overlap": True},
        {"fuse": False, "cse": False, "diagonal": True},
        {"pipeline": "fuse,decompose,lower-comm"},
    ],
    ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()) or "default",
)
def test_default_pipeline_matches_the_reference(flags):
    got = program.default_pipeline(program.CompileOptions(**flags))
    want = rprogram.default_pipeline(rprogram.CompileOptions(**flags))
    assert got == want


def test_distributed_compile_through_the_shim():
    """``compile(mesh, strategy, options)`` is the Target of those fields:
    four CPU ranks, bitwise against one device."""
    prog = P.heat("repro_torch", (16, 16), 2)
    with pytest.warns(DeprecationWarning):
        sc = program.StencilComputation(prog.func)
    mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    dist = sc.compile(mesh, make_strategy_2d((2, 2)), program.CompileOptions(backend="cuda"))
    assert dist.target.mesh is mesh and dist.target.backend == "cuda"
    state = _state(prog, 2)
    one = api.compile(prog, Target(backend="cuda", **CPU)).time_loop(state, 3)
    assert torch.equal(dist.time_loop(state, 3)[0], one[0])


def test_devito_legacy_spelling():
    op = _heat_op()
    (u0,) = _state(op.program, 1)
    opts = program.CompileOptions(backend="cuda", **CPU)
    (a,) = op.apply((u0,), timesteps=3, options=opts)
    (b,) = op.apply((u0,), timesteps=3, target=Target(backend="cuda", **CPU))
    assert torch.equal(a, b)
    step = op.compile_step(options=opts)
    c = u0
    for _ in range(3):
        (c,) = step(c)
    assert torch.equal(a, c)
    mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    (d,) = op.apply((u0,), 3, mesh, make_strategy_2d((2, 2)), opts)
    assert torch.equal(a, d)
    with pytest.warns(DeprecationWarning):
        comp = op.computation
    assert op.computation is comp  # built once
    assert comp.func is op.func and comp.boundary == op.boundary


@pytest.mark.parametrize(
    "legacy",
    [
        {"options": program.CompileOptions(**CPU)},
        {"mesh": "any"},
        {"strategy": make_strategy_2d((1, 1))},
    ],
    ids=["options", "mesh", "strategy"],
)
def test_devito_target_and_legacy_arguments_refused_together(legacy):
    op = _heat_op()
    target = Target(**CPU)
    with pytest.raises(ValueError, match="not both"):
        op.apply(op.zero_state(**CPU), 1, target=target, **legacy)
    with pytest.raises(ValueError, match="not both"):
        op.compile_step(target=target, **legacy)


_TIMING = re.compile(r"^//\s+\S+\s+[0-9.]+ ms$|run #\d+")


def _cli(main, argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    return [ln for ln in lines if not _TIMING.search(ln)]


@pytest.mark.parametrize(
    "argv",
    [
        ["--quiet"],
        ["--quiet", "--program", "box", "--shape", "24x16"],
        ["--quiet", "--program", "chain", "--boundary", "zero",
         "fuse,cse,dce,decompose{grid=2x1},swap-elim,diagonal,lower-comm"],
        ["--program", "chain", "fuse,decompose{grid=2x2},lower-comm"],
    ],
    ids=["default", "box", "chain-diagonal", "chain-full-ir"],
)
def test_passes_cli_prints_the_reference_trajectory(argv, capsys):
    got = _cli(passes_cli.main, argv, capsys)
    want = _cli(rpasses_cli.main, argv, capsys)
    assert any("after lower-comm" in ln for ln in got)
    assert got == want


_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
_COPIES = sorted(
    str(p.relative_to(_ROOT))
    for p in [*(_ROOT / "src/repro_torch/configs").glob("*.py"),
              _ROOT / "src/repro_torch/core/passes/__main__.py"]
)


@pytest.mark.parametrize("path", _COPIES)
def test_copied_files_match_their_sources(path):
    """The configs and the passes CLI are copies: after a one-line header
    naming the source, the source with ``repro.`` renamed to
    ``repro_torch.`` (``configs/base.py`` also drops its unused
    ``import jax.numpy as jnp``)."""
    lines = (_ROOT / path).read_text().splitlines()
    source = re.match(r"# Copied from (\S+) ", lines[0]).group(1)
    assert source == path.replace("repro_torch", "repro")
    want = (_ROOT / source).read_text().replace("repro.", "repro_torch.").splitlines()
    if path.endswith("configs/base.py"):
        want.remove("import jax.numpy as jnp")
    assert lines[1:] == want
