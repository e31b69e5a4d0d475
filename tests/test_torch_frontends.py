"""The port's psyclone-like frontend (``repro_torch.frontends.psyclone_like``)
against the reference's: the psyclone part of ``tests/test_frontends.py``
and the fig-10 kernels of ``benchmarks/fig10_advection.py``.

The same kernel functions recognized by both packages print, fingerprint
and lower to the same IR text; PW advection fuses to one apply with three
results; PW and tracer advection run within rtol=atol=1e-5 of the
reference, and over a 2×2×1 mesh of CPU ranks bitwise equal to the port's
single-device run.  ``i``, ``j``, ``k`` in the kernels below are loop
indices the recognizer reads from the source; the functions never run.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.core import ir as rir
from repro.frontends import psyclone_like as rpsy
from repro_torch import api
from repro_torch.api import Target
from repro_torch.core import ir
from repro_torch.core.dialects import stencil
from repro_torch.core.passes.decompose import make_strategy_2d, make_strategy_3d
from repro_torch.dist import Mesh
from repro_torch.frontends import psyclone_like as psy

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from benchmarks import fig10_advection as fig10  # noqa: E402
import chip_smoke  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def jacobi(u, out):
    out[i, j] = 0.25 * (u[i - 1, j] + u[i + 1, j] + u[i, j - 1] + u[i, j + 1])  # noqa: F821


def flux_chain(u, flux, out):
    flux[i, j] = 0.5 * (u[i + 1, j] - u[i - 1, j])  # noqa: F821
    out[i, j] = u[i, j] - 0.1 * (flux[i + 1, j] - flux[i, j])  # noqa: F821


def vertical(u, out):
    out[i, j, k] = (u[i, j, k - 1] + u[i, j, k + 1]) * 0.5  # noqa: F821


def offset_store(u, out):
    out[i + 1, j] = u[i, j]  # noqa: F821


# name -> (kernel, shape)
KERNELS = {
    "jacobi": (jacobi, (20, 20)),
    "flux-chain": (flux_chain, (16, 16)),
    "vertical-3d": (vertical, (8, 8, 8)),
    "pw-advection": (fig10.pw_advection, (16, 16, 8)),
    "tracer-advection": (fig10.tracer_advection, (16, 16, 8)),
}


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_recognized_program_matches_the_reference(name, boundary):
    """Same printed module, fingerprint and field names, and the same
    rank-local IR after the default pipeline."""
    kern, shape = KERNELS[name]
    ref = rpsy.recognize(kern, shape, boundary=boundary)
    port = psy.recognize(kern, shape, boundary=boundary)
    assert ir.print_module(port.func) == rir.print_module(ref.func)
    assert port.fingerprint == ref.fingerprint
    assert port.field_names == ref.field_names
    want = rapi.compile(ref, rapi.Target(jit=False))
    got = api.compile(port, Target(device="cpu"))
    assert ir.print_module(got.local_ir) == rir.print_module(want.local_ir)
    assert got.kernel_dispatches == want.kernel_dispatches


@pytest.mark.parametrize("name", ["pw_advection", "tracer_advection"])
def test_chip_smoke_runs_the_benchmark_kernels(name):
    """``chip_smoke.py`` carries its own copy of the fig-10 kernels (it may
    import nothing of the reference): the copy is the same program."""
    shape = (16, 16, 8)
    ours = psy.recognize(getattr(chip_smoke, name), shape, boundary="periodic")
    theirs = psy.recognize(getattr(fig10, name), shape, boundary="periodic")
    assert ours.fingerprint == theirs.fingerprint


def test_pw_advection_fuses_to_one_apply_with_three_results():
    prog = psy.recognize(fig10.pw_advection, (16, 16, 8), boundary="periodic")
    raw = [op for op in prog.func.body.ops if isinstance(op, stencil.ApplyOp)]
    assert len(raw) == 3
    step = api.compile(prog, Target(backend="cuda", device="cpu"))
    (fused,) = step.kernel_applies()
    assert len(fused.results) == 3
    assert step.kernel_dispatches == {"fused_epoch": 0, "apply": 1, "total": 1}


def test_recognizer_rejects_an_offset_store():
    for mod in (psy, rpsy):
        with pytest.raises(mod.RecognitionError):
            mod.recognize(offset_store, shape=(8, 8))


def _fields(prog, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(f.type.bounds.shape).astype(np.float32) for f in prog.field_args]


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name", ["pw-advection", "tracer-advection", "flux-chain"])
def test_advection_matches_the_reference_and_distributes_bitwise(name, boundary):
    """One call on every field: within rtol=atol=1e-5 of the reference, the
    cuda route (K1's plain version here) bitwise to the torch route, and a
    2×2(×1) mesh of CPU ranks bitwise to one device."""
    kern, shape = KERNELS[name]
    ref = rpsy.recognize(kern, shape, boundary=boundary)
    port = psy.recognize(kern, shape, boundary=boundary)
    args = _fields(port, 3)
    want = [np.array(x) for x in rapi.compile(ref)(*args)]
    tensors = [torch.from_numpy(a) for a in args]
    torch_route = api.compile(port, Target(device="cpu"))(*tensors)
    got = api.compile(port, Target(backend="cuda", device="cpu"))(*tensors)
    assert len(got) == len(want) == len(port.output_fields)
    for g, t, w in zip(got, torch_route, want):
        assert torch.equal(g, t)
        torch.testing.assert_close(g, torch.from_numpy(w), **TOL)
    mesh_shape = (2, 2, 1) if len(shape) == 3 else (2, 2)
    devs = np.array([torch.device("cpu")] * 4, dtype=object).reshape(mesh_shape)
    mesh = Mesh(devs, ("x", "y", "z")[:len(shape)])
    strategy = (make_strategy_3d if len(shape) == 3 else make_strategy_2d)(mesh_shape)
    dist = api.compile(port, Target(mesh=mesh, strategy=strategy, backend="cuda"))
    for g, d in zip(got, dist(*tensors)):
        assert torch.equal(d, g)
