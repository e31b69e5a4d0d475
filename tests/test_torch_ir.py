"""The port's copy of the IR stack against the reference: the same frontend
calls give the same printed module and fingerprint, and the shared pass
pipeline lowers them to the same rank-local IR text."""
import pytest

import _torch_programs as P
from repro import api as rapi
from repro.core import ir as rir
from repro_torch import api
from repro_torch.core import ir

PROGRAMS = {
    "heat2d_so2": lambda pkg: P.heat(pkg, (16, 16), 2),
    "heat2d_so4": lambda pkg: P.heat(pkg, (16, 16), 4),
    "heat2d_so8": lambda pkg: P.heat(pkg, (16, 16), 8),
    "heat3d_so2": lambda pkg: P.heat(pkg, (16, 16, 16), 2),
    "heat3d_so4": lambda pkg: P.heat(pkg, (16, 16, 16), 4),
    "heat3d_so8": lambda pkg: P.heat(pkg, (16, 16, 16), 8),
    "wave2d_so4": lambda pkg: P.wave(pkg, (16, 16), 4),
    "jacobi_periodic": lambda pkg: P.jacobi(pkg, (16, 16), "periodic"),
}

TARGETS = {
    "default": {},
    "overlap": {"overlap": True},
    "ee2": {"exchange_every": 2},
    "ee4": {"exchange_every": 4},
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_prints_and_fingerprints_identically(name):
    ref, port = PROGRAMS[name]("repro"), PROGRAMS[name]("repro_torch")
    assert ir.print_module(port.func) == rir.print_module(ref.func)
    assert port.fingerprint == ref.fingerprint
    assert port.field_names == ref.field_names


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_local_ir_after_pipeline_identical(name, target):
    ref, port = PROGRAMS[name]("repro"), PROGRAMS[name]("repro_torch")
    kw = TARGETS[target]
    want = rapi.compile(ref, rapi.Target(jit=False, **kw))
    got = api.compile(port, api.Target(device="cpu", **kw))
    assert got.pipeline_report.spec == want.pipeline_report.spec
    assert ir.print_module(got.local_ir) == rir.print_module(want.local_ir)
    assert got.ret_indices == want.ret_indices
    assert got.input_indices == want.input_indices
    assert got.kernel_dispatches == want.kernel_dispatches
