"""The port's distributed deep-halo epochs against the reference's
distributed run: a subprocess worker (``tests/test_torch_dist_worker.py``).

    python tests/torch_dist_worker.py

The reference runs heat so4 64² on a 2×2 mesh of virtual CPU devices
(``--xla_force_host_platform_device_count=8``, set before JAX is
imported) with ``backend="pallas"`` in interpret mode and
``exchange_every=4``, fused (K2's reference) and unfused, 8 steps, for
zero and periodic boundaries.  The port runs the same program on a 2×2
mesh of CPU ranks with ``backend="cuda"`` (K1's and K2's plain versions
on the CPU).  Each pair agrees within rtol=atol=1e-5; within the port,
fused equals unfused bitwise.  Then the structural terms of ``cost()``
(``exchange_every``, ``messages_per_epoch``, ``step_halo``,
``local_shape``, ``redundant_compute_factor(4)``) of heat on the 2×2 mesh
at k=1 and k=4 equal the reference's.  Exit 0 and ``ALL OK`` when every
case holds.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_programs as P  # noqa: E402
from repro import api as rapi  # noqa: E402
from repro.core.passes.decompose import make_strategy_2d as rstrategy  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.passes.decompose import make_strategy_2d  # noqa: E402
from repro_torch.dist import Mesh  # noqa: E402

SHAPE, SO, K, STEPS = (64, 64), 4, 4, 8


def run(boundary: str) -> None:
    ref_prog = P.heat("repro", SHAPE, SO, boundary)
    prog = P.heat("repro_torch", SHAPE, SO, boundary)
    assert prog.fingerprint == ref_prog.fingerprint
    state = P.rand_state(ref_prog, 11)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    tmesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    outs = {}
    for fused in (False, True):
        want = rapi.compile(ref_prog, rapi.Target(
            mesh=jmesh, strategy=rstrategy((2, 2)), backend="pallas", exchange_every=K,
            fused_epoch=fused, pallas_interpret=True,
        )).time_loop(state, STEPS)
        got = api.compile(prog, api.Target(
            mesh=tmesh, strategy=make_strategy_2d((2, 2)), backend="cuda", exchange_every=K,
            fused_epoch=fused,
        )).time_loop([torch.from_numpy(a) for a in state], STEPS)
        torch.testing.assert_close(got[0], torch.from_numpy(np.array(want[0])), rtol=1e-5, atol=1e-5)
        outs[fused] = got[0]
        print(f"ok: heat so{SO} {SHAPE} {boundary} 2x2 k={K} fused={fused}: "
              f"max |port - reference| {float((got[0] - torch.from_numpy(np.array(want[0]))).abs().max())}")
    assert torch.equal(outs[True], outs[False]), "fused differs from unfused"
    print(f"ok: {boundary}: fused == unfused, bitwise")


def cost_terms(k: int) -> None:
    ref_prog = P.heat("repro", SHAPE, SO)
    prog = P.heat("repro_torch", SHAPE, SO)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    tmesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    theirs = rapi.compile(ref_prog, rapi.Target(
        mesh=jmesh, strategy=rstrategy((2, 2)), exchange_every=k)).cost()
    mine = api.compile(prog, api.Target(
        mesh=tmesh, strategy=make_strategy_2d((2, 2)), exchange_every=k)).cost()
    for attr in ("exchange_every", "messages_per_epoch", "step_halo"):
        assert getattr(mine, attr) == getattr(theirs, attr), (attr, getattr(mine, attr),
                                                              getattr(theirs, attr))
    assert tuple(mine.local_shape) == tuple(theirs.local_shape)
    assert mine.redundant_compute_factor(4) == theirs.redundant_compute_factor(4)
    print(f"ok: cost() on 2x2 k={k}: messages {mine.messages_per_epoch}, step halo "
          f"{mine.step_halo}, local shape {tuple(mine.local_shape)} as the reference's")


if __name__ == "__main__":
    assert len(jax.devices()) == 8, jax.devices()
    for bc in ("zero", "periodic"):
        run(bc)
    for k in (1, K):
        cost_terms(k)
    print("ALL OK")
