"""The stencil serving engine's slot axis over one process per rank.

``tests/torch_slot_worker.py`` runs in a subprocess with a time limit of
its own and spawns 4 gloo processes on the CPU (a file store under
``tmp_path``): heat fused k=2 and wave k=1 buckets on (slot=2, x=2) and
(slot=1, 2×2) process meshes, 6 requests with frames, a resize and an
evacuation readmitted onto one device, each result and frame bitwise the
single controller's and the solo run, within 1e-5 of the reference's
solo run; each process holds a quarter of the pool.  Without a world:
the slot-axis rules of a process mesh.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import Target, TargetError
from repro_torch.core.passes.decompose import make_strategy_1d
from repro_torch.dist import Mesh, ShardedTensor, read_row, write_row

WORKER = os.path.join(os.path.dirname(__file__), "torch_slot_worker.py")


def test_slot_axis_serving_over_processes(tmp_path):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, WORKER, str(tmp_path)], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )


def _slot_mesh(rank):
    return Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("slot", "x"),
                process_rank=rank)


def test_a_slot_axis_target_over_processes_validates_its_strategy():
    t = Target(mesh=_slot_mesh(3), strategy=make_strategy_1d(2), slot_axis="slot")
    assert t.distributed and t.spatial_ranks == 2 and t.device == "cpu"
    with pytest.raises(TargetError, match="but the slot axis"):
        Target(mesh=_slot_mesh(3), slot_axis="slot")


@pytest.mark.parametrize("rank", range(4))
def test_a_process_writes_only_the_rows_it_holds(rank):
    """On a process mesh ``write_row`` writes this process's block of a
    row only where its slot block holds the row, and never sends."""
    mesh = _slot_mesh(rank)
    local = torch.zeros(2, 2, 4)
    pool = ShardedTensor(mesh, ("slot", "x"), (local,), (4, 4, 4))
    row = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    for i in range(4):
        write_row(pool, i, row + i)
    c = mesh.coords(rank)
    for j in range(2):
        want = (row + 2 * c["slot"] + j)[2 * c["x"]:2 * c["x"] + 2]
        assert torch.equal(local[j], want)
    with pytest.raises(ValueError, match="a row of shape"):
        write_row(pool, 0, torch.zeros(3, 4))
    assert torch.equal(read_row(torch.ones(2, 3), 1), torch.ones(3))


_PHASE19 = """
import sys, torch
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
from repro_torch.configs.base import reduced_config

if __name__ == "__main__":
    chip_smoke.p19_phase(torch.device("cpu"), card="the CPU", cut=reduced_config, n2=64,
                         conv=(16, 64), attn_S=32, window=8, dense_layers=2, moe_layers=2,
                         tokens=(4, 16), full_layers=2, full_tokens=(4, 32), processes=4)
    print("PHASE 19 OK")
"""


def test_chip_smoke_phase_19_on_the_cpu(tmp_path):
    """``chip_smoke.p19_phase`` at reduced sizes, a world of one gloo
    process for (a)-(b) and four for (d)-(f): the engine's results and
    frames bitwise their solo runs through a resize and an evacuation,
    context parallelism bitwise the stacked ranks with F2 raised on every
    process, the microbatched int8 step bitwise the stacked ranks and
    within its tolerances of flat; a rehearsal of the phase the card runs
    over NCCL."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "phase19.py"
    script.write_text(_PHASE19.format(root=root, src=os.path.join(root, "src")))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0 and "PHASE 19 OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )
    assert "through a resize of H to 8 slots" in proc.stdout
