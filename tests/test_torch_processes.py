"""One process per rank (``repro_torch.dist.processes``): the port's
distributed runs over ``torch.distributed`` held against the single
controller.

The scenarios run in ``tests/torch_process_worker.py``, a subprocess with
a time limit of its own, which spawns its gloo processes on the CPU (a
file store under ``tmp_path``): a collective that hangs fails one test,
not the run.  Without a world: the process mesh's own rules, the
``Target`` validation over it and the census's NCCL count.  The tests
marked ``gpu`` spawn one process per card over NCCL and skip below two
cards.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import Target, TargetError
from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d
from repro_torch.dist import Mesh
from repro_torch.kernels.graphs import GraphCensus

WORKER = os.path.join(os.path.dirname(__file__), "torch_process_worker.py")


def _run(scenario, directory, timeout=240):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, WORKER, scenario, str(directory)],
                          capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )


@pytest.mark.parametrize("scenario", ["stencil2", "stencil4", "snapshot", "lm"])
def test_processes_match_the_single_controller(scenario, tmp_path):
    """Heat and wave over 2 and 4 gloo processes (k=1, overlap, epochs,
    K2's plain route, 3-D, ``comm.allreduce``, ``time_loop``), a snapshot
    of 4 processes resumed on 2, on the single controller and in the
    reference, and the language models' mesh branches: each bitwise the
    single controller (see the worker's docstring for each case)."""
    _run(scenario, tmp_path)


def _cpu_ranks(shape, rank=None):
    n = int(np.prod(shape))
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object).reshape(shape),
                ("x", "y")[: len(shape)], process_rank=rank)


def test_a_process_mesh_holds_its_own_rank():
    mesh = _cpu_ranks((2, 2), rank=2)
    assert mesh.processes and mesh.local_ranks == (2,) and mesh.coords(2) == {"x": 1, "y": 0}
    single = _cpu_ranks((2, 2))
    assert not single.processes and single.local_ranks == (0, 1, 2, 3)
    assert mesh.describe() != single.describe()  # never one compile-cache key
    with pytest.raises(ValueError, match="outside a mesh of 4"):
        _cpu_ranks((2, 2), rank=4)


def test_target_over_processes_validates_its_mesh():
    mesh = _cpu_ranks((2, 2), rank=1)
    t = Target(mesh=mesh, strategy=make_strategy_2d((2, 2)))
    assert t.distributed and t.device == "cpu" and t.spatial_ranks == 4
    assert t.fingerprint != Target(mesh=_cpu_ranks((2, 2)), strategy=make_strategy_2d((2, 2))).fingerprint
    with pytest.raises(TargetError, match="decomposes over every axis"):
        Target(mesh=mesh, strategy=make_strategy_1d(2))
    with pytest.raises(TargetError, match="decomposes over every axis"):
        Target(mesh=mesh)
    # a slot axis over processes: every axis but the slot axis decomposed
    slotted = Mesh(np.array([[[torch.device("cpu")] * 2] * 2] * 2), ("slot", "x", "y"),
                   process_rank=0)
    assert Target(mesh=slotted, strategy=make_strategy_2d((2, 2)), slot_axis="slot").distributed
    with pytest.raises(TargetError, match="decomposes over every axis of it but the slot axis"):
        Target(mesh=slotted, strategy=make_strategy_1d(2), slot_axis="slot")
    cards = Mesh(np.array([torch.device("cuda", i) for i in range(4)], dtype=object).reshape(2, 2),
                 ("x", "y"), process_rank=3)
    assert Target(mesh=cards, strategy=make_strategy_2d((2, 2)), device="cuda:3").device == "cuda"
    with pytest.raises(TargetError, match="this process\\) is on cuda:3"):
        Target(mesh=cards, strategy=make_strategy_2d((2, 2)), device="cuda:0")
    # one process, one rank: still the process path (its exchanges wrap locally)
    assert Target(mesh=_cpu_ranks((1,), rank=0), strategy=make_strategy_1d(1)).distributed


def test_census_counts_nccl_kernels_apart():
    c = GraphCensus({"k1_apply_0123456789abcdef": 4, "ncclDevKernel_SendRecv": 2,
                     "ncclKernel_AllGather_RING_LL_Sum_int8_t": 1, "elementwise_kernel": 3})
    assert (c.k1, c.k2, c.nccl) == (4, 0, 3)
    assert c.others() == {"elementwise_kernel": 3}


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


@pytest.mark.gpu
def test_captured_step_over_card_processes_is_bitwise_uncaptured(tmp_path):
    """One process per card over NCCL (2×2 on four cards, 1×2 on two or
    three): heat so4 k=1 (zero and periodic, and with overlap) under
    ``jit=True, donate=True`` bitwise ``jit=False``, each graph holding one
    K1 node per apply and NCCL nodes for its exchanges."""
    _cards(2)
    _run("gpu", tmp_path, timeout=600)

