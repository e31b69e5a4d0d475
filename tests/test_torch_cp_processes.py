"""Context parallelism over one process a rank
(``repro_torch.dist.context_parallel`` on a process mesh).

``tests/torch_mb_worker.py cp`` runs in a subprocess with a time limit of
its own and spawns 4 gloo processes on the CPU (a file store under
``tmp_path``): ``causal_conv_cp`` and ``sliding_window_attention_cp`` on
(seq=4) and (data=2, seq=2) process meshes, global and placed inputs,
each bitwise the stacked ranks' run and within 1e-5 of the reference's
single-device functions; every case of F2 (a halo deeper than a shard)
raises on every process.  Without a world: ``run_func_dataflow`` still
runs one rank only unless it is given the process mesh.
"""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.lowering import run_func_dataflow
from repro_torch.dist.context_parallel import SeqHaloSpec, _comm_func

WORKER = os.path.join(os.path.dirname(__file__), "torch_mb_worker.py")


def test_context_parallel_over_processes(tmp_path):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, WORKER, "cp", str(tmp_path)], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )


def test_run_func_dataflow_runs_one_rank_without_a_process_mesh():
    spec = SeqHaloSpec(axis="seq", n_shards=4, halo_lo=2)
    func = _comm_func((1, 8, 3), spec)
    with pytest.raises(ValueError, match="pass the process mesh"):
        run_func_dataflow(func, [torch.zeros(1, 8, 3)], axis_sizes={"seq": 4}, distributed=True)
    (out,) = run_func_dataflow(func, [torch.ones(1, 8, 3)], axis_sizes={"seq": 4})
    assert tuple(out.shape) == (1, 10, 3) and torch.equal(out[:, :2], torch.zeros(1, 2, 3))
