"""Tensor and data parallelism of the language models over one process a
rank: the scenarios of ``tests/torch_tp_worker.py``, each in a subprocess
with a time limit of its own (a collective that hangs fails one test, not
the run), which spawns its gloo processes on the CPU (a file store under
``tmp_path``) or, for ``gspmd``, sets 8 virtual XLA devices before it
imports JAX."""
import os
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_tp_worker.py")


def _run(scenario, directory, timeout=240):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, WORKER, scenario, str(directory)],
                          capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )


@pytest.mark.parametrize("scenario", ["train", "trainer", "gspmd"])
def test_tensor_parallel_processes_match_the_stacked_ranks(scenario, tmp_path):
    """``train``: four gloo processes' sharded train steps (reduced qwen2
    and granite on (2, 2) and (1, 4)) bitwise the stacked ranks' loss,
    gradients and new state; ``trainer``: a ``Trainer(state_shardings=...)``
    saved on (1, 4) processes and resumed on (2, 2) processes and on one
    device, and the reference's snapshot resumed on processes, each
    restored state bitwise the files; ``gspmd``: two of the port's stacked
    (2, 4) steps against the reference's GSPMD step — the loss and the
    metrics within 1e-5, the gradients, the moments and the parameters
    within 1e-4 of each leaf's largest magnitude, the new state within
    1e-6 of the reference's AdamW on the port's gradients."""
    _run(scenario, tmp_path)
