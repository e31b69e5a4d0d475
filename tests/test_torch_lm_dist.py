"""The port's expert parallelism (``moe_apply`` under a mesh, and the
gradients of a mesh train step) against the reference's on a (2, 4)
mesh, which needs 8 virtual XLA devices: ``tests/torch_lm_dist_worker.py``
runs in a subprocess so the device flag never reaches this pytest
process."""
import os
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_lm_dist_worker.py")


@pytest.mark.parametrize("scenario", ["moe", "grads"])
def test_expert_parallelism_matches_the_reference_mesh(scenario):
    proc = subprocess.run(
        [sys.executable, WORKER, scenario], capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-3000:]}"
    )
