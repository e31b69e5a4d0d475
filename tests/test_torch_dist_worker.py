"""The port's distributed epochs against the reference's distributed run,
which needs 8 virtual XLA devices: ``tests/torch_dist_worker.py`` runs in
a subprocess so the device flag never reaches this pytest process."""
import os
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")


def test_fused_and_unfused_epochs_match_the_reference_distributed_run():
    proc = subprocess.run(
        [sys.executable, WORKER], capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-3000:]}"
    )
