"""``chip_smoke.py``'s phase 17 (one process per card) rehearsed on the
CPU: ``process_phase`` over two gloo processes at 64², the kernels' plain
versions standing in for K1 and K2 (``tests/test_torch_processes.py``
holds the same paths against the reference and the single controller)."""
import os
import subprocess
import sys

_PHASE17 = """
import sys, torch
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke

if __name__ == "__main__":
    out = chip_smoke.process_phase(torch.device("cpu"), world=2, n2=64, weak=32, reduced=True,
                                   layers=(1, 1), decode=(4, 64), prefill=(2, 16),
                                   small_decode=(1, 16), max_s=120.0)
    assert set(out) == {{"heat k=1 zero", "heat k=1 periodic", "heat k=1 overlap",
                        "heat k=4 fused", "wave k=4 fused", "weak heat k=1",
                        "weak heat k=4 fused"}}, out
    print("PHASE 17 OK")
"""


def test_chip_smoke_process_phase_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 17 at 64² over two gloo processes (its
    kernels' plain versions on the CPU): every case bitwise the single
    controller, the snapshot resumed, the LM branches bitwise the stacked
    ranks; a rehearsal of the phase the card runs over NCCL."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "phase17.py"
    script.write_text(_PHASE17.format(root=root, src=os.path.join(root, "src")))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0 and "PHASE 17 OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )
