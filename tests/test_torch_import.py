"""The port stands alone: importing ``repro_torch`` (every module of it,
``repro_torch.dist`` and the psyclone-like frontend among them) and
``chip_smoke.py`` loads neither JAX nor the reference package; the
checkpointing, resilience and trace-export modules among them, and the
serving engine (``repro_torch.serve``), request migration and the counter
registry; the language models (``repro_torch.models``), their configs
(``repro_torch.configs``) and the language-model serving engine
(``repro_torch.serve.engine``); training (``repro_torch.train``), the data
pipeline (``repro_torch.data``) and gradient compression
(``repro_torch.dist.compression``); the language models' distribution
(``repro_torch.dist.param_specs``, ``repro_torch.dist.context_parallel``,
``repro_torch.models.flags``) and launch layer (``repro_torch.launch.mesh``,
``.steps``, ``.dryrun``); one process per rank
(``repro_torch.dist.processes``); the tensor-parallel blocks
(``repro_torch.models.tp``)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for n in ("repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.frontends.psyclone_like",
          "repro_torch.checkpoint.checkpointer", "repro_torch.resilience.driver",
          "repro_torch.resilience.faults", "repro_torch.obs.export", "repro_torch.obs.drift",
          "repro_torch.serve", "repro_torch.serve.stencil", "repro_torch.serve.stencil.engine",
          "repro_torch.serve.stencil.scheduler", "repro_torch.serve.stencil.request",
          "repro_torch.serve.stencil.metrics", "repro_torch.resilience.migrate",
          "repro_torch.obs.registry", "repro_torch.obs.__main__",
          "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.registry",
          "repro_torch.configs.qwen2_7b", "repro_torch.models.lm", "repro_torch.models.layers",
          "repro_torch.models.attention", "repro_torch.models.moe", "repro_torch.models.mamba",
          "repro_torch.models.xlstm", "repro_torch.serve.engine", "repro_torch.core.program",
          "repro_torch.core.passes.__main__", "repro_torch.train", "repro_torch.train.optimizer",
          "repro_torch.train.train_step", "repro_torch.train.trainer", "repro_torch.data",
          "repro_torch.data.pipeline", "repro_torch.dist.compression",
          "repro_torch.dist.param_specs", "repro_torch.dist.context_parallel",
          "repro_torch.models.flags", "repro_torch.launch.mesh", "repro_torch.launch.steps",
          "repro_torch.launch.dryrun", "repro_torch.dist.processes", "repro_torch.models.tp"):
    assert n in names, n
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 69  # the IR copy, lowering, kernels, api, dist, frontends, serve, models, train, launch


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s+import))",
    re.M,
)


def test_sources_name_no_jax_or_reference_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = {
        str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
        for f in files
    }
    offenders = {k: v for k, v in offenders.items() if v}
    assert not offenders, offenders
