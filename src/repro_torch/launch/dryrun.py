"""Dry run of every (arch × shape × mesh) cell on the reference's
production meshes (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both

For each cell: ``build_step`` on ``make_production_mesh`` (the reference's
(16, 16) or (2, 16, 16) TPU topology, as a layout oracle), then one run of
the step on meta tensors at the published widths.  Nothing is allocated
and nothing is compiled.  Each record (``<outdir>/<cell>.json``) keeps the
reference's keys and says in ``notes`` what stands in for XLA's numbers:

- ``memory.argument_bytes`` is exact: the sum over the step's arguments
  of one rank's local shard bytes under the specs (``state_pspecs``,
  ``param_pspecs``, ``cache_pspecs``, the input specs);
- ``memory.output_bytes``, ``temp_bytes`` and ``peak_bytes`` are
  ``null``: there is no compiled executable to ask;
- ``cost.flops`` is ``torch.utils.flop_counter.FlopCounterMode`` over one
  rank's products in a second meta run, of the step on placed blocks
  (``step.placed``; matmul-class ops only; replicated work counted on
  every rank that runs it);
  ``bytes_accessed`` and ``transcendentals`` are ``null`` (no HLO);
- ``collective_bytes`` is the operand bytes of one rank in the port's
  collectives during a second meta run, of the step on placed blocks
  (``step.placed``, tensor- and data-parallel): the psums and all-gathers
  GSPMD would insert for the reference's specs, flash-decode's combine,
  expert parallelism's all-to-alls; ``n_layout_constraints`` counts the
  ``shard`` constraints of the first run.

The reference's ``run_cell_delta`` and ``collective_bytes_from_hlo`` have
no port: there is no scan to extrapolate and no HLO to read.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import LM_SHAPES, get_config, get_shape
from repro_torch.configs.registry import ARCHS, shape_applicable
from repro_torch.dist.sharding import (
    PartitionSpec,
    _entry_axes,
    counting_collectives,
    default_rules,
    recording,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step

NOTES = {
    "argument_bytes": "exact: one rank's local shard bytes of every step argument under its spec",
    "output_bytes": "null: no compiled executable (the port runs eagerly)",
    "temp_bytes": "null: no compiled executable (the port runs eagerly)",
    "peak_bytes": "null: no compiled executable (the port runs eagerly)",
    "flops": "FlopCounterMode over one rank's products in a meta run of the step on placed "
             "blocks (step.placed) at published width",
    "bytes_accessed": "null: no HLO",
    "collective_bytes": "operand bytes of one rank in the port's collectives during a meta run "
                        "of the step on placed blocks (step.placed): the tensor-parallel psums "
                        "and all-gathers, flash-decode's combine, expert parallelism's "
                        "all-to-alls, the loss's and the gradients' reductions",
}


def _leaves(tree):
    """The leaves of nested dicts, lists and tuples (a spec is a leaf)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def local_bytes(tensors, specs, mesh) -> int:
    """One rank's bytes of ``tensors`` (a tree) laid out by ``specs`` (a
    tree of the same structure) on ``mesh``."""
    total = 0
    for t, spec in zip(_leaves(tensors), _leaves(specs)):
        n = 1
        for d, size in enumerate(t.shape):
            axes = _entry_axes(spec[d] if d < len(spec) else None)
            n *= size // math.prod(mesh.shape[a] for a in axes)
        total += n * t.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             unroll: bool = False) -> dict:
    """One dry-run cell.  ``unroll`` is the reference's flag; the port's
    models loop in Python, so every loop is counted as it runs either way
    (``repro_torch.models.flags``)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = default_rules(multi_pod=multi_pod)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size,
        "unrolled": unroll,
    }
    t0 = time.time()
    fn, args, in_specs, _ = build_step(cfg, shape, mesh, rules)
    record["lower_s"] = round(time.time() - t0, 1)
    record["memory"] = {
        "argument_bytes": local_bytes(args, in_specs, mesh),
        "output_bytes": None,
        "temp_bytes": None,
        "peak_bytes": None,
    }

    t1 = time.time()
    flops = FlopCounterMode(display=False)
    with recording() as layouts:
        fn(*args)
    # the same step tensor- and data-parallel on each rank's blocks: the
    # collectives GSPMD would insert, run explicitly; the products one
    # rank's (per_rank runs the first rank's block on meta tensors)
    with counting_collectives() as coll, flops:
        fn.placed(*fn.place(*args))
    record["meta_run_s"] = round(time.time() - t1, 1)
    record["cost"] = {
        "flops": flops.get_total_flops(),
        "bytes_accessed": None,
        "transcendentals": None,
    }
    record["collective_bytes"] = {k: float(v) for k, v in coll.items()}
    record["n_layout_constraints"] = len(layouts)
    record["params"] = cfg.param_count()
    record["active_params"] = cfg.active_param_count()
    record["notes"] = NOTES
    record["ok"] = True

    os.makedirs(outdir, exist_ok=True)
    cell = f"{arch}__{shape_name}__{record['mesh']}"
    with open(os.path.join(outdir, cell + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--outdir", default="build/dryrun")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's flag; changes nothing in the port")
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume: skip cells whose record already exists in outdir")
    args = ap.parse_args()

    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in LM_SHAPES] if not args.shape else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            ok, reason = shape_applicable(arch, shape_name)
            if not ok:
                print(f"SKIP  {arch} × {shape_name}: {reason}")
                continue
            for mp in pods:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch} × {shape_name} × {mesh_name}"
                cell_file = os.path.join(args.outdir, f"{arch}__{shape_name}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(cell_file):
                    print(f"SKIP  {tag}: record exists")
                    continue
                try:
                    rec = run_cell(arch, shape_name, mp, args.outdir, unroll=args.unroll)
                    per_dev = rec["memory"]["argument_bytes"] / 2**30
                    print(f"OK    {tag}: meta run={rec['meta_run_s']}s "
                          f"flops/rank={rec['cost']['flops']:.3e} args/rank={per_dev:.2f}GiB")
                except Exception as e:
                    failures += 1
                    print(f"FAIL  {tag}: {type(e).__name__}: {e}")
                    traceback.print_exc(limit=4)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
