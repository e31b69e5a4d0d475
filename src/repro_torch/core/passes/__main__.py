# Copied from src/repro/core/passes/__main__.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Pipeline dump mode — mlir-opt for the repro stack.

    python -m repro_torch.core.passes "fuse,cse,dce,decompose{grid=2x2},swap-elim,overlap,lower-comm"

Runs the spec over a demo stencil program (or --program box|chain),
printing the IR after every stage plus the PassManager timing table.
``--quiet`` prints only the op-count trajectory and timings (the CI
pipeline smoke in scripts/check.sh).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core import ir
from repro_torch.core.passes import PassManager, PipelineContext, run_pipeline

DEFAULT_SPEC = (
    "fuse,cse,dce,decompose{grid=2x2},swap-elim,overlap,lower-comm"
)


def _demo_program(kind: str, shape: tuple) -> ir.FuncOp:
    from repro_torch.frontends.oec_like import ProgramBuilder

    p = ProgramBuilder(kind, shape)
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    if kind == "jacobi":
        r = p.apply(
            [t],
            lambda b, u: (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1))
            * 0.25,
        )
    elif kind == "box":
        r = p.apply(
            [t],
            lambda b, u: u.at(-1, -1) + u.at(1, 1) * 0.5 + u.at(-1, 1) * 0.25
            + u.at(0, 0),
        )
    elif kind == "chain":
        a = p.apply([t], lambda b, u: (u.at(-1, 0) + u.at(1, 0)) * 0.5)
        r = p.apply([t, a], lambda b, u, a: u.at(0, 0) + a.at(0, 0) * 0.1)
    else:
        raise SystemExit(f"unknown --program {kind!r}")
    p.store(r, out)
    return p.build_func()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.passes")
    ap.add_argument("spec", nargs="?", default=DEFAULT_SPEC,
                    help="pipeline spec (see DESIGN.md §2 for the grammar)")
    ap.add_argument("--program", default="jacobi",
                    choices=["jacobi", "box", "chain"])
    ap.add_argument("--shape", default="32x32",
                    help="global domain, e.g. 64x32")
    ap.add_argument("--boundary", default="periodic",
                    choices=["zero", "periodic"])
    ap.add_argument("--quiet", action="store_true",
                    help="op counts + timings only (CI smoke)")
    args = ap.parse_args(argv)

    shape = tuple(int(s) for s in args.shape.split("x"))
    func = _demo_program(args.program, shape)
    ctx = PipelineContext(boundary=args.boundary)

    print(f"// input: {args.program} {args.shape} boundary={args.boundary}")
    if not args.quiet:
        print(ir.print_module(func))

    def dump(name: str, f: ir.FuncOp) -> None:
        if args.quiet:
            print(f"// after {name}: {len(f.body.ops)} top-level ops")
            return
        print(f"\n// ----- after {name} " + "-" * (40 - len(name)))
        print(ir.print_module(f))

    out, _ = run_pipeline(func, args.spec, ctx, after_each=dump)

    # the process-wide surface every driver shares (shim: last_timings)
    print(f"\n// pass timings (PassManager.last_timings, "
          f"run #{PassManager.runs_completed})")
    for name, sec in PassManager.last_timings:
        print(f"//   {name:<16} {sec * 1e3:8.2f} ms")
    counts: dict[str, int] = {}
    for op in out.body.ops:
        counts[op.name] = counts.get(op.name, 0) + 1
    print("// final op mix: " + ", ".join(
        f"{k}×{v}" for k, v in sorted(counts.items())
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
