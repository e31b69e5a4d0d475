"""CLI: rank candidate ``Target``s for a stencil program.

    PYTHONPATH=src python -m repro_torch.tune                 # fig7 heat on the card, model-only
    PYTHONPATH=src python -m repro_torch.tune --measure       # + timed runs
    PYTHONPATH=src python -m repro_torch.tune --ranks 4 --device cuda:0 --measure
                                                              # 4 ranks sharing one card
    PYTHONPATH=src python -m repro_torch.tune --device cpu    # virtual CPU ranks

Prints the ranked candidate table (modeled and, with ``--measure``,
measured per-step seconds), the winner, and where it was cached.
"""
from __future__ import annotations

import argparse
import json


def build_program(kind: str, size: int, so: int):
    from repro_torch.frontends.devito_like import Eq, Grid, Operator, TimeFunction

    shape = (size, size)
    g = Grid(shape=shape, extent=(1.0, 1.0))
    u = TimeFunction(name="u", grid=g, space_order=so)
    if kind == "heat":
        dt = 0.1 * g.spacing[0] ** 2 / 0.5
        op = Operator(Eq(u.dt, 0.5 * u.laplace), dt=dt, boundary="zero")
    elif kind == "wave":
        u = TimeFunction(name="u", grid=g, space_order=so, time_order=2)
        op = Operator(Eq(u.dt2, 1.0 * u.laplace), dt=1e-4, boundary="zero")
    else:
        raise SystemExit(f"unknown --program {kind!r}")
    return op.program


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="roofline-guided Target autotuning (on the card by default)",
    )
    ap.add_argument("--program", default="heat", choices=["heat", "wave"])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--so", type=int, default=2, help="space order")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: one per card, or 1 with --device); more "
                         "ranks than cards needs --device, e.g. --ranks 4 --device cuda:0")
    ap.add_argument("--device", default=None,
                    help="run every rank on this one device: 'cpu' for virtual CPU "
                         "ranks, 'cuda:0' to repeat one card (default: one rank per card)")
    ap.add_argument("--measure", action="store_true",
                    help="time the unpruned candidates (default: cost model)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--top", type=int, default=None, help="rows to print")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--json", action="store_true", help="machine-readable dump")
    args = ap.parse_args()

    import torch

    from repro_torch.tune import cache_stats, tune

    devices = None
    if args.device is not None:
        devices = [torch.device(args.device)] * (args.ranks or 1)
    prog = build_program(args.program, args.size, args.so)
    result = tune(
        prog,
        ranks=args.ranks,
        devices=devices,
        measure=args.measure,
        cache=not args.no_cache,
        steps=args.steps,
        trials=args.trials,
        verbose=args.measure and not args.json,
    )

    if args.json:
        print(json.dumps(
            {
                "program": result.program_fingerprint,
                "hardware": result.hardware,
                "n_ranks": result.n_ranks,
                "from_cache": result.from_cache,
                "cache_key": result.cache_key,
                "winner": {
                    "describe": result.winner.describe(),
                    "fingerprint": result.winner.fingerprint,
                    "modeled_s": result.winner.modeled_s,
                    "measured_s": result.winner.measured_s,
                },
                "ranked": result.summary(),
            },
            indent=1,
        ))
        return 0

    print(f"program  : {args.program} {args.size}x{args.size} so{args.so} "
          f"fingerprint={result.program_fingerprint}")
    print(f"hardware : {result.hardware}")
    if result.from_cache:
        print(f"cache HIT: {result.cache_path}")
    else:
        print(result.table(top=args.top))
        if result.cache_path:
            print(f"cached to: {result.cache_path}")
    print(f"winner   : {result.winner.describe()} "
          f"(origin={result.winner.origin})")
    print(f"tune cache stats: {cache_stats().as_dict()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
