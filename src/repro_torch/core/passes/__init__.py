# Copied from src/repro/core/passes/__init__.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Pass infrastructure: declarative, mlir-opt-style pipelines.

A pass is a callable ``FuncOp -> FuncOp`` (pure) or ``FuncOp -> None``
(in-place); ``PassManager`` chains them with verification and timing
between stages.  On top of that sits a **pass registry** and a parseable
**pipeline spec** (DESIGN.md §2), so the compilation pipeline is data,
not hardcoded control flow:

    "fuse,cse,dce,decompose{grid=4x2},swap-elim,overlap,lower-comm"

Grammar (mlir-opt's textual pipeline, single-level):

    spec   := pass ("," pass)*
    pass   := name ("{" opt ("," opt)* "}")?
    opt    := key "=" value

``decompose`` accepts ``grid=4x2`` (rank-grid shape, optionally suffixed
with axis names: ``grid=2x2xy``), ``dims=0x1`` and ``boundary=zero|
periodic``; ``temporal-tile`` accepts ``k=4`` (epoch depth — exchange a
depth-k halo once, step k times); omitted options fall back to the
``PipelineContext`` the driver supplies.  Dump the IR after every stage
with

    python -m repro_torch.core.passes "<spec>" [--program jacobi|box|chain]
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Callable, Optional, Sequence

from repro_torch.core import ir
from repro_torch.obs import trace as _obs

# Process-wide pipeline tally, read through the ``PassManager.<attr>``
# class shim below.  ``repro_torch.api``'s compile cache is judged against
# ``runs_completed`` (a cache hit must not bump it), and the
# ``python -m repro_torch.core.passes`` dump surfaces ``last_timings``.
_RUNS_LOCK = threading.Lock()
_RUNS_COMPLETED = 0
_LAST_TIMINGS: list = []


class _PassManagerMeta(type):
    """Class-attribute shim: ``PassManager.runs_completed`` /
    ``.last_timings`` used to be class-level *mutable* state, which
    misattributed timings when compiles interleave (the serve engine
    compiles pooled siblings mid-step from worker threads).  The real
    counters are now per-instance; these properties keep the class-level
    reads (scripts/check.sh, ``python -m repro_torch.core.passes``) meaning
    "process-wide totals"."""

    @property
    def runs_completed(cls) -> int:
        return _RUNS_COMPLETED

    @runs_completed.setter
    def runs_completed(cls, value: int) -> None:
        global _RUNS_COMPLETED
        with _RUNS_LOCK:
            _RUNS_COMPLETED = int(value)

    @property
    def last_timings(cls) -> list:
        return list(_LAST_TIMINGS)

    @last_timings.setter
    def last_timings(cls, value: list) -> None:
        global _LAST_TIMINGS
        with _RUNS_LOCK:
            _LAST_TIMINGS = list(value)


class PassManager(metaclass=_PassManagerMeta):
    def __init__(self, passes: Sequence[Callable], verify: bool = True) -> None:
        self.passes = list(passes)
        self.verify = verify
        self.timings: list[tuple[str, float]] = []
        # instance-level mirrors of the process-wide tally: how many times
        # THIS manager ran, and its most recent run's timings
        self.runs_completed = 0
        self.last_timings: list = []

    def run(
        self,
        func: ir.FuncOp,
        after_each: Optional[Callable[[str, ir.FuncOp], None]] = None,
    ) -> ir.FuncOp:
        global _RUNS_COMPLETED, _LAST_TIMINGS
        traced = _obs.enabled()
        for p in self.passes:
            name = getattr(p, "__name__", repr(p))
            t0 = time.perf_counter()
            if traced:
                with _obs.span(f"pass:{name}", cat="compile"):
                    out = p(func)
            else:
                out = p(func)
            if isinstance(out, ir.FuncOp):
                func = out
            self.timings.append((name, time.perf_counter() - t0))
            if self.verify:
                ir.verify_module(func)
            if after_each is not None:
                after_each(name, func)
        self.runs_completed += 1
        self.last_timings = list(self.timings)
        with _RUNS_LOCK:
            _RUNS_COMPLETED += 1
            _LAST_TIMINGS = list(self.timings)
        return func


from repro_torch.core.passes.halo import infer_apply_halo, infer_field_halos  # noqa: E402,F401
from repro_torch.core.passes.decompose import (  # noqa: E402,F401
    SlicingStrategy,
    decompose_stencil,
)
from repro_torch.core.passes.swap_elim import (  # noqa: E402,F401
    eliminate_redundant_swaps,
    shrink_swaps_to_consumers,
)
from repro_torch.core.passes.fusion import fuse_applies  # noqa: E402,F401
from repro_torch.core.passes.cse import cse_apply_bodies, dce  # noqa: E402,F401
from repro_torch.core.passes.overlap import (  # noqa: E402,F401
    enable_comm_compute_overlap,
    split_overlapped_applies,
)
from repro_torch.core.passes.diagonal import use_diagonal_exchanges  # noqa: E402,F401
from repro_torch.core.passes.lower_comm import lower_dmp_to_comm  # noqa: E402,F401
from repro_torch.core.passes.temporal import (  # noqa: E402,F401
    TemporalTilingError,
    epoch_halo,
    temporal_tile,
)
from repro_torch.core.passes.fuse_epoch import fuse_epoch_kernels  # noqa: E402,F401


# --------------------------------------------------------------------------
# Pipeline specs: parse + build against a registry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineContext:
    """Driver-supplied defaults for passes whose options are objects the
    textual spec cannot carry (the decomposition strategy, boundary), plus
    the epoch depth ``temporal-tile`` falls back to when the spec omits
    ``k=`` (``repro_torch.api.compile`` passes ``Target.exchange_every``)."""

    strategy: Optional[SlicingStrategy] = None
    boundary: str = "zero"
    exchange_every: int = 1


class PipelineError(ValueError):
    pass


_PASS_RE = re.compile(r"^([\w-]+)(?:\{(.*)\})?$")
_GRID_RE = re.compile(r"^(\d+(?:x\d+)*)([a-zA-Z]*)$")


def parse_pipeline(spec: str) -> list:
    """``"a,b{k=v,k2=v2},c"`` → ``[("a", {}), ("b", {...}), ("c", {})]``."""
    out: list[tuple[str, dict]] = []
    depth, token, tokens = 0, "", []
    for ch in spec:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth < 0:
                raise PipelineError(f"unbalanced '}}' in pipeline spec: {spec!r}")
        if ch == "," and depth == 0:
            tokens.append(token)
            token = ""
        else:
            token += ch
    if depth != 0:
        raise PipelineError(f"unbalanced '{{' in pipeline spec: {spec!r}")
    tokens.append(token)
    for tok in tokens:
        tok = tok.strip()
        if not tok:
            continue
        m = _PASS_RE.match(tok)
        if m is None:
            raise PipelineError(f"cannot parse pipeline stage {tok!r}")
        name, raw_opts = m.group(1), m.group(2)
        opts: dict[str, str] = {}
        if raw_opts:
            for item in raw_opts.split(","):
                if "=" not in item:
                    raise PipelineError(
                        f"stage {name!r}: option {item!r} is not key=value"
                    )
                k, v = item.split("=", 1)
                opts[k.strip()] = v.strip()
        out.append((name, opts))
    return out


def _parse_grid(value: str) -> tuple:
    """``"4x2"`` → shape (4,2); ``"2x2xy"`` → shape (2,2), axes ("x","y")."""
    m = _GRID_RE.match(value)
    if m is None:
        raise PipelineError(f"cannot parse grid spec {value!r}")
    shape = tuple(int(s) for s in m.group(1).split("x"))
    axes = tuple(m.group(2)) if m.group(2) else None
    if axes is not None and len(axes) != len(shape):
        raise PipelineError(
            f"grid spec {value!r}: {len(axes)} axis names for "
            f"{len(shape)} grid dims"
        )
    return shape, axes


def _check_opts(name: str, opts: dict, allowed: tuple = ()) -> None:
    unknown = sorted(set(opts) - set(allowed))
    if unknown:
        raise PipelineError(
            f"stage {name!r}: unknown option(s) {', '.join(unknown)}; "
            f"allowed: {', '.join(allowed) if allowed else '(none)'}"
        )


def _strategy_from_opts(opts: dict, ctx: PipelineContext) -> SlicingStrategy:
    if "grid" not in opts:
        if ctx.strategy is None:
            raise PipelineError(
                "decompose: no grid= option and no strategy in context"
            )
        return ctx.strategy
    shape, axes = _parse_grid(opts["grid"])
    axes = axes or ("x", "y", "z", "w")[: len(shape)]
    dims = (
        tuple(int(d) for d in opts["dims"].split("x"))
        if "dims" in opts
        else None
    )
    return SlicingStrategy(shape, axes, dims)


def _named(name: str, fn: Callable) -> Callable:
    def run(func: ir.FuncOp):
        out = fn(func)
        return out if isinstance(out, ir.FuncOp) else None

    run.__name__ = name
    return run


def _tag_and_split(func: ir.FuncOp):
    enable_comm_compute_overlap(func)
    return split_overlapped_applies(func)


def _make_decompose(opts: dict, ctx: PipelineContext) -> Callable:
    _check_opts("decompose", opts, ("grid", "dims", "boundary"))
    if "dims" in opts and "grid" not in opts:
        raise PipelineError("decompose: dims= requires grid=")
    strategy = _strategy_from_opts(opts, ctx)
    boundary = opts.get("boundary", ctx.boundary)
    if boundary not in ("zero", "periodic"):
        raise PipelineError(f"decompose: bad boundary {boundary!r}")
    return _named(
        "decompose",
        lambda f: decompose_stencil(f, strategy, boundary=boundary),
    )


def _make_fuse(opts: dict, ctx: PipelineContext) -> Callable:
    _check_opts(
        "fuse", opts, ("horizontal", "vertical", "max_recompute_accesses")
    )
    kw = {}
    for k in ("horizontal", "vertical"):
        if k in opts:
            kw[k] = opts[k] not in ("0", "false", "no")
    if "max_recompute_accesses" in opts:
        kw["max_recompute_accesses"] = int(opts["max_recompute_accesses"])
    return _named("fuse", lambda f: fuse_applies(f, **kw))


def _make_temporal(opts: dict, ctx: PipelineContext) -> Callable:
    _check_opts("temporal-tile", opts, ("k",))
    try:
        k = int(opts["k"]) if "k" in opts else int(ctx.exchange_every)
    except ValueError:
        raise PipelineError(
            f"temporal-tile: k must be an integer, got {opts.get('k')!r}"
        )
    if k < 1:
        raise PipelineError(f"temporal-tile: k must be >= 1, got {k}")
    return _named("temporal-tile", lambda f: temporal_tile(f, k))


def _make_simple(name: str, fn: Callable) -> Callable:
    """Factory for option-less stages; rejects any option (mlir-opt does)."""

    def factory(opts: dict, ctx: PipelineContext) -> Callable:
        _check_opts(name, opts)
        return _named(name, fn)

    return factory


# name -> factory(opts, ctx) -> pass callable
PASS_REGISTRY: dict[str, Callable] = {
    "fuse": _make_fuse,
    "cse": _make_simple("cse", cse_apply_bodies),
    "dce": _make_simple("dce", dce),
    "decompose": _make_decompose,
    "swap-elim": _make_simple("swap-elim", eliminate_redundant_swaps),
    # deep-halo temporal tiling: one exchange epoch, k steps (k=1: identity)
    "temporal-tile": _make_temporal,
    "shrink-swaps": _make_simple("shrink-swaps", shrink_swaps_to_consumers),
    "diagonal": _make_simple("diagonal", use_diagonal_exchanges),
    # "overlap" is tag + split: after it, tagged swaps are already comm ops
    "overlap": _make_simple("overlap", _tag_and_split),
    "overlap-tag": _make_simple("overlap-tag", enable_comm_compute_overlap),
    "split-overlap": _make_simple(
        "split-overlap", split_overlapped_applies
    ),
    "lower-comm": _make_simple("lower-comm", lower_dmp_to_comm),
    # package each epoch's apply chain into ONE stencil.fused_epoch op so
    # the kernel backend emits a single pallas_call per epoch
    "fuse-epoch-kernel": _make_simple("fuse-epoch-kernel", fuse_epoch_kernels),
}


def build_pipeline(
    spec: str, ctx: Optional[PipelineContext] = None
) -> list:
    """Parse ``spec`` and instantiate every stage against the registry."""
    ctx = ctx or PipelineContext()
    passes = []
    for name, opts in parse_pipeline(spec):
        factory = PASS_REGISTRY.get(name)
        if factory is None:
            raise PipelineError(
                f"unknown pass {name!r}; registered: "
                f"{', '.join(sorted(PASS_REGISTRY))}"
            )
        passes.append(factory(opts, ctx))
    return passes


def run_pipeline(
    func: ir.FuncOp,
    spec: str,
    ctx: Optional[PipelineContext] = None,
    verify: bool = True,
    after_each: Optional[Callable[[str, ir.FuncOp], None]] = None,
) -> tuple:
    """Run a pipeline spec over ``func``; returns (result, timings)."""
    pm = PassManager(build_pipeline(spec, ctx), verify=verify)
    out = pm.run(func, after_each=after_each)
    return out, pm.timings
