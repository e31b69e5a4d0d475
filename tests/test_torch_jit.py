"""The compiled step (``Target(jit=..., donate=...)``) and the overlap
path's in-place combine, on the CPU; the graph capture itself on the card
(marked ``gpu``).

- ``jit``/``donate`` are Target fields with the reference's defaults, in
  the fingerprint and the repr; ``donate_argnums`` names every field
  argument when both are on (``tests/test_api.py``'s donation tests);
  ``jit=True`` over a mesh on several cards is refused.
- On the CPU ``jit`` changes nothing: the plain route runs, bitwise.
- The ring the card replays its graphs on (``api._Ring``), run op by op
  here (a ring on the CPU captures nothing; ``step._graphed`` is forced
  on): every rotation phase of heat, wave and their epochs, fused or not,
  on one device and on 4 ranks, and ``__call__`` of fig-10 PW and tracer
  advection (three results, several inputs), of a program with a field of
  another shape and of one whose store leaves part of its output to the
  caller, each bitwise equal to the route without it.
- The overlap path writes its interior and frames into one tensor, the
  combine's result, and copies nothing in the combine; bitwise equal to
  the path without overlap on 1 and 4 ranks.
- Each generated kernel has a name of its own, by which a graph's census
  (``kernels.graphs``) tells K1, K2, the frames and PyTorch's own kernels
  apart.

This module imports no JAX, so its ``gpu`` tests run on the card.
"""
import numpy as np
import pytest
import torch

import _torch_programs as P
from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.core.lowering import StencilInterpreter
from repro_torch.core.dialects import stencil
from repro_torch.core.passes.decompose import make_strategy_2d, make_strategy_3d
from repro_torch.dist import Mesh, ShardedTensor, gather
from repro_torch.frontends import oec_like
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import dispatch_stats, graphs, reset_dispatch_stats
from repro_torch.kernels import epoch_kernel as k2
from repro_torch.kernels import stencil_apply as k1

CPU = torch.device("cpu")


def _mesh(device=CPU):
    return Mesh(np.array([device] * 4, dtype=object).reshape(2, 2), ("x", "y"))


def _on_2x2(device=CPU):
    return {"mesh": _mesh(device), "strategy": make_strategy_2d((2, 2))}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().max())


# -------------------------------------------------------------------------
# Target fields
# -------------------------------------------------------------------------


def test_jit_and_donate_default_fingerprint_and_repr():
    t = Target(device="cpu")
    assert t.jit is True and t.donate is False
    fps = {Target(device="cpu", jit=j, donate=d).fingerprint for j in (True, False)
           for d in (True, False)}
    assert len(fps) == 4
    assert "jit=False" in repr(Target(device="cpu", jit=False))
    assert "donate=True" in repr(Target(device="cpu", donate=True))
    step = api.compile(P.jacobi("repro_torch"), Target(device="cpu", donate=True))
    assert "jit=True" in repr(step) and "donate=True" in repr(step)


@pytest.mark.parametrize("donate,jit,want", [(True, True, (0, 1)), (False, True, ()),
                                             (True, False, ())])
def test_donate_argnums(donate, jit, want):
    """Every field argument is donated when both flags are on (the whole
    state is handed over), none otherwise, as the reference hands jax.jit
    its donate_argnums."""
    step = api.compile(P.jacobi("repro_torch"), Target(device="cpu", donate=donate, jit=jit))
    assert step.donate_argnums == want


def test_jit_over_several_cards_is_refused():
    """One captured graph runs on one device: a mesh over several cards
    needs the multi-process transport, so jit=True refuses it at
    construction (jit=False keeps running it from one thread)."""
    two = Mesh(np.array([torch.device("cuda", 0), torch.device("cuda", 1)] * 2,
                        dtype=object).reshape(2, 2), ("x", "y"))
    with pytest.raises(TargetError, match="Queue 1 item 2"):
        Target(mesh=two, strategy=make_strategy_2d((2, 2)))
    assert Target(mesh=two, strategy=make_strategy_2d((2, 2)), jit=False).jit is False
    assert Target(**_on_2x2(torch.device("cuda", 0))).jit  # one card: fine


# -------------------------------------------------------------------------
# jit on the CPU: the plain route
# -------------------------------------------------------------------------

PROGRAMS = {
    "heat": (lambda: P.heat("repro_torch", (16, 20), 4), {}),
    "heat-k4": (lambda: P.heat("repro_torch", (16, 20), 4), {"exchange_every": 4}),
    "wave": (lambda: P.wave("repro_torch", (16, 20), 4), {}),
    "wave-k4": (lambda: P.wave("repro_torch", (16, 20), 4), {"exchange_every": 4}),
    "wave-k4-fused": (lambda: P.wave("repro_torch", (16, 20), 4),
                      {"exchange_every": 4, "fused_epoch": True, "backend": "cuda"}),
    "heat-overlap-2x2": (lambda: P.heat("repro_torch", (16, 20), 4),
                         {"overlap": True, "backend": "cuda", **_on_2x2()}),
    "heat-periodic-overlap-2x2": (lambda: P.heat("repro_torch", (16, 20), 4, "periodic"),
                                  {"overlap": True, "backend": "cuda", **_on_2x2()}),
    "wave-k4-2x2": (lambda: P.wave("repro_torch", (16, 20), 4),
                    {"exchange_every": 4, "backend": "cuda", **_on_2x2()}),
}


def _state(prog, seed=3):
    return state_from_numpy(prog, P.rand_state(prog, seed), device="cpu")


def _plain(prog, kw):
    """The reference result: one device, jit=False, same backend knobs."""
    one = {k: v for k, v in kw.items() if k not in ("mesh", "strategy")}
    return api.compile(prog, Target(device="cpu", jit=False, **one))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_jit_on_the_cpu_is_the_plain_route(name):
    make, kw = PROGRAMS[name]
    prog = make()
    state = _state(prog)
    jitted = api.compile(prog, Target(device="cpu", **kw))
    plain = api.compile(prog, Target(device="cpu", jit=False, **kw))
    _same(jitted.time_loop(state, 8), plain.time_loop(state, 8))
    assert jitted._ring is None  # nothing was captured or allocated for it


def test_tracing_runs_the_compiled_step_op_by_op():
    """With ``repro_torch.obs`` tracing on, a call of a compiled step runs
    uncaptured, as the reference's traced loop runs its unjitted function."""
    from repro_torch.obs import trace as obs

    step = api._build(P.jacobi("repro_torch"), Target(device="cpu"))
    assert not step._graphed()  # the CPU: the plain route
    step._jit_on_card = True  # as compiled for the card
    assert step._graphed()
    obs.enable()
    try:
        assert not step._graphed()
    finally:
        obs.disable()
        obs.clear()


# -------------------------------------------------------------------------
# the ring of buffers, each phase run op by op
# -------------------------------------------------------------------------


def _ringed(prog, kw, donate):
    """A fresh artifact (not the cached one) whose compiled step's ring
    runs op by op on the CPU: every graphed call goes through the ring,
    without a capture."""
    step = api._build(prog, Target(device="cpu", donate=donate, **kw))
    step._graphed = lambda: True
    return step


def _ring_ptrs(step):
    return {t.data_ptr() for bufs in step._ring.bufs for t in bufs}


def _ptrs(xs):
    return {t.data_ptr() for x in xs for t in (x.shards if isinstance(x, ShardedTensor) else (x,))}


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_ring_phases_are_bitwise(name, donate):
    """``time_loop``, a chain of ``advance`` and a loop of ``step()`` calls
    through the ring equal the plain route bitwise; with donation the
    chain stays in the ring's buffers (no copy), without it every result
    is a copy the caller owns.  A loop of ``step()`` calls with donation
    that hands a result on twice is refused, as donation refuses it."""
    make, kw = PROGRAMS[name]
    prog = make()
    state = _state(prog)
    want = _plain(prog, kw).time_loop(state, 8)
    step = _ringed(prog, kw, donate)
    _same(step.time_loop(state, 8), want)
    s = step.shard_state(state)
    for _ in range(step.epochs(8)):
        s = step.advance(s)
        assert bool(_ptrs(s) & _ring_ptrs(step)) == donate
    _same([gather(x) for x in s], want)
    assert step._ring.phases == {"wave": 3}.get(name, 2)

    def loop():
        return api.time_loop(step.step(), state, step.epochs(8))

    if donate and step._mesh is None and step._ring.n_in > step._ring.n_ret:
        # the rotation passes each result on twice, as the newest state and
        # then as the oldest: a buffer donated to one call is used again
        with pytest.raises(RuntimeError, match="donated to an earlier call"):
            loop()
    else:
        _same(loop(), want)


def test_a_donated_state_cannot_be_used_again():
    prog = P.heat("repro_torch", (16, 20), 4)
    step = _ringed(prog, {}, donate=True)
    s0 = step.advance(_state(prog))
    s1 = step.advance(s0)
    with pytest.raises(RuntimeError, match="donated to an earlier call"):
        step.advance(s0)
    _same(step.advance(s1), _plain(prog, {}).time_loop(_state(prog), 3))


def test_a_state_still_held_is_not_overwritten():
    """With donation, a foreign state while the caller still holds what the
    ring handed out gets a ring of its own: the held state stays valid."""
    prog = P.heat("repro_torch", (16, 20), 4)
    step = _ringed(prog, {}, donate=True)
    held = step.advance(_state(prog, 1))
    kept = held[0].clone()
    ring = step._ring
    step.advance(_state(prog, 2))
    assert step._ring is not ring and torch.equal(held[0], kept)


def test_the_last_apply_writes_into_the_ring():
    """The apply whose whole result is stored writes straight into the
    ring slot (K1's ``out``): no copy of the result."""
    prog = P.heat("repro_torch", (16, 20), 4)
    step = _ringed(prog, {"backend": "cuda"}, donate=True)
    seen = []
    real = k1.run_apply_cuda

    def spy(*a, out=None, **kw):
        seen.append(out)
        return real(*a, out=out, **kw)

    k1.run_apply_cuda = spy
    try:
        (u,) = step.advance(_state(prog))
    finally:
        k1.run_apply_cuda = real
    (out,) = seen
    assert out is not None and out[0].data_ptr() == u.data_ptr()


def _on_2x2x1(device=CPU):
    mesh = Mesh(np.array([device] * 4, dtype=object).reshape(2, 2, 1), ("x", "y", "z"))
    return {"mesh": mesh, "strategy": make_strategy_3d((2, 2, 1))}


@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("name", ["pw_advection", "tracer_advection"])
def test_ring_calls_of_fig10_are_bitwise(name, donate, ranks):
    """``__call__`` over every field through the ring (fig-10 PW: one
    apply with three results; tracer: two applies, five inputs) equals the
    plain route bitwise, call after call, and leaves the caller's tensors
    as they were."""
    prog = P.advection("repro_torch", name, (12, 10, 6), "zero")
    kw = {"backend": "cuda", **(_on_2x2x1() if ranks == 4 else {})}
    args = _state_of(prog, prog.field_args)
    kept = [a.clone() for a in args]
    plain = api.compile(prog, Target(device="cpu", jit=False, **kw))
    step = _ringed(prog, kw, donate)
    for _ in range(2):
        _same(step(*args), plain(*args))
    _same(args, kept)
    assert step._ring.phases == 2  # three inputs, three results, one shape


def _state_of(prog, fields, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(tuple(f.type.bounds.shape), generator=gen) for f in fields]


class _Sized(oec_like.ProgramBuilder):
    """A builder whose named fields have shapes of their own (the others
    the core's)."""

    def __init__(self, name, shape, sizes):
        super().__init__(name, shape)
        self.sizes = sizes

    def _field(self, name):
        handle = super()._field(name)
        if name in self.sizes:
            self._arg_types[-1] = stencil.FieldType(stencil.Bounds.from_shape(self.sizes[name]))
        return handle


def _sized_program(sizes, coefficient):
    """Jacobi on a 16x20 core, plus a coefficient field ``c`` where
    ``coefficient``; ``sizes`` gives fields another shape."""
    p = _Sized("sized", (16, 20), sizes)
    u = p.input("u")
    c = p.input("c") if coefficient else None
    out = p.output("out")
    loads = [p.load(u)] + ([p.load(c)] if coefficient else [])

    def fn(b, u, *c):
        s = (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)) * 0.25
        return s + c[0].at(0, 0) if c else s

    p.store(p.apply(loads, fn), out)
    return p.finish(boundary="zero")


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("case", ["coefficient-18x22", "output-18x22"])
def test_ring_takes_fields_of_other_shapes(case, donate):
    """Fields of differing shapes get one buffer each in a ring of one
    phase: a coefficient field larger than the core, and an output larger
    than the store, whose other points come from the caller's tensor (as
    the plain route leaves them)."""
    coefficient = case.startswith("coefficient")
    prog = _sized_program({("c" if coefficient else "out"): (18, 22)}, coefficient)
    args = _state_of(prog, prog.field_args)
    plain = api.compile(prog, Target(device="cpu", jit=False))
    step = _ringed(prog, {}, donate)
    for _ in range(2):
        _same(step(*args), plain(*args))
    inputs = [args[i] for i in plain.input_indices]
    _same(step.step()(*inputs), plain.step()(*inputs))
    assert step._ring.phases == 1


@pytest.mark.parametrize("donate", [False, True])
def test_a_ring_of_one_phase_rotates_by_copy(donate):
    """A state of two shapes that a step maps onto itself (jacobi on a
    16x20 field, a 18x22 field whose core is carried over): the ring has
    one phase, and ``advance``/``time_loop`` copy each epoch's results
    into its input slots, bitwise the plain route."""
    p = _Sized("two_shapes", (16, 20), {"c": (18, 22), "c_out": (18, 22)})
    u, c = p.input("u"), p.input("c")
    u_out, c_out = p.output("u_out"), p.output("c_out")
    tu, tc = p.load(u), p.load(c)
    p.store(p.apply([tu], lambda b, u: (u.at(-1, 0) + u.at(1, 0)) * 0.5), u_out)
    p.store(p.apply([tc], lambda b, c: c.at(0, 0) * 0.5), c_out)
    prog = p.finish(boundary="zero")
    state = _state_of(prog, [prog.field_args[0], prog.field_args[1]])
    want = _plain(prog, {}).time_loop(state, 4)
    step = _ringed(prog, {}, donate)
    _same(step.time_loop(state, 4), want)
    s = step.shard_state(state)
    for _ in range(4):
        s = step.advance(s)
    _same(s, want)
    assert step._ring.phases == 1


def test_ring_refuses_another_dtype_as_the_plain_route_does():
    """Stencil tensors are float32: ``step(dtype)`` of another dtype and a
    float64 state raise TypeError through the ring, as on the plain
    route."""
    prog = P.heat("repro_torch", (16, 20), 4)
    (u,) = _state(prog)
    plain = api.compile(prog, Target(device="cpu", jit=False))
    step = _ringed(prog, {}, donate=False)
    for route in (plain, step):
        with pytest.raises(TypeError, match="float32"):
            route.step(torch.float64)(u)
        with pytest.raises(TypeError, match="float32"):
            route.step()(u.double())
        with pytest.raises(TypeError, match="float32"):
            route.advance((u.double(),))


# -------------------------------------------------------------------------
# kernel names and the census of a graph
# -------------------------------------------------------------------------


def test_each_generated_source_names_its_kernel():
    """K1 and K2 sources name their kernels by a hash of the source, and
    the name leads back to the op the source was emitted for."""
    prog = P.heat("repro_torch", (16, 20), 4, "periodic")
    step = api.compile(prog, Target(backend="cuda", overlap=True, device="cpu", **_on_2x2()))
    names = set()
    for a in step.kernel_applies():
        shapes = [tuple(o.type.bounds.shape) for o in a.operands]
        origins = [tuple(o.type.bounds.lb) for o in a.operands]
        src = k1.emit_apply_cuda(a, shapes, origins, a.result_bounds,
                                 out_strides=step.kernel_out_strides(a))
        name = graphs.kernel_name(src)
        assert name.startswith("k1_apply_") and f"#define k1_apply {name}" in src
        graphs.register(src, a)
        assert a in graphs.ops_of(f"_Z25{name}PKfPf")  # as libcuda gives it: mangled
        names.add(name)
    assert len(names) == 5  # the interior and four frames: five kernels
    fused = api.compile(prog, Target(backend="cuda", exchange_every=4, fused_epoch=True,
                                     device="cpu"))
    (epoch,) = fused.kernel_epochs()
    assert graphs.kernel_name(k2.emit_epoch_cuda(epoch)).startswith("k2_epoch_")
    with pytest.raises(ValueError, match="no kernel name"):
        graphs.kernel_name("// not generated")


def test_census_sorts_a_graphs_nodes():
    """K1 and K2 by their names, the nodes of given ops, copies (memcpy
    nodes and copy kernels), fills, and any other kernel."""
    prog = P.heat("repro_torch", (16, 20), 4)
    step = api.compile(prog, Target(backend="cuda", device="cpu"))
    (a,) = step.kernel_applies()
    src = k1.emit_apply_cuda(a, [tuple(a.operands[0].type.bounds.shape)],
                             [tuple(a.operands[0].type.bounds.lb)], a.result_bounds)
    graphs.register(src, a)
    mine = graphs.kernel_name(src)
    nodes = graphs.GraphCensus(
        kernels={
            f"_Z25{mine}PKfPf": 4,
            "_Z25k1_apply_0123456789abcdefPKfPf": 1,
            "_Z25k2_epoch_0123456789abcdefPKfPfii": 2,
            "void at::native::elementwise_kernel<direct_copy_kernel_cuda>": 3,
            "void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>": 1,
            "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>": 6,
        },
        memcpy=2, memset=1, other={5: 1},
    )
    assert (nodes.k1, nodes.k2, nodes.of([a]), nodes.copies, nodes.fills) == (5, 2, 4, 5, 2)
    assert nodes.others() == {
        "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>": 6}


# -------------------------------------------------------------------------
# the overlap path: frames through K1, the combine in place
# -------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_overlap_parts_write_one_result_in_place(ranks, boundary, monkeypatch):
    """Each rank's interior and frames write views of one tensor (the
    combine's result), the combine copies nothing, and the result is
    bitwise the path without overlap's."""
    prog = P.heat("repro_torch", (16, 20), 4, boundary)
    dist = _on_2x2() if ranks == 4 else {}
    state = _state(prog)
    want = api.compile(prog, Target(backend="cuda", device="cpu", **dist)).time_loop(state, 4)
    step = api.compile(prog, Target(backend="cuda", overlap=True, device="cpu", **dist))
    seen = []
    real = k1.run_apply_cuda

    def spy(*a, out=None, **kw):
        seen.append(out)
        return real(*a, out=out, **kw)

    def no_copy(*a, **kw):
        raise AssertionError("the combine copied its parts")

    monkeypatch.setattr(k1, "run_apply_cuda", spy)
    monkeypatch.setattr(StencilInterpreter, "_exec_combine", no_copy)
    reset_dispatch_stats()
    got = step.time_loop(state, 4)
    _same(got, want)
    parts = len(step.kernel_applies())
    assert parts == 5 and dispatch_stats().apply_calls == 4 * ranks * parts
    assert len(seen) == 4 * ranks * parts
    # each op runs on every rank before the next: a step's calls are
    # [part 0 of ranks 0..n-1, part 1 of ranks 0..n-1, ...]
    for step_start in range(0, len(seen), parts * ranks):
        for r in range(ranks):
            mine = seen[step_start + r:step_start + parts * ranks:ranks]
            assert len({o[0].untyped_storage().data_ptr() for o in mine}) == 1
            assert all(o[0]._base is not None for o in mine)


# -------------------------------------------------------------------------
# on the card
# -------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


GPU_CASES = {
    "heat": (lambda: P.heat("repro_torch", (256, 320), 4), {}),
    "wave": (lambda: P.wave("repro_torch", (256, 320), 4), {}),
    "heat-fused-k4": (lambda: P.heat("repro_torch", (256, 320), 4),
                      {"exchange_every": 4, "fused_epoch": True}),
    "heat-overlap-2x2": (lambda: P.heat("repro_torch", (256, 320), 4, "periodic"),
                         {"overlap": True, "mesh": "2x2"}),
}


def _gpu_target(kw, dev, **flags):
    kw = dict(kw)
    if kw.pop("mesh", None):
        kw.update(_on_2x2(dev))
    return Target(backend="cuda", **kw, **flags)


def _prebuild(*steps):
    """Build every kernel the steps launch in one parallel nvcc round (a
    first launch would build its source alone)."""
    k1.build(list(dict.fromkeys(s for step in steps for s in step.kernel_sources())))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_captured_equals_uncaptured_on_card(name):
    """jit=True (one graph replay per epoch) is bitwise the jit=False run,
    with and without donation."""
    dev = _card()
    make, kw = GPU_CASES[name]
    prog = make()
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tuple(torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                  for f in prog.input_fields)
    plain = api.compile(prog, _gpu_target(kw, dev, jit=False))
    _prebuild(plain)
    want = plain.time_loop(state, 8)
    for donate in (False, True):
        got = api.compile(prog, _gpu_target(kw, dev, donate=donate)).time_loop(state, 8)
        torch.cuda.synchronize()
        _same(got, want)


@pytest.mark.gpu
def test_replays_are_counted_on_card():
    """Each graph holds one kernel node per launch its capture made (the
    census of the graph itself): 4 ranks x 5 applies of K1, 16 of them
    frames, and no kernel besides K1, copies and fills.  Each replay adds
    the graph's nodes to dispatch_stats and graph_stats: K1 launches =
    ranks x applies per epoch, as the uncaptured run counts them."""
    dev = _card()
    prog = P.heat("repro_torch", (256, 320), 4, "periodic")
    step = api.compile(prog, _gpu_target({"overlap": True, "mesh": "2x2"}, dev))
    _prebuild(step)
    state = (torch.randn(256, 320, device=dev),)
    step.time_loop(state, 8)  # captures both phases
    frames = [a for a in step.kernel_applies() if a.attributes["part"].value == "frame"]
    assert len(frames) == 4
    for _, nodes, _ in step._ring.graphs.values():
        assert (nodes.k1, nodes.k2, nodes.of(frames)) == (20, 0, 16)
        assert nodes.others() == {}
    reset_dispatch_stats()
    api.reset_graph_stats()
    step.time_loop(state, 8)
    torch.cuda.synchronize()
    assert step.kernel_dispatches == {"fused_epoch": 0, "apply": 5, "total": 5}
    assert dispatch_stats().apply_launches == 4 * 5 * 8
    stats = api.graph_stats()
    assert (stats.captures, stats.replays) == (0, 8)
    replayed = graphs.GraphCensus(stats.kernel_nodes)
    assert (replayed.k1, replayed.of(frames)) == (4 * 5 * 8, 4 * 4 * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pw_advection", "tracer_advection"])
def test_fig10_calls_captured_equal_uncaptured_on_card(name):
    """``__call__`` of fig-10 PW and tracer advection (chip_smoke.py's
    copies of the kernels) as a graph replay, with and without donation,
    on one device and over 2x2x1 ranks: bitwise the jit=False call."""
    import os
    import sys

    from repro_torch.frontends import psyclone_like

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    dev = _card()
    prog = psyclone_like.recognize(getattr(chip_smoke, name), (64, 48, 32), boundary="periodic")
    gen = torch.Generator(device=dev).manual_seed(0)
    args = [torch.randn(f.type.bounds.shape, device=dev, generator=gen) for f in prog.field_args]
    for kw in ({}, _on_2x2x1(dev)):
        plain = api.compile(prog, Target(backend="cuda", jit=False, **kw))
        _prebuild(plain)
        want = plain(*args)
        for donate in (False, True):
            step = api.compile(prog, Target(backend="cuda", donate=donate, **kw))
            for _ in range(2):
                got = step(*args)
                torch.cuda.synchronize()
                _same(got, want)


@pytest.mark.gpu
def test_donated_state_stays_in_the_ring_on_card():
    """With donate=True a chain of advance calls replays in place: every
    state it hands back lies in the ring's buffers, two of them for heat."""
    dev = _card()
    prog = P.heat("repro_torch", (256, 320), 4)
    step = api.compile(prog, _gpu_target({}, dev, donate=True))
    state = step.advance((torch.randn(256, 320, device=dev),))
    ring = {t.data_ptr() for bufs in step._ring.bufs for t in bufs}
    seen = set()
    for _ in range(6):
        state = step.advance(state)
        seen.add(state[0].data_ptr())
    torch.cuda.synchronize()
    assert seen <= ring and len(seen) == 2
