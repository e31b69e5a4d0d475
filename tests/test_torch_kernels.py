"""Kernel K1 (``repro_torch.kernels``): the star ops against the reference's
Pallas kernel (interpret mode) and against the port's own oracles, the
generated CUDA source read as text, and the kernel against its plain
version on the card (marked ``gpu``; skips without one).

Tensors here lie on the CPU, so the K1 wrapper runs its plain version;
the CUDA kernel itself runs only in the ``gpu`` test and ``chip_smoke.py``.
Across frameworks the bar is rtol=atol=1e-5 (XLA may fuse a*b+c).
"""
import re

import numpy as np
import pytest
import torch

import _torch_programs as P
from repro_torch import api
from repro_torch.core.fd import laplacian_star, radius
from repro_torch.kernels import dispatch_stats, ops, ref, reset_dispatch_stats
from repro_torch.kernels.stencil_apply import (
    CHUNK_ROWS,
    ROWS_PER_STEP,
    SLICE_TILE,
    check_windows,
    emit_apply_cuda,
    run_apply_cuda,
    slice_plans,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def _reference():
    """The reference's ops, in Pallas interpret mode.  Imported here, not
    at the top, so that the ``gpu`` test also runs where JAX is missing."""
    import jax.numpy as jnp
    from repro.kernels import ops as rops

    return jnp, rops


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_laplacian_matches_reference_and_oracle(order, rank):
    jnp, rops = _reference()
    h = radius(order)
    core = {1: (64,), 2: (16, 24), 3: (6, 8, 10)}[rank]
    x = _rand(tuple(c + 2 * h for c in core), seed=order * 10 + rank)
    got = ops.laplacian(torch.from_numpy(x), order=order)
    _close(got, rops.laplacian(jnp.asarray(x), order=order, interpret=True))
    oracle = ref.star_stencil_ref(torch.from_numpy(x), laplacian_star(rank, order), (h,) * rank)
    torch.testing.assert_close(got, oracle, **TOL)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_heat_step_matches_reference_and_oracle(order):
    jnp, rops = _reference()
    h = radius(order)
    x = _rand((24 + 2 * h, 40 + 2 * h), seed=order)
    got = ops.heat_step(torch.from_numpy(x), 0.1, order=order)
    _close(got, rops.heat_step(jnp.asarray(x), 0.1, order=order, interpret=True))
    torch.testing.assert_close(got, ref.heat_step_ref(torch.from_numpy(x), 0.1, order, h), **TOL)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_wave_step_matches_reference_and_oracle(order):
    jnp, rops = _reference()
    h = radius(order)
    u_t = _rand((16 + 2 * h, 16 + 2 * h), seed=order + 1)
    u_tm1 = _rand((16 + 2 * h, 16 + 2 * h), seed=order + 2)
    core = tuple(slice(h, s - h) for s in u_t.shape)
    got = ops.wave_step(torch.from_numpy(u_t), torch.from_numpy(u_tm1[core]), 0.25, order=order)
    want = rops.wave_step(jnp.asarray(u_t), jnp.asarray(u_tm1[core]), 0.25, order=order, interpret=True)
    _close(got, want)
    oracle = ref.wave_step_ref(torch.from_numpy(u_t), torch.from_numpy(u_tm1), 0.25, order, h)
    torch.testing.assert_close(got, oracle, **TOL)


def _random_star(rng, rank, halo):
    coeffs = {}
    for d in range(rank):
        for o in range(-halo, halo + 1):
            if o and rng.random() < 0.7:
                off = tuple(o if k == d else 0 for k in range(rank))
                coeffs[off] = float(rng.standard_normal())
    coeffs[(0,) * rank] = float(rng.standard_normal())
    return coeffs


@pytest.mark.parametrize("seed", range(6))
def test_random_star_shapes(seed):
    jnp, rops = _reference()
    rng = np.random.default_rng(seed)
    rank = int(rng.integers(1, 4))
    halo = int(rng.integers(1, 4))
    core = tuple(int(n) for n in rng.integers(3, 14, size=rank))
    coeffs = _random_star(rng, rank, halo)
    x = rng.standard_normal(tuple(c + 2 * halo for c in core)).astype(np.float32)
    got = ops.star_stencil(torch.from_numpy(x), coeffs, (halo,) * rank)
    _close(got, rops.star_stencil(jnp.asarray(x), coeffs, (halo,) * rank, interpret=True))
    oracle = ref.star_stencil_ref(torch.from_numpy(x), coeffs, (halo,) * rank)
    torch.testing.assert_close(got, oracle, **TOL)


def test_3d_box_stencil():
    jnp, rops = _reference()
    offs = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    coeffs = {o: 1.0 / 27.0 for o in offs}
    x = _rand((10, 12, 14), seed=9)
    got = ops.star_stencil(torch.from_numpy(x), coeffs, (1, 1, 1))
    _close(got, rops.star_stencil(jnp.asarray(x), coeffs, (1, 1, 1), interpret=True))
    torch.testing.assert_close(got, ref.star_stencil_ref(torch.from_numpy(x), coeffs, (1, 1, 1)), **TOL)


# -------------------------------------------------------------------------
# the generated CUDA source, read as text
# -------------------------------------------------------------------------


def _heat_apply(shape=(16, 20), so=4, exchange_every=1):
    prog = P.heat("repro_torch", shape, so)
    step = api.compile(prog, api.Target(backend="cuda", device="cpu", exchange_every=exchange_every))
    return step.kernel_applies()


def _source(apply_op):
    return emit_apply_cuda(
        apply_op,
        [o.type.bounds.shape for o in apply_op.operands],
        [o.type.bounds.lb for o in apply_op.operands],
        apply_op.result_bounds,
    )


def _f32_bits(v):
    return int(np.array(v, dtype=np.float32).view(np.uint32))


def test_emitted_heat_source_bakes_constants_and_shapes():
    (apply_op,) = _heat_apply()
    src = _source(apply_op)
    # every IR constant appears as its exact float32 bit pattern
    from repro_torch.core import ir

    consts = [op.value for op in apply_op.body.ops if isinstance(op, ir.ConstantOp)]
    for c in consts:
        assert f"__int_as_float(0x{_f32_bits(c):08x})" in src, c
    # the result's 16 rows and 20 columns: one 64-row chunk, one 256-column tile
    assert "const int rows = 16 - z < 64 ? 16 - z : 64;" in src
    assert "const int w1 = 20 - u1 < 256 ? 20 - u1 : 256;" in src
    step = ROWS_PER_STEP[2]
    assert src.count("out0[o + ") == step  # one store per point of a column's step
    # a register-blocked column: each dim-0 tap row is read once a step
    # (rows 0..step+3 of the so4 star's dim-0 taps), each minor tap once a point
    loads = re.findall(r"const float x0_\d+_(\d+) = ring0\[slot(\d+) \* (\d+) \+ e0 \+ (-?\d+)\]", src)
    assert len(loads) == (step + 4) + 4 * step
    assert all(r == slot for r, slot, _, _ in loads)
    accesses = [op for op in apply_op.body.ops if op.name == "stencil.access"]
    reads = re.findall(r"const float v\d+ = (x0_\d+_\d+);", src)
    assert len(reads) == step * len(accesses)  # one per IR access and point, in body order
    assert "K1_EXPORT" in src and src.count("__syncthreads()") == 1  # one barrier a step


def _copied_columns(plan, u, w, row_len):
    """The array columns one staged slice row of a CTA at tile origin ``u``
    with ``w`` valid columns copies, as the emitted copy loop walks them."""
    start = u + plan.base[-1] - plan.shift
    cols = set()
    for l in range(0, plan.row, plan.width):
        if l < w + plan.shift + plan.ext[-1]:
            assert start + l >= 0 and start + l + plan.width <= row_len
            cols.update(range(start + l, start + l + plan.width))
    return cols


@pytest.mark.parametrize("exchange_every", [1, 4])
def test_emitted_loads_stay_inside_their_operand(exchange_every):
    """Every staged copy lies inside its operand, every ring read inside its
    slice, and every tap's ring row within the slices the ring holds — at
    both edges of grown epoch frames too."""
    for apply_op in _heat_apply((18, 16), 4, exchange_every):
        src = _source(apply_op)
        shapes = [o.type.bounds.shape for o in apply_op.operands]
        origins = [o.type.bounds.lb for o in apply_op.operands]
        rb = apply_op.result_bounds
        (plan,) = slice_plans(apply_op, shapes, origins, rb).values()
        assert plan.base[0] >= 0 and plan.base[0] + rb.shape[0] + plan.ext[0] <= shapes[0][0]
        for u in range(0, rb.shape[1], SLICE_TILE[2][0]):
            w = min(SLICE_TILE[2][0], rb.shape[1] - u)
            _copied_columns(plan, u, w, shapes[0][1])
        for r, floats, off in re.findall(r"ring0\[slot(\d+) \* (\d+) \+ e0 \+ (-?\d+)\]", src):
            assert int(floats) == plan.floats and 0 <= int(r) <= ROWS_PER_STEP[2] - 1 + plan.ext[0]
            assert 0 <= plan.shift + int(off) and plan.shift + SLICE_TILE[2][0] - 1 + int(off) < plan.floats


def _k1_spec(apply_op):
    return (
        apply_op,
        [tuple(o.type.bounds.shape) for o in apply_op.operands],
        [tuple(o.type.bounds.lb) for o in apply_op.operands],
        apply_op.result_bounds,
    )


K1_SLICE_CASES = {
    "heat2d-ragged": lambda: _heat_apply((70, 300), 4),
    "heat2d-grown-frames": lambda: _heat_apply((18, 270), 4, 4),
    "wave2d-two-operands": lambda: api.compile(
        P.wave("repro_torch", (20, 260), 4), api.Target(backend="cuda", device="cpu")
    ).kernel_applies(),
    "heat3d-ragged": lambda: _heat_apply((10, 11, 37), 4, 2),
    "star1d": lambda: [ops.star_apply_ir({(-3,): 0.5, (0,): 1.0, (2,): 0.25}, (600,), (3,))[0]],
}


@pytest.mark.parametrize("name", sorted(K1_SLICE_CASES))
def test_staged_slices_cover_exactly_the_access_extent(name):
    """For every CTA of K1's grid, at the tile edges and at ragged result
    shapes: each operand's staged rows are exactly the chunk's rows grown
    by the operand's dim-0 extent, and its staged columns exactly the
    accessed ones (the tile's valid columns grown by the access extent)
    widened to whole copies — all inside the operand."""
    for apply_op in K1_SLICE_CASES[name]():
        apply_op, shapes, origins, rb = _k1_spec(apply_op)
        src = emit_apply_cuda(apply_op, shapes, origins, rb)
        plans = slice_plans(apply_op, shapes, origins, rb)
        lifted = rb.rank == 1
        n = (1,) + rb.shape if lifted else rb.shape
        tile = SLICE_TILE[len(n)]
        for k, plan in plans.items():
            shape = (1,) + tuple(shapes[k]) if lifted else tuple(shapes[k])
            lo, hi = apply_op.access_extents()[k]
            lo, hi = ((0,) + lo, (0,) + hi) if lifted else (lo, hi)
            assert plan.ext == tuple(h - l for l, h in zip(lo, hi))
            assert f"if (q < rows + {plan.ext[0]})" in src
            for z in range(0, n[0], CHUNK_ROWS):
                rows = min(CHUNK_ROWS, n[0] - z)
                first, end = z + plan.base[0], z + plan.base[0] + rows + plan.ext[0]
                assert 0 <= first and end <= shape[0]
            for u in range(0, n[-1], tile[-1]):
                w = min(tile[-1], n[-1] - u)
                got = _copied_columns(plan, u, w, shape[-1])
                need = range(u + plan.base[-1], u + plan.base[-1] + w + plan.ext[-1])
                assert set(need) <= got
                widened = range(need.start - plan.shift,
                                -(-need.stop // plan.width) * plan.width)
                assert got == set(widened)
            if len(n) == 3:
                assert f"if (r < w1 + {plan.ext[1]} && l < w2 + {plan.shift + plan.ext[2]})" in src
                for u in range(0, n[1], tile[0]):
                    w = min(tile[0], n[1] - u)
                    assert 0 <= u + plan.base[1] and u + plan.base[1] + w + plan.ext[1] <= shape[1]


def test_window_outside_operand_is_refused():
    (apply_op,) = _heat_apply()
    shapes = [o.type.bounds.shape for o in apply_op.operands]
    origins = [o.type.bounds.lb for o in apply_op.operands]
    check_windows(apply_op, shapes, origins, apply_op.result_bounds)
    short = [(s[0], s[1] - 1) for s in shapes]  # one column short at the high end
    with pytest.raises(ValueError, match="reads"):
        emit_apply_cuda(apply_op, short, origins, apply_op.result_bounds)
    with pytest.raises(ValueError, match="reads"):
        run_apply_cuda(apply_op, [torch.zeros(short[0])], origins, apply_op.result_bounds)


def test_emitted_source_writes_every_result():
    prog = P.mixed_ops("repro_torch")
    step = api.compile(prog, api.Target(backend="cuda", device="cpu"))
    (apply_op,) = step.kernel_applies()
    src = _source(apply_op)
    for needle in ("out0[o + 0LL] =", "out1[o + 0LL] =", "sqrtf(", "expf(", "fabsf(", ">= 0.0f) ?",
                   "static_cast<float>(z + s + 0)"):
        assert needle in src, needle


def test_wrapper_takes_plain_version_on_cpu_and_counts_calls_only():
    (apply_op,) = _heat_apply()
    x = torch.from_numpy(_rand(apply_op.operands[0].type.bounds.shape))
    reset_dispatch_stats()
    (out,) = run_apply_cuda(apply_op, [x], [apply_op.operands[0].type.bounds.lb],
                            apply_op.result_bounds)
    assert dispatch_stats().as_dict() == {
        "apply_calls": 1, "apply_launches": 0,
        "fused_epoch_calls": 0, "fused_epoch_launches": 0,
    }
    assert out.shape == (16, 20) and out.dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        run_apply_cuda(apply_op, [x.double()], [apply_op.operands[0].type.bounds.lb],
                       apply_op.result_bounds)


def test_launcher_is_emitted_once_per_apply_and_shape(monkeypatch):
    """A time loop re-launches one apply at one shape: its source is
    emitted and its windows checked once, a new shape emits again."""
    import weakref

    from repro_torch.kernels import stencil_apply

    emitted = []
    monkeypatch.setattr(stencil_apply, "_BOUND", weakref.WeakKeyDictionary())
    monkeypatch.setattr(stencil_apply, "_launcher", lambda src, n: emitted.append(src) or len(emitted))
    (apply_op,) = _heat_apply()
    shapes = [o.type.bounds.shape for o in apply_op.operands]
    origins = [o.type.bounds.lb for o in apply_op.operands]
    rb = apply_op.result_bounds
    first = stencil_apply._kernel_for(apply_op, shapes, origins, rb)
    assert stencil_apply._kernel_for(apply_op, list(shapes), list(origins), rb) == first
    assert len(emitted) == 1
    wider = [(s[0], s[1] + 1) for s in shapes]
    stencil_apply._kernel_for(apply_op, wider, origins, rb)
    assert len(emitted) == 2 and emitted[1] != emitted[0]


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """No fallback: an nvcc that fails makes build() raise with its output,
    and leaves no library behind."""
    from repro_torch.kernels import stencil_apply

    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    monkeypatch.setattr(stencil_apply, "BUILD_DIR", tmp_path / "build")
    (apply_op,) = _heat_apply()
    src = _source(apply_op)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        stencil_apply.build([src])
    assert not stencil_apply.library_path(src).exists()
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch):
    from repro_torch.kernels import stencil_apply

    monkeypatch.setattr(stencil_apply.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(stencil_apply.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        stencil_apply.find_nvcc()


def test_other_devices_are_refused():
    """Only CPU tensors take the plain version; any other non-CUDA device
    raises instead of computing somewhere else."""
    (apply_op,) = _heat_apply()
    ob = apply_op.operands[0].type.bounds
    x = torch.empty(ob.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA or"):
        run_apply_cuda(apply_op, [x], [ob.lb], apply_op.result_bounds)


# -------------------------------------------------------------------------
# on the card
# -------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    """K1 on the card == its plain version on the card, bitwise for + - * /
    bodies (heat 2D/3D and epoch frames, wave, a 1-D and a 2-D random
    star); the index/select/sqrt/exp apply with two results within 2 ulp
    (sqrtf/expf against torch's own); every launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.lowering import eval_apply_body

    applies = _heat_apply((256, 192), 8) + _heat_apply((64, 48, 40), 4, 2)
    wave = P.wave("repro_torch", (128, 96), 4)
    applies += api.compile(wave, api.Target(backend="cuda")).kernel_applies()
    rng = np.random.default_rng(1)
    applies += [
        ops.star_apply_ir(_random_star(rng, 1, 2), (1000,), (2,))[0],
        ops.star_apply_ir(_random_star(rng, 2, 3), (100, 70), (3, 3))[0],
    ]
    mixed = api.compile(P.mixed_ops("repro_torch", (90, 70)), api.Target(backend="cuda"))
    (mixed_apply,) = mixed.kernel_applies()
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_dispatch_stats()
    for apply_op in applies + [mixed_apply]:
        arrays = [
            torch.randn(o.type.bounds.shape, device="cuda", generator=gen)
            for o in apply_op.operands
        ]
        origins = [o.type.bounds.lb for o in apply_op.operands]
        got = run_apply_cuda(apply_op, arrays, origins, apply_op.result_bounds)
        want = eval_apply_body(apply_op, arrays, origins, apply_op.result_bounds)
        torch.cuda.synchronize()
        assert len(got) == len(want) == len(apply_op.results)
        for g, w in zip(got, want):
            if apply_op is mixed_apply:
                torch.testing.assert_close(g, w, rtol=2.4e-7, atol=0.0)
            else:
                assert torch.equal(g, w)
    assert dispatch_stats().apply_launches == len(applies) + 1
