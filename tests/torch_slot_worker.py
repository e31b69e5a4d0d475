"""The stencil serving engine's slot axis over one process per rank (gloo
on the CPU), held against the single controller, the solo runs and the
reference: a subprocess worker (``tests/test_torch_slot_processes.py``).

    python tests/torch_slot_worker.py DIRECTORY

The launcher runs the reference's solo ``time_loop`` of every request
(JAX on the CPU, one device) and saves it under ``DIRECTORY``; then it
spawns 4 processes (``torch.multiprocessing``, spawn, a file store under
``DIRECTORY``).  Every process joins the world with
``repro_torch.dist.processes.init(device="cpu")`` and drives, for each
layout, one ``StencilEngine`` whose buckets run over process meshes, and
the same engine calls over the single controller's CPU ranks of the same
layout:

- layouts: (slot=2, x=2) — the bucket's spatial mesh is x=2, a block of
  the world, and the slot axis of 2 is factored out of the world's 4
  processes — and (slot=1, x=2, y=2);
- buckets: heat so4 64² fused k=2 (K2's plain route) and wave so4 64²
  k=1, two slots each; 6 requests of 4-12 steps, three with frames;
- after the first engine step the heat bucket is resized to 4 slots;
  after the second the wave bucket is evacuated and readmitted onto one
  device (``Target(device="cpu")``) in a second engine;
- each process's pool block is its share of the pool (a quarter on
  (2, 2)); every result and frame is bitwise the single controller's and
  the solo one-device run, and within rtol=atol=1e-5 of the reference;
- pools of 3 slots resized to 1 over x=2, which no slot axis of 2
  divides, pool over (slot=1, x=2) blocks of the world, bitwise solo;
- ``Target(slot_axis=...)`` over a process mesh builds; a slot axis the
  world cannot hold raises ``TargetError`` naming both numbers.

Prints ``ALL OK`` and exits 0 when every case holds.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPE, SO = (64, 64), 4
# (rid, program, n_steps, frame_every): the engine numbers requests in order
REQUESTS = [(0, "heat", 4, 2), (1, "heat", 8, 0), (2, "wave", 5, 2), (3, "heat", 12, 4),
            (4, "wave", 7, 0), (5, "heat", 6, 0)]
KW = {"heat": {"exchange_every": 2, "fused_epoch": True, "backend": "cuda"}, "wave": {}}
LAYOUTS = {"slot2-x2": ((2,), ("x",)), "slot1-2x2": ((2, 2), ("x", "y"))}
_EVACUATIONS: list = []


def _programs(pkg):
    import _torch_programs as P

    return {"heat": P.heat(pkg, SHAPE, SO, "zero"), "wave": P.wave(pkg, SHAPE, SO, "zero")}


def _states(progs):
    import _torch_programs as P

    return {rid: [np.ascontiguousarray(a) for a in P.rand_state(progs[kind], 11 + rid)]
            for rid, kind, _, _ in REQUESTS}


def _strategy(shape):
    from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d

    return make_strategy_1d(shape[0]) if len(shape) == 1 else make_strategy_2d(tuple(shape))


def _same(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: differs, max |diff| {float((got - want).abs().max())}")


def _drive(progs, states, target_of, directory, slots=2, resize=4):
    """The engine scenario: submit, one step, resize the heat bucket to
    ``resize`` slots, one step, evacuate wave and readmit it onto one
    device in a second engine, run both to the end.  Every bucket pools
    over its slot-axis sibling throughout.  Returns ``({rid: result},
    {rid: [(step, arrays)]}, {bucket: pool block bytes})``."""
    from repro_torch import api
    from repro_torch.serve.stencil import StencilEngine, StencilEngineConfig

    engine = StencilEngine(StencilEngineConfig(slots_per_group=slots, bucket_idle_steps=0))
    frames: dict = {}
    for rid, kind, n, every in REQUESTS:
        engine.submit(progs[kind], [torch.from_numpy(a) for a in states[rid]], n,
                      target_of(kind), frame_every=every,
                      on_frame=lambda f, r=rid: frames.setdefault(r, []).append(
                          (f.step, [torch.from_numpy(a) for a in f.arrays])))
    pool_bytes = {}
    engine.step()
    # every bucket dispatches over its slot-axis sibling (no solo fallback)
    assert all(g.executable is not None and g.executable.target.slot_axis == "slot"
               for g in engine.scheduler.groups.values())
    for group in engine.scheduler.groups.values():
        name = next(k for k, p in progs.items() if p.fingerprint == group.key[0])
        local = sum(t.numel() * 4 for x in group.state
                    for t in (x.shards if hasattr(x, "shards") else (x,)))
        whole = sum(int(np.prod(x.shape)) * 4 for x in group.state)
        pool_bytes[name] = (local, whole)
    heat = next(g for g in engine.scheduler.groups.values()
                if g.compiled.program.fingerprint == progs["heat"].fingerprint)
    engine.resize_bucket(heat, resize)
    engine.step()
    assert heat.capacity == resize and heat.executable is not None, heat.capacity
    from repro_torch.dist import processes

    _EVACUATIONS.append(None)
    evac = processes.broadcast_object(os.path.join(directory, f"evac-{len(_EVACUATIONS)}"))
    moved = engine.evacuate(progs["wave"].fingerprint, evac)
    second = StencilEngine(StencilEngineConfig(slots_per_group=2, bucket_idle_steps=0))
    handles = second.admit_evacuated(evac, progs["wave"], target=api.Target(device="cpu"))
    assert len(moved) == len(handles) == 2, (len(moved), len(handles))
    done = engine.run() + second.run()
    results = {}
    for req in engine.finished:
        results[req.rid] = [torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor)
                            else a for a in req.result]
    for h, req in zip(handles, moved):  # the second engine numbers its own requests
        results[req.rid] = list(h.result())
    assert len(results) == len(REQUESTS), sorted(results)
    del done
    return results, frames, pool_bytes


def _solo(progs, states):
    from repro_torch import api

    out = {}
    for rid, kind, n, _ in REQUESTS:
        step = api.compile(progs[kind], api.Target(device="cpu", **KW[kind]))
        out[rid] = list(step.time_loop([torch.from_numpy(a) for a in states[rid]], n))
    return out


def child(rank, n, directory, store):
    import faulthandler

    faulthandler.dump_traceback_later(150)
    torch.set_num_threads(1)
    from repro_torch.dist import processes

    processes.init(device="cpu", rank=rank, world_size=n, local_rank=rank, timeout_s=120,
                   init_method=f"file://{os.path.abspath(os.path.join(directory, store))}")
    try:
        _check(rank, n, directory)
        processes.barrier()
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    faulthandler.cancel_dump_traceback_later()
    processes.shutdown()


def _check(rank, n, directory):
    from repro_torch import api
    from repro_torch.dist import Mesh, processes

    progs = _programs("repro_torch")
    states = _states(progs)
    solo = _solo(progs, states)
    ref = {rid: np.load(os.path.join(directory, f"ref_{rid}.npy")) for rid, *_ in REQUESTS}
    for layout, (shape, names) in LAYOUTS.items():
        pmesh = processes.process_mesh(shape, names)
        cmesh = Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                              dtype=object).reshape(shape), names)

        def over(mesh):
            return lambda kind: api.Target(mesh=mesh, strategy=_strategy(shape), **KW[kind])

        got, frames, pool_bytes = _drive(progs, states, over(pmesh), directory)
        want, want_frames, _ = _drive(progs, states, over(cmesh), directory)
        for rid, *_ in REQUESTS:
            for i, (g, w, s) in enumerate(zip(got[rid], want[rid], solo[rid])):
                _same(g, w, f"{layout} request {rid} buffer {i} vs the single controller")
                _same(g, s, f"{layout} request {rid} buffer {i} vs its solo run")
            np.testing.assert_allclose(got[rid][-1].numpy(), ref[rid], rtol=1e-5, atol=1e-5)
        assert sorted(frames) == sorted(want_frames) == [0, 2, 3], sorted(frames)
        for rid in frames:
            assert [s for s, _ in frames[rid]] == [s for s, _ in want_frames[rid]], rid
            for (s, g), (_, w) in zip(frames[rid], want_frames[rid]):
                for a, b in zip(g, w):
                    _same(a, b, f"{layout} request {rid}'s frame at step {s}")
        for name, (local, whole) in pool_bytes.items():  # a quarter on 4 processes
            assert local * n == whole, (layout, name, local, whole)
        # the slot-axis sibling itself against the single controller's on 4
        # CPU ranks of the same layout, over a pool of 4
        for kind, prog in progs.items():
            spatial = api.Target(mesh=pmesh, strategy=_strategy(shape), **KW[kind])
            sib = api.pooled_target(spatial, slots=n // pmesh.size)
            one = api.pooled_target(api.Target(mesh=cmesh, strategy=_strategy(shape), **KW[kind]),
                                    slots=n // pmesh.size, devices=[torch.device("cpu")] * n)
            assert sib.mesh.shape == one.mesh.shape and sib.mesh.processes, sib.mesh.shape
            import _torch_programs as P

            rows = [P.rand_state(prog, 100 + j) for j in range(4)]
            pool = [torch.from_numpy(np.stack(b)) for b in zip(*rows)]
            steps = 2 * KW[kind].get("exchange_every", 1)
            for g, w in zip(api.compile(prog, sib).time_loop(pool, steps),
                            api.compile(prog, one).time_loop(pool, steps)):
                _same(g, w, f"{layout} {kind}: the process sibling vs the single controller's")
        print(f"rank {rank}: ok: {layout}: 6 requests, frames, a resize and an evacuation "
              f"bitwise the single controller and solo; pool block "
              f"{pool_bytes['heat'][0]} of {pool_bytes['heat'][1]} bytes", flush=True)
    # pools of 3 and 1 slots over x=2: no slot axis of 2 divides them, so
    # each pools over a (slot=1, x=2) block of the world, both blocks
    # running its slots, and every process holds half of it
    pmesh = processes.process_mesh((2,), ("x",))
    got, frames, pool_bytes = _drive(
        progs, states, lambda kind: api.Target(mesh=pmesh, strategy=_strategy((2,)), **KW[kind]),
        directory, slots=3, resize=1)
    for rid, *_ in REQUESTS:
        for i, (g, s) in enumerate(zip(got[rid], solo[rid])):
            _same(g, s, f"pools of 3 and 1: request {rid} buffer {i} vs its solo run")
    assert sorted(frames) == [0, 2, 3], sorted(frames)
    for name, (local, whole) in pool_bytes.items():
        assert local * 2 == whole, (name, local, whole)
    print(f"rank {rank}: ok: pools of 3 and 1 slots over (slot=1, x=2) blocks bitwise solo",
          flush=True)
    # Target(slot_axis=...) over a process mesh, and a world too small
    t = api.Target(mesh=processes.process_mesh((2, 2), ("slot", "x")),
                   strategy=_strategy((2,)), slot_axis="slot")
    assert t.distributed and t.spatial_ranks == 2
    spatial = api.Target(mesh=processes.process_mesh((2, 2), ("x", "y")),
                         strategy=_strategy((2, 2)))
    try:
        api.pooled_target(spatial, slots=2)
    except api.TargetError as e:
        assert "needs 8 processes" in str(e) and "the world has 4" in str(e), e
    else:
        raise AssertionError("a slot axis of 2 over 4 processes of 4 did not raise")
    print(f"rank {rank}: ok: slot-axis targets over processes", flush=True)


def spawn(n, directory):
    import torch.multiprocessing as mp

    mp.start_processes(child, args=(n, directory, "store-slot"), nprocs=n, join=True,
                       start_method="spawn")


def reference(directory):
    """The reference's solo run of every request (JAX on the CPU)."""
    from repro import api as rapi

    progs = _programs("repro")
    states = _states(_programs("repro_torch"))
    for rid, kind, n, _ in REQUESTS:
        kw = {"exchange_every": KW[kind].get("exchange_every", 1)}
        out = rapi.compile(progs[kind], rapi.Target(**kw)).time_loop(states[rid], n)
        np.save(os.path.join(directory, f"ref_{rid}.npy"), np.asarray(out[-1]))


def main(argv):
    directory = argv[1]
    reference(directory)
    spawn(4, directory)
    print("ALL OK")


if __name__ == "__main__":
    main(sys.argv)
