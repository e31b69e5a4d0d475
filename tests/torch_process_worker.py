"""One process per rank over ``torch.distributed`` (gloo on the CPU),
each case held against the single controller's virtual CPU ranks: a
subprocess worker (``tests/test_torch_processes.py``).

    python tests/torch_process_worker.py SCENARIO DIRECTORY

The worker spawns its processes (``torch.multiprocessing``, spawn, a
file store under ``DIRECTORY``); every process joins the world with
``repro_torch.dist.processes.init(device="cpu")``, runs the scenario's
cases on a process mesh and checks its own results; a process that
fails fails the worker.  Scenarios:

- ``stencil2`` / ``stencil4`` — heat so4 64² over 2 (1×2) or 4 (2×2)
  processes: k=1 zero and periodic, ``overlap=True``, ``exchange_every=4``,
  fused k=4 (K2's plain route), ``time_loop`` over 8 steps; with 4 also a
  3-D 2×2×1 case and ``comm.allreduce``; each bitwise against the single
  controller's mesh of the same shape.  ``stencil4`` also holds the 2×2
  k=4 run against the reference's distributed run on 8 virtual XLA
  devices (the launcher runs the reference before it spawns) within
  rtol=atol=1e-5, and runs a measured tuner search over the 4 processes;
  ``stencil2`` checks ``Target.auto()`` and one trace file per process;
- ``snapshot`` — a ``ResilientLoop`` of 4 processes killed after its
  third epoch; its snapshot resumes on 2 processes, on the single
  controller and in the reference (JAX on the CPU), each from a copy of
  it: the port's bitwise its uninterrupted single-controller run, the
  reference bitwise its own run of the remaining steps from the saved
  state and within 1e-5 of the port's;
- ``lm`` — reduced yi-9b's seq-sharded decode (one KV head, so that the
  layout is ``"seq"``) and reduced granite-moe-1b-a400m's expert
  parallelism (prefill and decode) over a (data=2, model=2) process mesh,
  bitwise the stacked single-controller run in the forward pass (counting
  the same collective bytes), and ``build_step``'s prefill and decode on
  ``make_process_mesh()``; granite's mesh loss and gradients within 1e-6
  (of each leaf's max) of the stacked run and within 1e-4 of the
  reference's (2, 2) mesh of virtual XLA devices.

- ``gpu`` (the tests marked ``gpu``; two cards or more) — one process per
  card over NCCL, a 2×2 mesh on four cards (1×n otherwise): heat so4
  1024² k=1 (zero, periodic, overlap) and fused k=4 under ``jit=True,
  donate=True`` bitwise ``jit=False`` and the single controller's
  ``jit=False`` run over the same cards; each captured graph holds one K1
  (K2) node per apply (epoch) of its rank and NCCL nodes for its
  exchanges.

Prints ``ALL OK`` and exits 0 when every case holds.
"""
import dataclasses
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPE, SO, STEPS = (64, 64), 4, 8
LM_MESH = (2, 2)


# --------------------------------------------------------------------------
# in every process
# --------------------------------------------------------------------------


def _cpu_mesh(shape, names):
    from repro_torch.dist import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object).reshape(shape), names)


def _strategy(shape):
    from repro_torch.core.passes.decompose import (
        make_strategy_1d, make_strategy_2d, make_strategy_3d,
    )

    if len(shape) == 1:
        return make_strategy_1d(shape[0])
    return (make_strategy_2d if len(shape) == 2 else make_strategy_3d)(tuple(shape))


def _same(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: differs, max |diff| {float((got - want).abs().max())}")


def _stencil_cases(n):
    import _torch_programs as P

    mesh2 = (1, 2) if n == 2 else (2, 2)
    cases = [  # (name, program, mesh shape, target kwargs, steps)
        ("heat k=1 zero", P.heat("repro_torch", SHAPE, SO, "zero"), mesh2, {}, STEPS),
        ("heat k=1 periodic", P.heat("repro_torch", SHAPE, SO, "periodic"), mesh2, {}, STEPS),
        ("heat overlap zero", P.heat("repro_torch", SHAPE, SO, "zero"), mesh2,
         {"overlap": True}, STEPS),
        ("heat overlap periodic", P.heat("repro_torch", SHAPE, SO, "periodic"), mesh2,
         {"overlap": True}, STEPS),
        ("heat exchange_every=4", P.heat("repro_torch", SHAPE, SO, "zero"), mesh2,
         {"exchange_every": 4}, STEPS),
        ("heat fused k=4 zero", P.heat("repro_torch", SHAPE, SO, "zero"), mesh2,
         {"exchange_every": 4, "fused_epoch": True, "backend": "cuda"}, STEPS),
        ("heat fused k=4 periodic", P.heat("repro_torch", SHAPE, SO, "periodic"), mesh2,
         {"exchange_every": 4, "fused_epoch": True, "backend": "cuda"}, STEPS),
        ("wave k=1", P.wave("repro_torch", SHAPE, SO, "zero"), mesh2, {}, STEPS),
    ]
    if n == 4:
        cases.append(("heat 3-D 2x2x1", P.heat("repro_torch", (16, 16, 12), SO, "periodic"),
                      (2, 2, 1), {}, 4))
    return cases


def _check_stencil(n, rank, directory):
    import _torch_programs as P
    from repro_torch import api
    from repro_torch.dist import processes

    for name, prog, mshape, kw, steps in _stencil_cases(n):
        names = ("x", "y", "z")[: len(mshape)]
        state = [torch.from_numpy(a) for a in P.rand_state(prog, 5)]
        pmesh = processes.process_mesh(mshape, names)
        step = api.compile(prog, api.Target(mesh=pmesh, strategy=_strategy(mshape), **kw))
        got = step.time_loop(state, steps)
        one = api.compile(prog, api.Target(mesh=_cpu_mesh(mshape, names),
                                           strategy=_strategy(mshape), **kw))
        want = one.time_loop(state, steps)
        for g, w in zip(got, want):
            _same(g, w, f"{name} on {mshape} processes vs the single controller")
        # advance keeps this process's block only; gather gives the whole
        sharded = step.advance(step.shard_state(state))
        for x, w in zip(sharded, one.advance(one.shard_state(state))):
            assert len(x.shards) == 1 and x.mesh.process_rank == rank
            _same(api.gather(x), api.gather(w), f"{name}: one advance")
        if name == "heat fused k=4 zero" and n == 4:
            ref = np.load(os.path.join(directory, "reference_k4.npy"))
            torch.testing.assert_close(got[0], torch.from_numpy(ref), rtol=1e-5, atol=1e-5)
        print(f"rank {rank}: ok: {name} on {mshape} processes, bitwise", flush=True)
    if n == 4:
        _check_allreduce(rank)
        _check_tune(rank, directory)
    else:
        _check_auto_and_trace(n, rank, directory)


def _check_auto_and_trace(n, rank, directory):
    """``Target.auto()`` inside the world is 1-D over its processes with
    ``jit=True``; a traced epoch's spans carry this process's rank, each
    process writes its own trace, and the merged timeline has one track
    per process with its exchange windows."""
    import json

    import _torch_programs as P
    from repro_torch import api, obs
    from repro_torch.dist import processes

    auto = api.Target.auto()
    assert auto.mesh.processes and auto.jit and auto.mesh.shape == {"x": n}, auto
    prog = P.heat("repro_torch", SHAPE, SO, "zero")
    step = api.compile(prog, auto)
    state = step.shard_state([torch.from_numpy(a) for a in P.rand_state(prog, 5)])
    obs.clear()
    obs.enable()
    try:
        step.advance(state, epoch=0, step_begin=0)
    finally:
        obs.disable()
    spans = obs.spans()
    assert {s.rank for s in spans if s.rank is not None} == {rank}, spans
    assert any(s.name == "comm.exchange" for s in spans)
    traces = os.path.join(directory, "traces")
    obs.write_process_trace(traces)
    processes.barrier()
    if rank == 0:
        merged = obs.merge_traces(traces)
        pids = {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "X"}
        assert pids == set(range(n)), pids
        json.dumps(merged)
    print(f"rank {rank}: ok: Target.auto() over {n} processes; one trace track per process",
          flush=True)


def _check_tune(rank, directory):
    """A measured search over the world's 4 processes: every process runs
    the same candidates (process meshes, ``jit=True``) and gets the same
    winner, which runs bitwise as the single controller's target of that
    configuration; the same search again is a cache hit."""
    import torch.distributed as dist

    import _torch_programs as P
    from repro_torch import api
    from repro_torch.tune import tune

    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(directory, "tune")
    prog = P.heat("repro_torch", SHAPE, SO, "zero")
    kw = dict(backends=("torch",), exchange_every=(1, 2), overlap=(False,), fused_epoch=(False,),
              steps=2, trials=1, warmup=1)
    res = tune(prog, **kw)
    assert all(c.target.mesh is None or (c.target.mesh.processes and c.target.jit)
               for c in res.candidates), [c.describe() for c in res.candidates]
    winners = [None] * 4
    dist.all_gather_object(winners, res.target.fingerprint)
    assert len(set(winners)) == 1, winners
    state = [torch.from_numpy(a) for a in P.rand_state(prog, 5)]
    got = api.compile(prog, res.target).time_loop(state, 4)
    w = res.target
    single = dataclasses.replace(
        w, mesh=None if w.mesh is None else _cpu_mesh(tuple(w.mesh.shape.values()), w.mesh.axis_names))
    for g, s in zip(got, api.compile(prog, single).time_loop(state, 4)):
        _same(g, s, "the tuned winner over processes")
    again = tune(prog, **kw)
    assert again.from_cache and again.target.fingerprint == res.target.fingerprint
    print(f"rank {rank}: ok: tune over 4 processes, winner {res.winner.describe()}, "
          "bitwise the single controller; a cache hit the second time", flush=True)


def _check_allreduce(rank):
    """``comm.allreduce`` over both axes and over ``x`` on 2×2 processes:
    what the single controller's four ranks get, bitwise."""
    from repro_torch.core import ir
    from repro_torch.core.dialects import comm, stencil
    from repro_torch.core.lowering import StencilInterpreter
    from repro_torch.dist import processes

    mesh = processes.process_mesh((2, 2), ("x", "y"))
    cmesh = _cpu_mesh((2, 2), ("x", "y"))
    vals = [torch.from_numpy(np.random.default_rng(r).standard_normal((2, 3)).astype(np.float32))
            for r in range(4)]
    for axes in (("x", "y"), ("x",)):
        core = stencil.Bounds((0, 0), (2, 3))
        func = ir.FuncOp("reduce", [stencil.FieldType(core), stencil.FieldType(core)])
        src, dst = func.body.args
        load = func.body.add_op(stencil.LoadOp(src))
        red = func.body.add_op(comm.AllReduceOp(load.results[0], axes, "sum"))
        func.body.add_op(stencil.StoreOp(red.results[0], dst, core))
        func.body.add_op(ir.ReturnOp([]))
        sizes = {"x": 2, "y": 2}
        want = StencilInterpreter(func, sizes, distributed=True).run_ranks(
            [(v, torch.zeros(2, 3)) for v in vals], [cmesh.coords(r) for r in range(4)])
        (got,) = StencilInterpreter(func, sizes, distributed=True, mesh=mesh).run_ranks(
            [(vals[rank], torch.zeros(2, 3))], [mesh.coords(rank)])
        _same(got[0], want[rank][0], f"allreduce over {axes}")
    print(f"rank {rank}: ok: comm.allreduce over (x, y) and x, bitwise", flush=True)


def _snapshot_program():
    import _torch_programs as P

    return P.heat("repro_torch", SHAPE, SO, "zero"), {"exchange_every": 2}


def _snapshot_write(n, rank, directory):
    import _torch_programs as P
    from repro_torch import api
    from repro_torch.dist import processes
    from repro_torch.resilience import FaultPlan, ResilientLoop, SimulatedFault

    prog, kw = _snapshot_program()
    state = [torch.from_numpy(a) for a in P.rand_state(prog, 9)]
    target = api.Target(mesh=processes.process_mesh((2, 2), ("x", "y")),
                        strategy=_strategy((2, 2)), **kw)
    loop = ResilientLoop(prog, target, state, 16, directory=os.path.join(directory, "ckpt"),
                         checkpoint_every=1, fault_plan=FaultPlan(kill_at_epoch=3))
    try:
        loop.run()
        raise AssertionError("the run was not killed")
    except SimulatedFault:
        pass
    print(f"rank {rank}: ok: killed at epoch 3 after its snapshot at step 6", flush=True)
    # a sharded leaf reaches the host on process 0 alone
    from repro_torch.checkpoint.checkpointer import _to_host
    from repro_torch.dist import P, reshard

    (x,) = reshard([state[0]], target.mesh, [P("x", "y")])
    host = _to_host(x, writer=rank == 0)
    if rank == 0:
        _same(torch.from_numpy(host), state[0], "a leaf gathered to process 0")
    else:
        assert host is None, "a process other than 0 copied a leaf to the host"


def _snapshot_resume(n, rank, directory):
    import _torch_programs as P
    from repro_torch import api
    from repro_torch.dist import processes
    from repro_torch.resilience import resume

    prog, kw = _snapshot_program()
    state = [torch.from_numpy(a) for a in P.rand_state(prog, 9)]
    want = api.compile(prog, api.Target(device="cpu", **kw)).time_loop(state, 16)
    target = api.Target(mesh=processes.process_mesh((1, 2), ("x", "y")),
                        strategy=_strategy((1, 2)), **kw)
    loop = resume(prog, os.path.join(directory, "ckpt-2"), target)
    assert loop.step_count == 6, loop.step_count
    got = [api.gather(x) for x in loop.run()]
    for g, w in zip(got, want):
        _same(g, w, "4 processes' snapshot resumed on 2 processes")
    print(f"rank {rank}: ok: the 4-process snapshot resumed on 2 processes, bitwise", flush=True)


def _lm_params(directory):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced_config
    from repro_torch.interop import params_from_numpy

    out = {}
    for arch in ("yi-9b", "granite-moe-1b-a400m"):
        with np.load(os.path.join(directory, f"{arch}.npz")) as z:
            leaves = {k.replace("__", "/"): z[k] for k in z.files}
        cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
        out[arch] = (cfg, params_from_numpy(cfg, _unflatten(leaves), device="cpu"))
    return out


def _unflatten(leaves):
    tree: dict = {}
    for key, a in leaves.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def _check_lm(n, rank, directory):
    from repro_torch.dist import processes, use_mesh
    from repro_torch.dist.sharding import counting_collectives
    from repro_torch.models import attention, lm, moe
    from repro_torch.train import train_step as ts

    pmesh = processes.process_mesh(LM_MESH, ("data", "model"))
    cmesh = _cpu_mesh(LM_MESH, ("data", "model"))
    models = _lm_params(directory)
    f32 = torch.float32

    # yi-style decode against a seq-sharded cache: one KV head, so that
    # the model axis cannot split the heads ("seq" layout)
    cfg = dataclasses.replace(models["yi-9b"][0], n_kv_heads=1, dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(3)
    B, T = 4, 64
    cache = lm.tree_map(lambda t: t.normal_(generator=g),
                        lm.init_cache(cfg, B, T, dtype=f32, device="cpu"))
    token = torch.randint(0, cfg.vocab_size, (B,), generator=g)
    outs = {}
    for label, mesh in (("processes", pmesh), ("stacked", cmesh)):
        assert attention.kv_cache_layout(B, T, cfg.n_kv_heads, mesh) == "seq"
        with use_mesh(mesh):
            outs[label] = lm.decode_step(params, cfg, token, 37, lm.tree_map(torch.clone, cache))
    (logits, c1), (wlogits, wc1) = outs["processes"], outs["stacked"]
    _same(logits, wlogits, "yi decode logits")
    for k, v in lm.leaves(c1).items():
        _same(v, lm.leaves(wc1)[k], f"yi decode cache {k}")
    print(f"rank {rank}: ok: yi-style seq-sharded flash-decode, bitwise the stacked run",
          flush=True)

    # granite expert parallelism: ep_block (prefill) and ep_block_small (decode)
    cfg, params = models["granite-moe-1b-a400m"]
    p = lm.tree_map(lambda a: a[0], params["cells"]["slot0"]["moe"])
    for shape in ((4, 16, cfg.d_model), (2, 1, cfg.d_model)):
        x = torch.randn(*shape, generator=g)
        outs, counted = {}, {}
        for label, mesh in (("processes", pmesh), ("stacked", cmesh)):
            with use_mesh(mesh), counting_collectives() as counted[label]:
                outs[label] = moe.moe_apply(p, x, cfg, f32)
        # one rank's operand bytes, as the stacked ranks count them
        assert counted["processes"] == counted["stacked"] != {}, counted
        (y, aux), (wy, waux) = outs["processes"], outs["stacked"]
        _same(y, wy, f"granite EP {shape}")
        for k in aux:
            _same(aux[k], waux[k], f"granite EP {shape} {k}")
    print(f"rank {rank}: ok: granite expert parallelism (prefill and decode), bitwise", flush=True)

    # build_step's prefill and decode on the production axes over the world
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import build_step

    wmesh = make_process_mesh()
    assert wmesh.shape == {"data": 1, "model": n}, wmesh.shape
    outs = {}
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g, dtype=torch.int32)
    for label, mesh in (("processes", wmesh), ("stacked", _cpu_mesh((1, n), ("data", "model")))):
        prefill, *_ = build_step(cfg, ShapeConfig("prefill", 16, 2, "prefill"), mesh)
        logits, cache = prefill(params, {"tokens": tokens})
        decode, *_ = build_step(cfg, ShapeConfig("decode", 16, 2, "decode"), mesh)
        token = torch.randint(0, cfg.vocab_size, (2,), generator=torch.Generator().manual_seed(8),
                              dtype=torch.int32)
        step_logits, _ = decode(params, {"token": token, "pos": torch.tensor(15, dtype=torch.int32),
                                         "cache": lm.tree_map(torch.clone, cache)})
        outs[label] = (logits, step_logits)
    for got, want in zip(outs["processes"], outs["stacked"]):
        _same(got, want, "granite build_step prefill/decode on the world's production axes")
    print(f"rank {rank}: ok: build_step prefill and decode on make_process_mesh(), bitwise",
          flush=True)

    # the mesh loss and gradients (a train step's backward through EP)
    tokens = torch.from_numpy(np.load(os.path.join(directory, "tokens.npy"))).long()
    results = {}
    for label, mesh in (("processes", pmesh), ("stacked", cmesh)):
        def loss(params, batch, mesh=mesh):
            with use_mesh(mesh):
                return ts.make_loss_fn(cfg, ts.TrainOptions(q_chunk=8))(params, batch)

        results[label] = ts.value_and_grad(loss)(params, {"tokens": tokens})
    ((l, metrics), grads), ((wl, wmetrics), wgrads) = results["processes"], results["stacked"]
    _same(l, wl, "granite mesh loss")
    ref = np.load(os.path.join(directory, "reference_grads.npz"))
    torch.testing.assert_close(l, torch.tensor(float(ref["loss"])), rtol=1e-5, atol=1e-5)
    want = lm.leaves(wgrads)
    for k, gr in lm.leaves(grads).items():
        scale = max(float(want[k].abs().max()), 1e-30)
        torch.testing.assert_close(gr / scale, want[k] / scale, rtol=1e-6, atol=1e-6,
                                   msg=lambda m, k=k: f"grad {k} vs the stacked run: {m}")
        r = torch.from_numpy(ref[k.replace("/", "__")])
        rscale = max(float(r.abs().max()), 1e-30)
        torch.testing.assert_close(gr / rscale, r / rscale, rtol=1e-4, atol=1e-4,
                                   msg=lambda m, k=k: f"grad {k} vs the reference: {m}")
    print(f"rank {rank}: ok: granite mesh loss bitwise, gradients within 1e-6 of the stacked "
          "run and 1e-4 of the reference", flush=True)


GPU_SHAPE = (1024, 1024)


def _gpu_mesh(n):
    return (2, 2) if n == 4 else (1, n)


def _gpu_cases():
    import _torch_programs as P

    fused = {"exchange_every": 4, "fused_epoch": True}
    return [
        ("heat k=1 zero", P.heat("repro_torch", GPU_SHAPE, SO, "zero"), {}),
        ("heat k=1 periodic", P.heat("repro_torch", GPU_SHAPE, SO, "periodic"), {}),
        ("heat k=1 overlap", P.heat("repro_torch", GPU_SHAPE, SO, "zero"), {"overlap": True}),
        ("heat k=4 fused", P.heat("repro_torch", GPU_SHAPE, SO, "zero"), fused),
    ]


def _check_gpu(n, rank, directory):
    import _torch_programs as P
    from repro_torch import api
    from repro_torch.dist import Mesh, processes

    shape = _gpu_mesh(n)
    names = ("x", "y")
    pmesh = processes.process_mesh(shape, names)
    cards = Mesh(np.array([torch.device("cuda", r) for r in range(n)], dtype=object).reshape(shape),
                 names)
    for name, prog, kw in _gpu_cases():
        g = torch.Generator(device="cuda").manual_seed(5)
        state = [torch.randn(f.type.bounds.shape, generator=g, device="cuda")
                 for f in prog.field_args if f not in set(prog.output_fields)]
        kw = {"backend": "cuda", **kw}
        eager = api.compile(prog, api.Target(mesh=pmesh, strategy=_strategy(shape), jit=False, **kw))
        graphed = api.compile(prog, api.Target(mesh=pmesh, strategy=_strategy(shape), jit=True,
                                               donate=True, **kw))
        want = eager.time_loop(state, STEPS)
        got = graphed.time_loop(state, STEPS)
        for a, b in zip(got, want):
            _same(a, b, f"{name}: jit=True vs jit=False over card processes")
        if rank == 0:
            single = api.compile(prog, api.Target(mesh=cards, strategy=_strategy(shape),
                                                  jit=False, **kw))
            for a, b in zip(got, single.time_loop(state, STEPS)):
                _same(a, b.to(a.device), f"{name}: card processes vs the single controller")
        applies, epochs = len(graphed.kernel_applies()), len(graphed.kernel_epochs())
        for _, nodes, _ in graphed._ring.graphs.values():
            assert (nodes.k1, nodes.k2) == (applies, epochs), (name, nodes.k1, nodes.k2)
            assert nodes.nccl > 0, (name, nodes.kernels)
        print(f"rank {rank}: ok: {name} on {shape} card processes: captured == uncaptured == "
              f"the single controller, bitwise; graphs hold K1 {applies}, K2 {epochs} and "
              f"{[nodes.nccl for _, nodes, _ in graphed._ring.graphs.values()]} NCCL nodes",
              flush=True)


def _build_gpu_sources(n):
    """Every K1/K2 source of the ``gpu`` cases, built before the processes
    start (one nvcc each, in parallel), so that they do not build them
    four times over."""
    from repro_torch import api
    from repro_torch.dist import Mesh
    from repro_torch.kernels import stencil_apply

    shape = _gpu_mesh(n)
    cpu = Mesh(np.array([torch.device("cpu")] * n, dtype=object).reshape(shape), ("x", "y"))
    sources = []
    for _, prog, kw in _gpu_cases():
        sources += api.compile(prog, api.Target(mesh=cpu, strategy=_strategy(shape),
                                                backend="cuda", **kw)).kernel_sources()
    stencil_apply.build(list(dict.fromkeys(sources)))


def child(rank, n, scenario, directory, store):
    import faulthandler

    faulthandler.dump_traceback_later(150)  # a hung collective shows where it hangs
    torch.set_num_threads(1)
    from repro_torch.dist import processes

    processes.init(device="cuda" if scenario == "gpu" else "cpu", rank=rank, world_size=n,
                   local_rank=rank, timeout_s=120,
                   init_method=f"file://{os.path.abspath(os.path.join(directory, store))}")
    try:
        {"stencil": _check_stencil, "write": _snapshot_write, "resume": _snapshot_resume,
         "lm": _check_lm, "gpu": _check_gpu}[scenario](n, rank, directory)
        processes.barrier()
    except BaseException:
        # the failure, and an exit that waits on no peer (leaving the world
        # would wait on them all)
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    faulthandler.cancel_dump_traceback_later()
    processes.shutdown()


def spawn(n, scenario, directory):
    import torch.multiprocessing as mp

    store = f"store-{scenario}-{n}"
    mp.start_processes(child, args=(n, scenario, directory, store), nprocs=n, join=True,
                       start_method="spawn")


# --------------------------------------------------------------------------
# the launcher (it alone imports JAX, after setting its device count)
# --------------------------------------------------------------------------


def _jax():
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
    )
    import jax

    return jax


def reference_k4(directory):
    jax = _jax()
    import _torch_programs as P
    from repro import api as rapi
    from repro.core.passes.decompose import make_strategy_2d as rstrategy

    prog = P.heat("repro", SHAPE, SO, "zero")
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    out = rapi.compile(prog, rapi.Target(
        mesh=jmesh, strategy=rstrategy((2, 2)), backend="pallas", exchange_every=4,
        fused_epoch=True, pallas_interpret=True,
    )).time_loop(P.rand_state(prog, 5), STEPS)
    np.save(os.path.join(directory, "reference_k4.npy"), np.asarray(out[0]))


def snapshot_elsewhere(directory):
    """The 4-process snapshot resumed on the single controller (one
    device and 2×2 CPU ranks) and in the reference."""
    _jax()
    import _torch_programs as P
    from repro import api as rapi
    from repro.resilience import resume as rresume
    from repro_torch import api
    from repro_torch.resilience import resume

    prog, kw = _snapshot_program()
    state = P.rand_state(prog, 9)
    want = api.compile(prog, api.Target(device="cpu", **kw)).time_loop(
        [torch.from_numpy(a) for a in state], 16)
    for label, target in (("one device", api.Target(device="cpu", **kw)),
                          ("2x2 CPU ranks", api.Target(mesh=_cpu_mesh((2, 2), ("x", "y")),
                                                       strategy=_strategy((2, 2)), **kw))):
        with tempfile.TemporaryDirectory() as d:
            import shutil

            shutil.copytree(os.path.join(directory, "ckpt"), d, dirs_exist_ok=True)
            loop = resume(prog, d, target)
            assert loop.step_count == 6, loop.step_count
            got = [api.gather(x) for x in loop.run()]
        for g, w in zip(got, want):
            _same(g, w, f"the 4-process snapshot resumed on the single controller ({label})")
        print(f"ok: the 4-process snapshot resumed on the single controller ({label}), bitwise")
    rprog = P.heat("repro", SHAPE, SO, "zero")
    with tempfile.TemporaryDirectory() as d:
        import shutil

        shutil.copytree(os.path.join(directory, "ckpt"), d, dirs_exist_ok=True)
        loop = rresume(rprog, d, rapi.Target(**kw))
        assert loop.step_count == 6, loop.step_count
        saved = [np.load(os.path.join(d, "step_00000006", f"state__b{i}.npy"))
                 for i in range(len(state))]
        rgot = loop.run()
    # the reference continues from exactly the state the processes saved
    rwant = rapi.compile(rprog, rapi.Target(**kw)).time_loop(saved, 10)
    for g, rw, w in zip(rgot, rwant, want):
        assert np.array_equal(np.asarray(g), np.asarray(rw)), "the reference's resume differs"
        torch.testing.assert_close(torch.from_numpy(np.array(g)), w, rtol=1e-5, atol=1e-5)
    print("ok: the 4-process snapshot resumed in the reference: bitwise the reference's "
          "10 steps from the saved state, within 1e-5 of the port's uninterrupted run")


def lm_inputs(directory):
    """Reduced yi-9b and granite params (the reference's, as numpy), a
    token batch, and the reference's mesh loss and gradients of granite
    on a (2, 2) mesh of virtual XLA devices."""
    jax = _jax()
    from _torch_lm import Pair, to_numpy
    from repro.dist.sharding import use_mesh as ruse_mesh
    from repro.train import train_step as rts
    from repro_torch.models import lm

    for arch in ("yi-9b", "granite-moe-1b-a400m"):
        pair = Pair(arch)
        leaves = lm.leaves(to_numpy(pair.rparams))
        np.savez(os.path.join(directory, f"{arch}.npz"),
                 **{k.replace("/", "__"): np.asarray(v, np.float32) for k, v in leaves.items()})
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(LM_MESH), ("data", "model"))
    (rt, _), _ = pair.inputs()
    np.save(os.path.join(directory, "tokens.npy"), np.asarray(rt))

    def rloss(params, batch):
        with ruse_mesh(jmesh):
            return rts.make_loss_fn(pair.rcfg, rts.TrainOptions(q_chunk=8))(params, batch)

    (rl, _), rgrads = jax.jit(jax.value_and_grad(rloss, has_aux=True))(pair.rparams, {"tokens": rt})
    grads = lm.leaves(to_numpy(rgrads))
    np.savez(os.path.join(directory, "reference_grads.npz"), loss=np.asarray(rl, np.float32),
             **{k.replace("/", "__"): np.asarray(v, np.float32) for k, v in grads.items()})


def main(argv):
    scenario, directory = argv[1], argv[2]
    if scenario in ("stencil2", "stencil4"):
        n = int(scenario[-1])
        if n == 4:
            reference_k4(directory)
        spawn(n, "stencil", directory)
    elif scenario == "snapshot":
        import shutil

        spawn(4, "write", directory)
        shutil.copytree(os.path.join(directory, "ckpt"), os.path.join(directory, "ckpt-2"))
        spawn(2, "resume", directory)
        snapshot_elsewhere(directory)
    elif scenario == "lm":
        lm_inputs(directory)
        spawn(4, "lm", directory)
    elif scenario == "gpu":
        n = torch.cuda.device_count()
        if n < 2:
            raise SystemExit(f"the gpu scenario needs two cards or more, this machine has {n}")
        _build_gpu_sources(min(n, 4))
        spawn(min(n, 4), "gpu", directory)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print("ALL OK")


if __name__ == "__main__":
    main(sys.argv)
