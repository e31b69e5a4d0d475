"""Tensor and data parallelism of the language models over one process a
rank (gloo on the CPU), each case held against the single controller's
stacked ranks: a subprocess worker (``tests/test_torch_tp_processes.py``).

    python tests/torch_tp_worker.py SCENARIO DIRECTORY

The worker spawns its processes (``torch.multiprocessing``, spawn, a file
store under ``DIRECTORY``); every process joins the world with
``repro_torch.dist.processes.init(device="cpu")``.  Scenarios:

- ``train`` — reduced qwen2-7b and granite-moe-1b-a400m (float32) on a
  (data=2, model=2) and a (1, 4) process mesh: one ``ShardedTrainStep``'s
  loss, metrics, every gradient block and every block of the updated state
  bitwise the stacked single controller's (each process checks its own
  blocks);
- ``trainer`` — a ``Trainer(state_shardings=...)`` of reduced qwen2-7b on
  (1, 4) processes that stops after its step-2 snapshot, resumed on (2, 2)
  processes and on one device (the flat trainer): each restored state
  bitwise the snapshot's files, the third step's loss within 1e-5 of an
  uninterrupted (1, 4) run's; and a checkpoint written by the reference's
  ``Checkpointer`` (the launcher writes it with JAX before it spawns)
  resumed onto a (2, 2) process mesh, bitwise;
- ``moe`` — reduced granite-moe-1b-a400m and jamba (float32, capacity
  factor 0.5: tokens drop) on a (data=2, model=1) world of two processes
  and a (1, 3) world of three: MoE on the reference's single-rank route
  (no model axis of more than one rank holds the experts), one
  ``ShardedTrainStep``'s loss, metrics and every gradient block, the
  ``ShardedPrefill`` logits and cache blocks and two ``ShardedDecode``
  steps' logits bitwise the stacked single controller's;
- ``gspmd-moe`` (no processes) — :func:`gspmd` for reduced
  granite-moe-1b-a400m at capacity factor 0.5 on (data=2, model=1),
  where the reference takes its single-rank route under GSPMD;
- ``gspmd`` (no processes; 8 virtual XLA devices) — two of the port's
  stacked (data=2, model=4) train steps, each against the reference's
  ``build_step("train")`` jitted with its own in/out shardings from the
  same state, for reduced qwen2-7b and granite-moe-1b-a400m: the loss
  within 1e-5 and every metric within 1e-5 of its magnitude, the
  gradients, the moments and the parameters within 1e-4 of each leaf's
  largest magnitude, and the new state within 1e-6 of the reference's
  ``adamw_update`` of the port's own gradients (see :func:`gspmd`).

Prints ``ALL OK`` and exits 0 when every case holds.
"""
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

B, S = 4, 16


def _cfg(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced_config

    return dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")


def _stacked_mesh(shape):
    from repro_torch.dist import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object).reshape(shape),
                ("data", "model"))


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def own_block(x, mesh, spec, rank):
    from repro_torch.dist.sharding import rank_block

    return rank_block(x, mesh, spec, rank)


def _leaves_with_specs(tree, specs, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_specs(v, specs[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree, specs


def _same(got, want, what):
    if not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max()) if got.shape == want.shape else None
        raise AssertionError(f"{what}: not bitwise the stacked ranks (max diff {err}, "
                             f"shapes {tuple(got.shape)} / {tuple(want.shape)})")


# --------------------------------------------------------------------------
# in every process
# --------------------------------------------------------------------------


def _check_train(n, rank, directory):
    from repro_torch.dist import processes
    from repro_torch.dist.sharding import place_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import ShardedTrainStep, TrainOptions, init_train_state

    for arch in ("qwen2-7b", "granite-moe-1b-a400m"):
        cfg = _cfg(arch)
        state = init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
        batch = {"tokens": _tokens(cfg)}
        for shape in ((2, 2), (1, 4)):
            what = f"{arch} {shape}"
            smesh, pmesh = _stacked_mesh(shape), processes.process_mesh(shape, ("data", "model"))
            opts = TrainOptions(remat=True, q_chunk=8)
            ss = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, smesh, B)
            ps = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, pmesh, B)
            s_state = place_tree(state, ss.state_specs, smesh)
            p_state = place_tree(state, ps.state_specs, pmesh)
            (sl, sm), sg = ss.value_and_grad(s_state["params"], ss.place_batch(batch))
            (pl, pm), pg = ps.value_and_grad(p_state["params"], ps.place_batch(batch))
            _same(pl, sl, f"{what} loss")
            for k in sm:
                _same(pm[k], sm[k], f"{what} {k}")
            pspecs = ss.state_specs["params"]
            for (path, g, spec), (_, h, _) in zip(_leaves_with_specs(sg, pspecs),
                                                  _leaves_with_specs(pg, pspecs)):
                _same(h, own_block(g, smesh, spec, rank), f"{what} grad {path}")
            s_new, s_met = ss(s_state, ss.place_batch(batch))
            p_new, p_met = ps(p_state, ps.place_batch(batch))
            _same(p_met["grad_norm"], s_met["grad_norm"], f"{what} grad_norm")
            for (path, x, spec), (_, y, _) in zip(_leaves_with_specs(s_new, ss.state_specs),
                                                  _leaves_with_specs(p_new, ss.state_specs)):
                _same(y, own_block(x, smesh, spec, rank), f"{what} new state {path}")
            if rank == 0:
                print(f"ok: {what}: loss {float(pl):.6f}, gradients and new state bitwise",
                      flush=True)


def _with_capacity(cfg, capacity):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))


def _check_moe(n, rank, directory):
    """MoE on the single-rank route over ``n`` processes ((2, 1) or (1, 3)):
    the train step, prefill and decode bitwise the stacked ranks."""
    from repro_torch.dist import processes
    from repro_torch.dist.sharding import place, place_tree
    from repro_torch.launch.steps import ShardedDecode, ShardedPrefill
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import ShardedTrainStep, TrainOptions

    shape = {2: (2, 1), 3: (1, 3)}[n]
    smesh, pmesh = _stacked_mesh(shape), processes.process_mesh(shape, ("data", "model"))
    for arch in ("granite-moe-1b-a400m", "jamba-v0.1-52b"):
        what = f"{arch} {shape}"
        cfg = _with_capacity(_cfg(arch), 0.5)
        params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        tokens = torch.from_numpy(_tokens(cfg)).long()
        opts = TrainOptions(remat=True, q_chunk=8)
        ss = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, smesh, B)
        ps = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, pmesh, B)
        pspecs = ss.state_specs["params"]
        (sl, sm), sg = ss.value_and_grad(place_tree(params, pspecs, smesh),
                                         ss.place_batch({"tokens": tokens}))
        (pl, pm), pg = ps.value_and_grad(place_tree(params, pspecs, pmesh),
                                         ps.place_batch({"tokens": tokens}))
        _same(pl, sl, f"{what} loss")
        for k in sm:
            _same(pm[k], sm[k], f"{what} {k}")
        for (path, g, spec), (_, h, _) in zip(_leaves_with_specs(sg, pspecs),
                                              _leaves_with_specs(pg, pspecs)):
            _same(h, own_block(g, smesh, spec, rank), f"{what} grad {path}")
        _, f_cache = lm.forward_prefill(params, cfg, tokens, q_chunk=8)
        f_cache = lm.grow_cache(cfg, f_cache, S + 2, S)
        outs = []
        for mesh in (smesh, pmesh):
            pre = ShardedPrefill(cfg, mesh, B, S, q_chunk=8)
            placed = place_tree(params, pre.param_specs, mesh)
            logits, cache = pre(placed, {"tokens": place(tokens, mesh, pre.batch_specs["tokens"])})
            dec = ShardedDecode(cfg, mesh, B, S + 2)
            grown = place_tree(f_cache, dec.cache_specs, mesh)
            steps = [logits]
            rng = np.random.default_rng(3)
            for pos in (S, S + 1):
                tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B,)))
                steps.append(dec(placed, place(tok, mesh, dec.token_spec), pos, grown))
            outs.append((steps, cache, pre, dec))
        (s_steps, s_cache, pre, dec), (p_steps, p_cache, _, _) = outs
        names = ("prefill logits", "decode step 1 logits", "decode step 2 logits")
        specs = (pre.logits_spec, dec.logits_spec, dec.logits_spec)
        for x, y, spec, name in zip(s_steps, p_steps, specs, names):
            _same(y, own_block(x, smesh, spec, rank), f"{what} {name}")
        for (path, x, spec), (_, y, _) in zip(_leaves_with_specs(s_cache, pre.cache_specs),
                                              _leaves_with_specs(p_cache, pre.cache_specs)):
            _same(y, own_block(x, smesh, spec, rank), f"{what} prefill cache {path}")
        if rank == 0:
            print(f"ok: {what} processes: loss {float(pl):.6f}, gradients, prefill and decode "
                  "bitwise the stacked ranks", flush=True)


def _trainer(mesh, directory, total, ckpt="ckpt"):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (
        ShardedTrainStep, TrainOptions, init_placed_train_state,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig, shardings_of

    cfg = _cfg("qwen2-7b")
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), TrainOptions(q_chunk=8), mesh, B)
    data = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size, seed=3)
    tcfg = TrainerConfig(total_steps=total, checkpoint_every=2, log_every=1,
                         checkpoint_dir=os.path.join(directory, ckpt))
    return Trainer(step, lambda: init_placed_train_state(
        torch.Generator().manual_seed(1), cfg, mesh, step.state_specs, device="cpu"),
        data, tcfg, state_shardings=shardings_of(step.state_specs, mesh)), step


def _restored_is_the_snapshot(trainer, step, directory, ckpt, what):
    from repro_torch.dist.sharding import gather_tree

    full = gather_tree(trainer.state, step.state_specs, step.mesh)
    snap = os.path.join(directory, ckpt, f"step_{trainer.start_step:08d}")

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}__")
            else:
                want = torch.from_numpy(np.load(os.path.join(snap, f"{prefix}{k}.npy")))
                _same(v, want, f"{what}: restored {prefix}{k}")

    walk(full, "")


def _write_run(n, rank, directory):
    """(1, 4): three steps, a snapshot at step 2 (and the run goes on to
    step 3: the uninterrupted run)."""
    from repro_torch.dist import processes

    mesh = processes.process_mesh((1, 4), ("data", "model"))
    trainer, _ = _trainer(mesh, directory, total=2)
    trainer.run()
    trainer, _ = _trainer(mesh, directory, total=3, ckpt="ckpt-run")
    out = trainer.run()
    if rank == 0:
        with open(os.path.join(directory, "loss3.txt"), "w") as f:
            f.write(repr(out["metrics"][-1]["loss"]))


def _resume(n, rank, directory):
    from repro_torch.dist import processes

    mesh = processes.process_mesh((2, 2), ("data", "model"))
    trainer, step = _trainer(mesh, directory, total=3)
    assert trainer.start_step == 2, trainer.start_step
    _restored_is_the_snapshot(trainer, step, directory, "ckpt", "(1, 4) → (2, 2) processes")
    out = trainer.run()
    with open(os.path.join(directory, "loss3.txt")) as f:
        want = float(f.read())
    got = out["metrics"][-1]["loss"]
    assert abs(got - want) <= 1e-5, (got, want)
    # the reference's snapshot on a (2, 2) process mesh
    trainer, step = _trainer(mesh, directory, total=3, ckpt="ckpt-ref")
    assert trainer.start_step == 2, trainer.start_step
    _restored_is_the_snapshot(trainer, step, directory, "ckpt-ref", "reference → (2, 2) processes")
    trainer.run()
    if rank == 0:
        print(f"ok: resumed on (2, 2) processes, step 3 loss {got:.6f} vs {want:.6f}; "
              "the reference's snapshot restored bitwise", flush=True)


def child(rank, n, scenario, directory, store):
    import faulthandler

    faulthandler.dump_traceback_later(150)
    torch.set_num_threads(1)
    from repro_torch.dist import processes

    processes.init(device="cpu", rank=rank, world_size=n, local_rank=rank, timeout_s=120,
                   init_method=f"file://{os.path.abspath(os.path.join(directory, store))}")
    try:
        {"train": _check_train, "write": _write_run, "resume": _resume, "moe": _check_moe}[
            scenario](n, rank, directory)
        processes.barrier()
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    faulthandler.cancel_dump_traceback_later()
    processes.shutdown()


def spawn(n, scenario, directory):
    import torch.multiprocessing as mp

    mp.start_processes(child, args=(n, scenario, directory, f"store-{scenario}-{n}"), nprocs=n,
                       join=True, start_method="spawn")


# --------------------------------------------------------------------------
# the launcher (it alone imports JAX, after setting its device count)
# --------------------------------------------------------------------------


def _jax():
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
    )
    import jax

    return jax


def resume_on_one_device(directory):
    """The (1, 4) snapshot resumed by the flat trainer on the CPU: the
    restored state bitwise the files, step 3 within 1e-5 of the (1, 4) run."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainOptions, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = _cfg("qwen2-7b")
    step = make_train_step(cfg, opt.OptimizerConfig(), TrainOptions(q_chunk=8))
    trainer = Trainer(step, None, DataConfig(seq_len=S, global_batch=B,
                                             vocab_size=cfg.vocab_size, seed=3),
                      TrainerConfig(total_steps=3, checkpoint_every=100, log_every=1,
                                    checkpoint_dir=os.path.join(directory, "ckpt")),
                      device="cpu")
    assert trainer.start_step == 2
    snap = os.path.join(directory, "ckpt", "step_00000002")

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}__")
            else:
                _same(v, torch.from_numpy(np.load(os.path.join(snap, f"{prefix}{k}.npy"))),
                      f"one device: restored {prefix}{k}")

    walk(trainer.state, "")
    got = trainer.run()["metrics"][-1]["loss"]
    with open(os.path.join(directory, "loss3.txt")) as f:
        want = float(f.read())
    assert abs(got - want) <= 1e-5, (got, want)
    print(f"ok: resumed on one device, step 3 loss {got:.6f} vs {want:.6f}", flush=True)


def reference_snapshot(directory):
    """A step-2 snapshot of reduced qwen2-7b's train state written by the
    reference's ``Checkpointer``."""
    _jax()
    import jax

    from _torch_lm import cfgs
    from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
    from repro.train.train_step import init_train_state as rinit

    rcfg, _ = cfgs("qwen2-7b", dtype="float32")
    state = rinit(jax.random.PRNGKey(5), rcfg)
    state = dict(state, step=state["step"] + 2)
    ck = RCheckpointer(os.path.join(directory, "ckpt-ref"))
    ck.save(2, state, blocking=True)


def _tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _pick(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def gspmd(directory, shape=(2, 4), archs=("qwen2-7b", "granite-moe-1b-a400m"), capacity=None):
    """Two steps of the port's stacked (2, 4) train step against the
    reference's GSPMD step from the same state: each step's gradients
    (the reference's ``value_and_grad`` jitted under the same mesh and
    shardings) and metrics, and the new state's moments and parameters.
    The parameters alone cannot hold the gradients: AdamW's first step is
    ``lr * sign(g)`` whatever their scale, and an element whose gradient
    sits near the error of the comparison (the key bias's low-frequency
    rotary dims: a shift of every score of a query, up to rounding) takes
    a step of either sign.  So the step is held in two parts: the port's
    gradients against the reference's, and the port's new state against
    the reference's ``adamw_update`` of the port's own gradients (global
    norm, clip, moments, bias correction, decay mask, learning rate) within
    1e-6 of each leaf's largest magnitude; the parameters against the
    GSPMD step's over the elements whose gradient is held (at least 1e-4 of
    its leaf's largest).  ``shape``: the mesh (data, model); ``capacity``:
    the MoE capacity factor on both sides (default the config's)."""
    jax = _jax()
    import jax.numpy as jnp

    from _torch_lm import cfgs
    from repro.configs.base import ShapeConfig as RShape
    from repro.dist.sharding import default_rules as rrules
    from repro.dist.sharding import use_mesh as ruse_mesh
    from repro.launch import steps as rsteps
    from repro.train import optimizer as ropt
    from repro.train.train_step import TrainOptions as RTrainOptions
    from repro.train.train_step import init_train_state as rinit
    from repro.train.train_step import make_loss_fn as rloss_fn
    from repro_torch.dist.sharding import gather_tree
    from repro_torch.interop import train_state_from_numpy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import ShardedTrainStep, TrainOptions

    n = int(np.prod(shape))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    tmesh = _stacked_mesh(shape)
    radamw = jax.jit(lambda g, o, p: ropt.adamw_update(ropt.OptimizerConfig(), g, o, p))
    for arch in archs:
        rcfg, cfg = cfgs(arch, dtype="float32")
        if capacity is not None:
            rcfg, cfg = _with_capacity(rcfg, capacity), _with_capacity(cfg, capacity)
        fn, _, in_sh, out_sh = rsteps.build_step(rcfg, RShape("t", S, B, "train"), jmesh)
        rloss = rloss_fn(rcfg, RTrainOptions(q_chunk=S))

        def rgrads(params, batch):
            with ruse_mesh(jmesh, rrules()):
                return jax.value_and_grad(rloss, has_aux=True)(params, batch)[1]

        rgrads = jax.jit(rgrads, in_shardings=(in_sh[0]["params"], in_sh[1]))
        rstep = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        step = ShardedTrainStep(cfg, opt.OptimizerConfig(), TrainOptions(q_chunk=S), tmesh, B)
        specs = step.state_specs
        np_state = jax.tree.map(np.asarray, rinit(jax.random.PRNGKey(0), rcfg))
        state = train_state_from_numpy(cfg, np_state, mesh=tmesh, specs=specs)
        worst = {"metric": 0.0, "grad": 0.0, "m": 0.0, "v": 0.0, "param": 0.0, "adamw": 0.0}

        def rel(got, want, what, lim, mask=None):
            got, want = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want))
            d = (got - want).abs()
            if mask is not None:
                d = torch.where(mask, d, torch.zeros((), dtype=d.dtype))
            e = float(d.max()) / max(float(want.abs().max()), 1e-30)
            assert e <= lim, (arch, what, e)
            worst[what.split()[1]] = max(worst[what.split()[1]], e / lim)

        for t, tokens in enumerate((_tokens(cfg, 2), _tokens(cfg, 3))):
            rstate = jax.device_put(jax.tree.map(jnp.asarray, np_state), in_sh[0])
            rbatch = jax.device_put({"tokens": jnp.asarray(tokens)}, in_sh[1])
            rg = dict(_tree_leaves(jax.tree.map(np.asarray, rgrads(rstate["params"], rbatch))))
            rnew, rmet = rstep(rstate, rbatch)
            rnew = jax.tree.map(np.asarray, rnew)
            batch = step.place_batch({"tokens": tokens})
            _, g = step.value_and_grad(state["params"], batch)
            g = gather_tree(g, specs["params"], tmesh)
            state, met = step(state, batch)
            new = jax.tree.map(np.asarray, gather_tree(state, specs, tmesh))
            want = jax.tree.map(np.asarray, radamw(
                jax.tree.map(lambda x: jnp.asarray(x.numpy()), g), np_state["opt_state"],
                np_state["params"]))
            # the metrics: the loss and the cross-entropy within 1e-5, the
            # others (grad_norm, lr, z-loss, MoE losses) within 1e-5 of
            # their magnitude
            assert set(met) == set(rmet), (arch, sorted(met), sorted(rmet))
            for k, r in rmet.items():
                e, r = abs(float(met[k]) - float(r)), float(r)
                lim = 1e-5 if k in ("loss", "ce") else 1e-5 * max(1.0, abs(r))
                assert e <= lim, (arch, f"step {t + 1} {k}", float(met[k]), r)
                worst["metric"] = max(worst["metric"], e / lim)
            for path, rgl in rg.items():
                what = f"step{t + 1} {{}} {path}"
                rel(_pick(g, path).numpy(), rgl, what.format("grad"), 1e-4)
                for mom in ("m", "v"):
                    rel(_pick(new["opt_state"][mom], path), _pick(rnew["opt_state"][mom], path),
                        what.format(mom), 1e-4)
                held = torch.from_numpy(np.abs(rgl) >= 1e-4 * np.abs(rgl).max())
                rel(_pick(new["params"], path), _pick(rnew["params"], path),
                    what.format("param"), 1e-4, held)
                rel(_pick(new["params"], path), _pick(want[0], path), what.format("adamw"),
                    1e-6)
                for mom in ("m", "v"):
                    rel(_pick(new["opt_state"][mom], path), _pick(want[1][mom], path),
                        what.format("adamw"), 1e-6)
            assert int(new["opt_state"]["count"]) == int(want[1]["count"]) == t + 1
            np_state = new
        print(f"ok: {arch} {shape}, two steps against the reference's GSPMD step (loss "
              f"{float(met['loss']):.6f}, grad_norm {float(met['grad_norm']):.6f}); the worst of "
              "each check as a share of its tolerance: "
              + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()), flush=True)


def main(argv):
    scenario, directory = argv[1], argv[2]
    if scenario == "train":
        spawn(4, "train", directory)
    elif scenario == "trainer":
        reference_snapshot(directory)
        spawn(4, "write", directory)
        spawn(4, "resume", directory)
        resume_on_one_device(directory)
    elif scenario == "moe":
        spawn(2, "moe", directory)
        spawn(3, "moe", directory)
    elif scenario == "gspmd":
        gspmd(directory)
    elif scenario == "gspmd-moe":
        gspmd(directory, (2, 1), ("granite-moe-1b-a400m",), capacity=0.5)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print("ALL OK")


if __name__ == "__main__":
    main(sys.argv)
