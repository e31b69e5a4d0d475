"""Context parallelism and the sharded train step's microbatches and int8
compression over one process a rank (gloo on the CPU), held against the
single controller's stacked ranks and the reference: a subprocess worker
(``tests/test_torch_cp_processes.py``, ``tests/test_torch_sharded_microbatch.py``).

    python tests/torch_mb_worker.py SCENARIO DIRECTORY

The worker spawns 4 processes (``torch.multiprocessing``, spawn, a file
store under ``DIRECTORY``); every process joins the world with
``repro_torch.dist.processes.init(device="cpu")``.  Scenarios:

- ``cp`` — ``causal_conv_cp`` and ``sliding_window_attention_cp`` on a
  (seq=4) and a (data=2, seq=2) process mesh, with global inputs
  (all-gathered outputs) and placed ones (this process's blocks out):
  bitwise the stacked ranks' run, and within rtol=atol=1e-5 of the
  reference's single-device functions (the launcher runs them with JAX
  before it spawns); every case of F2 (a window or a conv deeper than a
  shard) raises ``ValueError`` on every process, before any message;
- ``train`` — reduced qwen2-7b and granite-moe-1b-a400m (float32) on a
  (data=2, model=2) and a (1, 4) process mesh with ``microbatches=2`` and
  ``grad_compression="int8"``: the loss, the metrics, every gradient
  block, the compressed gradients and the updated state bitwise the
  stacked ranks';
- ``gspmd`` (no processes; 8 virtual XLA devices) — two steps of the
  port's stacked (data=2, model=4) step with ``TrainOptions(
  microbatches=2, grad_compression="int8")`` against the reference's
  ``build_step("train", train_options=...)`` jitted with its own
  shardings, each from the port's own state: the metrics, the gradients
  before and after compression, and the new state (see :func:`gspmd`).

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

B, S = 8, 16
OPTIONS = dict(remat=True, q_chunk=8, microbatches=2, grad_compression="int8")
CP_MESHES = [((4,), ("seq",)), ((2, 2), ("data", "seq"))]


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cp_inputs():
    conv = (_randn(31, 2, 32, 6), _randn(32, 4, 6), _randn(33, 6))
    attn = tuple(_randn(s, 2, 32, 2, 4) for s in (34, 35, 36))
    return conv, attn, 6


def _stacked(shape, names):
    from repro_torch.dist import Mesh

    return Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


def _same(got, want, what):
    if got.shape != want.shape or not torch.equal(got, want):
        err = float((got - want).abs().max()) if got.shape == want.shape else None
        raise AssertionError(f"{what}: not bitwise the stacked ranks (max diff {err})")


def _check_cp(n, rank, directory):
    from repro_torch.dist import processes
    from repro_torch.dist.context_parallel import causal_conv_cp, sliding_window_attention_cp
    from repro_torch.dist.sharding import P, place

    (x, w, b), (q, k, v), W = _cp_inputs()
    x, w, b, q, k, v = map(torch.from_numpy, (x, w, b, q, k, v))
    ref_conv = torch.from_numpy(np.load(os.path.join(directory, "ref_conv.npy")))
    ref_attn = torch.from_numpy(np.load(os.path.join(directory, "ref_attn.npy")))
    for shape, names in CP_MESHES:
        pm, sm = processes.process_mesh(shape, names), _stacked(shape, names)
        what = f"{dict(zip(names, shape))}"
        want = causal_conv_cp(x, w, b, sm, "seq")
        got = causal_conv_cp(x, w, b, pm, "seq")
        _same(got, want, f"{what} causal_conv_cp")
        torch.testing.assert_close(got, ref_conv, rtol=1e-5, atol=1e-5)
        spec = P(None, "seq")
        mine = causal_conv_cp(place(x, pm, spec), w, b, pm, "seq", placed=True)
        _same(mine, place(want, pm, spec), f"{what} causal_conv_cp on placed blocks")
        want = sliding_window_attention_cp(q, k, v, W, sm, "seq")
        got = sliding_window_attention_cp(q, k, v, W, pm, "seq")
        _same(got, want, f"{what} sliding_window_attention_cp")
        torch.testing.assert_close(got, ref_attn, rtol=1e-5, atol=1e-5)
        mine = sliding_window_attention_cp(*(place(t, pm, spec) for t in (q, k, v)), W, pm,
                                           "seq", placed=True)
        _same(mine, place(want, pm, spec), f"{what} sliding_window_attention_cp placed")
        if rank == 0:
            print(f"ok: {what}: both layers over processes bitwise the stacked ranks, global "
                  "and placed", flush=True)
    # F2: a halo deeper than a shard raises on every process, before any
    # message (the cases of tests/test_torch_context_parallel.py)
    pm = processes.process_mesh((4,), ("seq",))
    qs = tuple(torch.from_numpy(_randn(s, 1, 16, 1, 4)) for s in (10, 11, 12))
    conv = tuple(torch.from_numpy(a) for a in (_randn(13, 1, 16, 3), _randn(14, 6, 3),
                                                _randn(15, 3)))
    cases = [("window 6", lambda: sliding_window_attention_cp(*qs, 6, pm, "seq")),
             ("window 9", lambda: sliding_window_attention_cp(*qs, 9, pm, "seq")),
             ("conv width 6", lambda: causal_conv_cp(*conv, pm, "seq")),
             ("placed window 6", lambda: sliding_window_attention_cp(
                 *(place(t, pm, P(None, "seq")) for t in qs), 6, pm, "seq", placed=True))]
    for name, call in cases:
        try:
            call()
        except ValueError as e:
            assert "shard length 4" in str(e), (name, e)
        else:
            raise AssertionError(f"{name}: no ValueError")
    processes.barrier()  # every process got here: none waited on a message
    if rank == 0:
        print("ok: F2's refusals raise on every process", flush=True)


def _cfg(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced_config

    return dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _blocks(tree, specs, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _blocks(v, specs[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree, specs


def _check_train(n, rank, directory):
    from repro_torch.dist import processes
    from repro_torch.dist.sharding import place_tree, rank_block
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import ShardedTrainStep, TrainOptions, init_train_state

    opts = TrainOptions(**OPTIONS)
    for arch in ("qwen2-7b", "granite-moe-1b-a400m"):
        cfg = _cfg(arch)
        state = init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
        batch = {"tokens": _tokens(cfg)}
        for shape in ((2, 2), (1, 4)):
            what = f"{arch} {shape}"
            sm, pm = _stacked(shape, ("data", "model")), processes.process_mesh(
                shape, ("data", "model"))
            ss = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, sm, B)
            ps = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, pm, B)
            s_state, p_state = place_tree(state, ss.state_specs, sm), place_tree(
                state, ps.state_specs, pm)
            (sl, smet), sg = ss.value_and_grad(s_state["params"], ss.place_batch(batch))
            (pl, pmet), pg = ps.value_and_grad(p_state["params"], ps.place_batch(batch))
            _same(pl, sl, f"{what} loss")
            for key in smet:
                _same(pmet[key], smet[key], f"{what} {key}")
            specs = ss.state_specs["params"]
            for (path, g, spec), (_, h, _) in zip(_blocks(sg, specs), _blocks(pg, specs)):
                _same(h, rank_block(g, sm, spec, rank), f"{what} grad {path}")
            for (path, g, spec), (_, h, _) in zip(_blocks(ss.compress(sg), specs),
                                                  _blocks(ps.compress(pg), specs)):
                _same(h, rank_block(g, sm, spec, rank), f"{what} int8 grad {path}")
            s_new, _ = ss(s_state, ss.place_batch(batch))
            p_new, _ = ps(p_state, ps.place_batch(batch))
            for (path, x, spec), (_, y, _) in zip(_blocks(s_new, ss.state_specs),
                                                  _blocks(p_new, ss.state_specs)):
                _same(y, rank_block(x, sm, spec, rank), f"{what} new state {path}")
            if rank == 0:
                print(f"ok: {what}: 2 microbatches, int8: loss {float(pl):.6f}, gradients, "
                      "compressed gradients and new state bitwise", flush=True)


def child(rank, n, scenario, directory, store):
    import faulthandler

    faulthandler.dump_traceback_later(150)
    torch.set_num_threads(1)
    from repro_torch.dist import processes

    processes.init(device="cpu", rank=rank, world_size=n, local_rank=rank, timeout_s=120,
                   init_method=f"file://{os.path.abspath(os.path.join(directory, store))}")
    try:
        {"cp": _check_cp, "train": _check_train}[scenario](n, rank, directory)
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

    mp.start_processes(child, args=(n, scenario, directory, f"store-{scenario}"), nprocs=n,
                       join=True, start_method="spawn")


# --------------------------------------------------------------------------
# the launcher (it alone imports JAX)
# --------------------------------------------------------------------------


def cp_reference(directory):
    """The reference's single-device conv and window attention."""
    import jax
    import jax.numpy as jnp

    from repro.dist import context_parallel as rcp
    from repro.models.mamba import _causal_conv as rcausal_conv

    (x, w, b), (q, k, v), W = _cp_inputs()
    conv = rcausal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))[0]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))
    attn = rcp.sliding_window_attention_cp(*map(jnp.asarray, (q, k, v)), W, mesh, "x")
    np.save(os.path.join(directory, "ref_conv.npy"), np.asarray(conv))
    np.save(os.path.join(directory, "ref_attn.npy"), np.asarray(attn))


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


def gspmd(directory):
    """Two steps of the port's stacked (2, 4) step with 2 microbatches and
    int8 against the reference's GSPMD step with the same options, each
    step from the port's own state.  The parameters alone cannot hold the
    step (AdamW's first step is ``lr * sign(g)`` whatever the gradient's
    scale), so each part is held on its own:

    - the metrics: the loss and the cross-entropy within 1e-5, the others
      within 1e-5 of their magnitude;
    - the gradients before compression against the reference's microbatch
      scan of ``value_and_grad`` (``make_train_step``'s ``compute_grads``)
      jitted under the same mesh and shardings: 1e-4 of each leaf's max;
    - the compressed gradients: the reference's ``int8_roundtrip`` of the
      port's own gradients, the same int8 codes (the whole leaf's scale),
      the dequantized values within two ulps of the leaf's max (the two
      scales, ``max / 127``, may round an ulp apart); and against the
      reference's compressed gradients within one quantization step
      (``max|g| / 127``) plus the two leaves' maxima's difference and the
      dequantized values' float32 rounding;
    - the new params, m and v: within 1e-6 of each leaf's max of the
      reference's ``adamw_update`` of the port's own compressed gradients;
    - m, v and the params against the GSPMD step's within 1e-4 of each
      leaf's max, over the elements whose int8 codes agree (a gradient
      that differs from the reference's by an ulp may round to the
      neighbouring step); at most 1 % of a leaf's elements may differ."""
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
    )
    import jax
    import jax.numpy as jnp

    from _torch_lm import cfgs
    from repro.configs.base import ShapeConfig as RShape
    from repro.dist.compression import int8_roundtrip as rint8
    from repro.dist.sharding import default_rules as rrules
    from repro.dist.sharding import use_mesh as ruse_mesh
    from repro.launch import steps as rsteps
    from repro.train import optimizer as ropt
    from repro.train.train_step import TrainOptions as RTrainOptions
    from repro.train.train_step import init_train_state as rinit
    from repro.train.train_step import make_loss_fn as rloss_fn
    from repro_torch.dist.sharding import gather_tree
    from repro_torch.interop import train_state_from_numpy
    from repro_torch.launch.steps import build_step
    from repro_torch.train.train_step import TrainOptions

    torch.set_num_threads(1)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    tmesh = _stacked((2, 4), ("data", "model"))
    ropts = RTrainOptions(**OPTIONS)
    n = ropts.microbatches
    radamw = jax.jit(lambda g, o, p: ropt.adamw_update(ropt.OptimizerConfig(), g, o, p))
    rq = jax.jit(rint8)
    for arch in ("qwen2-7b", "granite-moe-1b-a400m"):
        rcfg, cfg = cfgs(arch, dtype="float32")
        shape = RShape("t", S, B, "train")
        fn, _, in_sh, out_sh = rsteps.build_step(rcfg, shape, jmesh, train_options=ropts)
        rstep = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        grad_fn = jax.value_and_grad(rloss_fn(rcfg, ropts), has_aux=True)

        def rgrads(params, batch):
            # make_train_step's compute_grads with microbatches, then int8
            def micro(acc, mb):
                g = grad_fn(params, mb)[1]
                return jax.tree.map(lambda a, x: a + x / n, acc, g), None

            with ruse_mesh(jmesh, rrules()):
                mbs = jax.tree.map(lambda x: x.reshape((n, x.shape[0] // n) + x.shape[1:]),
                                   batch)
                g = jax.lax.scan(micro, jax.tree.map(jnp.zeros_like, params), mbs)[0]
                return g, rint8(g)

        rgrads = jax.jit(rgrads, in_shardings=(in_sh[0]["params"], in_sh[1]))
        step = build_step(cfg, shape, tmesh, train_options=TrainOptions(**OPTIONS))[0].placed
        specs = step.state_specs
        np_state = jax.tree.map(np.asarray, rinit(jax.random.PRNGKey(0), rcfg))
        state = train_state_from_numpy(cfg, np_state, mesh=tmesh, specs=specs)
        worst = {k: 0.0 for k in ("metric", "grad", "int8", "adamw", "m", "v", "param")}
        flipped = 0.0

        def rel(got, want, what, lim, mask=None):
            got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
            d = np.abs(got - want)
            if mask is not None:
                d = np.where(mask, d, 0.0)
            e = float(d.max()) / max(float(np.abs(want).max()), 1e-30)
            assert e <= lim, (arch, what, e)
            kind = what.split()[1]
            worst[kind] = max(worst[kind], e / lim)

        for t, tokens in enumerate((_tokens(cfg, 2), _tokens(cfg, 3))):
            rstate = jax.device_put(jax.tree.map(jnp.asarray, np_state), in_sh[0])
            rbatch = jax.device_put({"tokens": jnp.asarray(tokens)}, in_sh[1])
            rg, rgc = (dict(_tree_leaves(jax.tree.map(np.asarray, x)))
                       for x in rgrads(rstate["params"], rbatch))
            rnew, rmet = rstep(rstate, rbatch)
            rnew = jax.tree.map(np.asarray, rnew)
            batch = step.place_batch({"tokens": tokens})
            _, g = step.value_and_grad(state["params"], batch)
            gc = step.compress(g)
            g = jax.tree.map(np.asarray, gather_tree(g, specs["params"], tmesh))
            gc = jax.tree.map(np.asarray, gather_tree(gc, specs["params"], tmesh))
            mine_q = jax.tree.map(np.asarray, rq(jax.tree.map(jnp.asarray, g)))
            state, met = step(state, batch)
            new = jax.tree.map(np.asarray, gather_tree(state, specs, tmesh))
            want = jax.tree.map(np.asarray, radamw(jax.tree.map(jnp.asarray, gc),
                                                   np_state["opt_state"], np_state["params"]))
            assert set(met) == set(rmet), (arch, sorted(met), sorted(rmet))
            for k, r in rmet.items():
                e, r = abs(float(met[k]) - float(r)), float(r)
                lim = 1e-5 if k in ("loss", "ce") else 1e-5 * max(1.0, abs(r))
                assert e <= lim, (arch, f"step {t + 1} {k}", float(met[k]), r)
                worst["metric"] = max(worst["metric"], e / lim)
            for path, rgl in rg.items():
                what = f"step{t + 1} {{}} {path}"
                mine, mine_c, ref_c = _pick(g, path), _pick(gc, path), rgc[path]
                rel(mine, rgl, what.format("grad"), 1e-4)
                m_got, m_want = float(np.abs(mine).max()), float(np.abs(rgl).max())
                # the same int8 codes: a code apart is max / 127 apart
                d = float(np.abs(mine_c - _pick(mine_q, path)).max())
                assert d <= m_got * 2.0**-22, (
                    arch, what.format("int8"), "not the reference's int8 of the port's gradients",
                    d, m_got / 127.0)
                quantum = m_want / 127.0
                bound = quantum + abs(m_got - m_want) + m_want * 2.0**-23
                d = float(np.abs(mine_c - ref_c).max())
                assert d <= bound, (arch, what.format("int8"), d, quantum)
                worst["int8"] = max(worst["int8"], d / bound)
            for path, rgl in rg.items():
                what = f"step{t + 1} {{}} {path}"
                mine_c, ref_c = _pick(gc, path), rgc[path]
                quantum = float(np.abs(rgl).max()) / 127.0
                rel(_pick(new["params"], path), _pick(want[0], path), what.format("adamw"), 1e-6)
                for mom in ("m", "v"):
                    rel(_pick(new["opt_state"][mom], path), _pick(want[1][mom], path),
                        what.format("adamw"), 1e-6)
                same = np.abs(mine_c - ref_c) < quantum / 2
                flipped = max(flipped, 1.0 - float(same.mean()))
                assert same.mean() >= 0.99, (arch, what.format("int8"), float(same.mean()))
                for mom in ("m", "v"):
                    rel(_pick(new["opt_state"][mom], path), _pick(rnew["opt_state"][mom], path),
                        what.format(mom), 1e-4, same)
                rel(_pick(new["params"], path), _pick(rnew["params"], path),
                    what.format("param"), 1e-4, same)
            assert int(new["opt_state"]["count"]) == int(want[1]["count"]) == t + 1
            np_state = new
        print(f"ok: {arch} (2, 4), 2 microbatches and int8, two steps against the reference's "
              f"GSPMD step (loss {float(met['loss']):.6f}, grad_norm "
              f"{float(met['grad_norm']):.6f}); the worst of each check as a share of its "
              "tolerance: " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
              + f"; int8 codes that differ from the reference's: at most {flipped:.2e} of a leaf",
              flush=True)


def main(argv):
    scenario, directory = argv[1], argv[2]
    if scenario == "cp":
        cp_reference(directory)
        spawn(4, "cp", directory)
    elif scenario == "train":
        spawn(4, "train", directory)
    elif scenario == "gspmd":
        gspmd(directory)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print("ALL OK")


if __name__ == "__main__":
    main(sys.argv)
