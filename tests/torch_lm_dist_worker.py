"""The port's expert parallelism against the reference's on a (data=2,
model=4) mesh: a subprocess worker (``tests/test_torch_lm_dist.py``).

    python tests/torch_lm_dist_worker.py [moe|grads|all]

The reference needs 8 devices for its mesh, so this process sets 8
virtual XLA CPU devices (``--xla_force_host_platform_device_count=8``)
before JAX is imported.  The port runs the same mesh as 8 CPU ranks of a
``repro_torch.dist.Mesh``.

- ``moe``: ``moe_apply`` of reduced granite-moe-1b-a400m (float32) under
  ``use_mesh`` on both sides, for x of [4, 16, 64] (``ep_block``: the
  all-to-alls) and [2, 1, 64] (``ep_block_small``: decode).  Outputs within
  1e-5, aux losses within 1e-6.  The aux rule is pinned: the value is data
  shard 0's (its mean over the model ranks of ``_route`` 's aux on their
  token slices for ``ep_block``; its routing's aux for ``ep_block_small``).
- ``grads``: ``jax.value_and_grad`` of the reduced granite-moe-1b-a400m and
  olmoe-1b-7b losses under ``use_mesh`` against the port's autograd under
  its ``use_mesh``: the loss and its metrics within 1e-5, every gradient
  leaf within 1e-4 of its largest magnitude.

Exit 0 and ``ALL OK`` when every case holds.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_lm import Pair, to_numpy  # noqa: E402
from repro.dist.sharding import use_mesh as ruse_mesh  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.train import train_step as rts  # noqa: E402
from repro_torch.dist import Mesh, use_mesh  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402


def meshes():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    tmesh = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(2, 4),
                 ("data", "model"))
    return jmesh, tmesh


def close(got, want, what, tol):
    want = torch.from_numpy(np.array(want, np.float32))
    err = float((got.detach().float() - want).abs().max())
    torch.testing.assert_close(got.detach().float(), want, rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")
    print(f"ok: {what}: max |port - reference| {err:.3e}")


def moe_cases():
    pair = Pair("granite-moe-1b-a400m")
    jmesh, tmesh = meshes()
    rp = pair.rparams["cells"]["slot0"]["moe"]
    rp = jax.tree.map(lambda a: a[0], rp)
    p = lm.tree_map(lambda a: a[0], pair.params["cells"]["slot0"]["moe"])
    f32 = torch.float32
    for shape, small in (((4, 16, 64), False), ((2, 1, 64), True)):
        x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)

        def rrun(rp, x):
            with ruse_mesh(jmesh):
                return rmoe.moe_apply(rp, x, pair.rcfg, jnp.float32)

        ry, raux = jax.jit(rrun)(rp, jnp.asarray(x))
        with use_mesh(tmesh):
            y, aux = moe.moe_apply(p, torch.from_numpy(x), pair.cfg, f32)
        tag = "ep_block_small" if small else "ep_block"
        close(y, ry, f"moe {tag} {shape} y", 1e-5)
        for k in aux:
            close(aux[k], raux[k], f"moe {tag} {shape} {k}", 1e-6)
        # the pinned rule: data shard 0's value
        xt = torch.from_numpy(x[: shape[0] // 2]).reshape(-1, shape[-1])
        if small:
            _, _, want = moe._route(p, xt, pair.cfg, f32)
        else:
            parts = [moe._route(p, s, pair.cfg, f32)[2] for s in xt.chunk(4)]
            want = {k: sum(a[k] for a in parts) / 4 for k in parts[0]}
        for k in aux:
            close(aux[k], want[k].numpy(), f"moe {tag} {shape} {k} = data shard 0's", 1e-6)


def grad_cases():
    jmesh, tmesh = meshes()
    for arch in ("granite-moe-1b-a400m", "olmoe-1b-7b"):
        pair = Pair(arch)
        (rt, _), (t, _) = pair.inputs()
        options = dict(q_chunk=8)

        def rloss(params, batch):
            with ruse_mesh(jmesh):
                return rts.make_loss_fn(pair.rcfg, rts.TrainOptions(**options))(params, batch)

        (rl, rmetrics), rgrads = jax.jit(jax.value_and_grad(rloss, has_aux=True))(
            pair.rparams, {"tokens": rt})

        def loss(params, batch):
            with use_mesh(tmesh):
                return ts.make_loss_fn(pair.cfg, ts.TrainOptions(**options))(params, batch)

        (l, metrics), grads = ts.value_and_grad(loss)(pair.params, {"tokens": t})
        close(l, rl, f"{arch} mesh loss", 1e-5)
        for k in metrics:
            close(metrics[k], rmetrics[k], f"{arch} mesh {k}", 1e-5)
        want = lm.leaves(to_numpy(rgrads))
        worst = 0.0
        for k, g in lm.leaves(grads).items():
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            w = torch.from_numpy(np.array(want[k], np.float32)) / scale
            worst = max(worst, float((g / scale - w).abs().max()))
            torch.testing.assert_close(g / scale, w, rtol=1e-4, atol=1e-4,
                                       msg=lambda m, k=k: f"{arch} grad {k}: {m}")
        print(f"ok: {arch} mesh gradients: max scaled |port - reference| {worst:.3e}")


SCENARIOS = {"moe": moe_cases, "grads": grad_cases}

if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    for name in list(SCENARIOS) if which == "all" else [which]:
        SCENARIOS[name]()
    print("ALL OK")
