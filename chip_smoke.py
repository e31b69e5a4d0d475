"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases 0-9 pin ``Target(jit=False)`` (each op launched from the host), so
their times compare with earlier runs.
Builds every kernel of the main path from the sources in this checkout
(``nvcc``, one process per generated source, all started together) and
logs each source's registers per thread (``ptxas -v``), shared memory per
CTA and resident CTAs per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
through the source's exported query), then runs in phases; any failed
check raises and the script exits non-zero:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. kernel K1 (``stencil.apply``) against its plain PyTorch version on the
   card, bitwise, and its time beside its bound and its time before the
   Hopper redesign (``BEFORE_MS``, copied from PERF.md, logged only): heat
   stars (so 2/4/8, 2D 16384², 3D 1024³), the wave apply, a random star
   and a 3-D box; then heat so4 on operands at storage offsets 1 and 2
   (4- and 8-byte aligned pointers: the narrow-copy kernels);
2. the main path at the paper's fig-7 sizes: heat 16384² (so 2/4/8) and
   1024³ (so 4), ``Operator(Eq(u.dt, 0.5*u.laplace))`` → ``Target(backend=
   "cuda")`` → 8 steps, bitwise against ``Target(backend="torch")``, K1
   launches counted; then small grids against the independent oracles of
   ``kernels/ref.py``;
3. deep-halo epochs without the epoch kernel: heat 16384² so4 with
   ``exchange_every=4`` (4 K1 launches per epoch), bitwise against k=1;
4. wave (fig. 7b) 16384² so4, two-buffer rotation, bitwise against torch;
5. where a step's device time goes: ``torch.profiler`` over 4 steps of
   heat 16384² so4 and so8, 1024³ so4 and the fused heat epoch of phase 6
   (device time by kernel, busy share);
6. kernel K2 (``stencil.fused_epoch``): bitwise against its plain version
   on the card, timed beside its bound and ``BEFORE_MS`` (heat 2D so2/4/8
   k=4 zero and periodic, wave so4 k=4, 3-D heat so4 k=2, a
   ``stencil.index`` chain, explicit tiles against the default ones): CUDA
   events around 10 launches, the K2 kernel's own device time
   (``torch.profiler``) and the host's time to enqueue one call; heat so4
   k=4 on operands at storage offsets 1 and 2; 6b
   runs the main path ``Target(backend="cuda", exchange_every=4, fused_epoch=True)``
   for heat and wave 16384² so4, one K2 launch and no K1 launch per epoch,
   bitwise against the unfused K1 route and the torch backend;
7. the tests marked ``gpu`` (``pytest -m gpu``) on the same card;
8. distribution on this one card: four ranks on a 2x2 ``Mesh`` whose
   devices are all this card (2x2x1 in 3-D), ``Target(mesh=..., strategy=
   make_strategy_2d((2, 2)), backend="cuda")`` over 8 steps of heat 16384²
   so4 (zero and periodic, each also with ``overlap=True``), heat with
   ``exchange_every=4, fused_epoch=True`` (zero: each rank's K2 keeps
   another box; periodic), wave fused and heat 1024³ so4, each bitwise
   against the single-device cuda run, with K1 launches = ranks x applies
   and K2 launches = ranks per epoch; ms/step over 4 ranks beside one
   device (CUDA events on sharded state, three runs each in turns) and
   the profiler split of the k=1, overlap and fused zero-BC heat cases;
   the rank-local K2 against its plain version at each corner's box;
9. fig-10 advection at 512³ (PW and tracer advection, recognized by the
   psyclone-like frontend from the kernels of
   ``benchmarks/fig10_advection.py``, copied below), zero and periodic:
   backend cuda bitwise against torch, and over 2x2x1 ranks on this card
   bitwise against one device; PW is one apply with three results, one
   K1 launch per rank; ms per call;
10. the compiled step, ``Target(jit=True, donate=True)``: heat 16384² so4
   and 1024³, wave, the fused heat and wave epochs, and over 2x2 ranks
   heat k=1 (zero, periodic), with overlap (zero, periodic) and fused k=4,
   each bitwise against ``jit=False``, one graph replay per epoch; what
   each captured graph holds, read from the graph itself
   (``kernels/graphs.py``): K1 and K2 nodes = ranks x applies, and for
   the overlap cases 16 frame nodes, no kernel besides K1, copies and
   fills, and no more copies than the step without overlap; ms/step
   beside ``jit=False`` (three runs each in turns), the host's time per
   step and per replay call, the profiler's device time per kernel; the
   frames' K1 launch set timed (in a graph) beside its bound, its
   launches counted from the replayed graphs' nodes; fig-10 PW and tracer
   through ``__call__`` on one device and 2x2x1 ranks, bitwise against
   ``jit=False``, ms per call.
11. the cost model and the autotuner: a message's latency (one exchange
   patch copy as a node of a captured graph, ``launch/roofline.py``
   ``LINK_LATENCY``); ``CompiledStencil.cost()`` of every phase-10 case
   beside its measured ms/step under ``jit`` (the modeled time, a least
   time, may not exceed 1.05 x the measured one); three measured searches
   of ``repro_torch.tune`` on heat 16384² so4 in a fresh tune cache: (a)
   ``tune`` with the reference's options, then ``Target.tuned``, on one
   device, (b) ``exchange_every=(4,)`` with every candidate measured
   (fused and unfused k=4 epochs, K2's tile candidates), (c) four ranks on
   this card with ``exchange_every=(1, 4)``; each prints its ranked table,
   no survivor may fail, the winner is the measured argmin, its 8 steps
   through its compiled step are bitwise ``Target(backend="cuda",
   jit=False)``, its K1/K2 launches are counted from its graphs' nodes,
   and the same call again is a cache hit that measures nothing; the
   winner's kernel joins the kernels line; the phase must take under 240 s.
12. checkpoint and resilience (``resilience_phase``): heat and wave 16384²
   so4 through ``repro_torch.resilience.ResilientLoop`` on A (fused k=4,
   one device), B (A over 2x2 ranks), C (k=1 over 2x2) and D (k=1, one
   device), ``jit=True,
   donate=True``, 16 steps a run with a snapshot every epoch into a
   temporary directory (free disk checked first); uninterrupted, killed
   and resumed onto another mesh or epoch depth, wave also at k=1 from an
   odd rotation phase, and after a torn snapshot, each bitwise its
   uninterrupted run;
   K1/K2 launches counted from the replayed graphs' nodes of each loop
   (zeroed when it starts, read when it ends), no graph
   re-captured after a checkpoint; two traced epochs each of heat k=1 and
   the fused heat loop held against ``cost()`` by ``obs.drift_report``;
   the loop's own cost beside ``time_loop``, each snapshot's size and
   seconds (to the host, the write, the loop blocked, blocking and async),
   the time to recover by part, the peak device memory; under 180 s.
13. the serving engine (``serving_phase``): ``StencilEngine`` through
   ``submit``/``step``/``run`` with programs of the oec-like builder: (1)
   one engine with three buckets at 16384² so4: H (heat, fused k=4) in a
   pool of 4 with 6 requests of 16-48 steps, W (wave, fused k=4) in a
   pool of 2 with 3, K (heat k=1, K1) in a pool of 4 with 4; (2) 32 heat
   tenants at 1024² arriving Poisson into a pool of 16 (warmed first,
   untimed), then the same requests solo; (3) heat fused k=4 over a 2x2 mesh of this card in a
   pool of 2, and ``pooled_target(.., slots=2, devices=[card] * 8)`` on
   ``[2, 16384, 16384]``; (4) an autoscaled burst and a migration between
   engines at 1024².  Every result and frame bitwise its solo
   ``time_loop``; each engine step's K1/K2 launches are the nodes of the
   graphs it replayed (1 K2 a dispatch for H and W, 1 K1 per apply for K,
   4 K2 on the 2x2 mesh, however many slots are live); one capture per
   rotation phase per pool width; memory back to within 64 MiB once the
   buckets retire; ``obs.snapshot()`` counts; p50/p99 ms per pooled
   dispatch, host ms per engine step, GPts/s per bucket, pooled against
   solo GPts/s, resize and migration seconds, peak memory (under 60 GiB);
   under 150 s.  Each pool's kernel joins the kernels line (``[B, *shape]``
   operands against the plain version and B solo launches, its bound B x
   the solo work, K1's yardstick a batched ``F.conv2d``).
14. the language-model serving engine (``lm_phase``; no kernel of its
   own, so nothing joins the kernels line): ``repro_torch.serve.Engine``
   over qwen2-7b at full width and depth in bfloat16 (8 slots of 512
   positions, 16 prompts of 16-250 tokens, 32 new tokens each: prefill
   ms per bucket, decode ms per engine step, tokens/s, time to first
   token, host ms per step, one decode step's card busy time by kernel,
   peak memory); the same params in float32, every request of 4 slots
   equal to its solo greedy run (a first difference only at a near-tie);
   every other config at its published width with one supercell, through
   the engine or (seamless, internvl2) prefill and decode; every reduced
   config on the card against the CPU within 1e-4; under 180 s and 70 GiB.
15. language-model training (``train_phase``; no kernel of its own, so
   nothing joins the kernels line): ``repro_torch.train.Trainer`` over
   granite-moe-1b-a400m at full width and depth (1.385 B float32
   parameters, bf16 compute, remat, 2 microbatches of 4 x 4096 tokens),
   6 steps with a checkpoint every 3: ms per step, tokens/s, host ms,
   every loss and aux loss finite, peak memory; then SIGTERM during step
   3 and a resume in a new trainer, steps 4-6 bitwise the uninterrupted
   run (params, moments, losses; deterministic algorithms); every
   reduced config's loss and gradients on the card against the CPU;
   under 180 s and 70 GiB.
16. language models over a mesh of ranks on this card (``lm_mesh_phase``;
   no kernel of its own, so nothing joins the kernels line), every mesh's
   ranks on the card, float32, through ``launch.steps.build_step`` and
   ``use_mesh``: (1) yi-9b at published width, 8 of 48 layers, B=8 against
   a 32768-long seeded cache on (data=2, model=8), the ``"seq"`` layout:
   the flash-decode's logits and cache within 2e-5 of the flat decode, no
   second cache copy; (2) the same at B=1, T=131072, 4 layers,
   ``"seq_all"``; (3) granite-moe-1b-a400m, 8 layers, capacity factor 4.0,
   on (2, 4): an 8 x 4096 prefill (``ep_block``, the all-to-alls) and a B=2
   decode (``ep_block_small``) within 1e-5 of the single-rank path, the
   aux losses data shard 0's within 1e-6; (4) reduced granite and olmoe
   loss and gradients on the mesh, card against CPU ranks; (5)
   ``causal_conv_cp`` (d_inner 8192, S 32768) and
   ``sliding_window_attention_cp`` (window 4096, head_dim 128) over 8
   sequence ranks, bitwise one rank / the window function on the global
   slice, and 16 ranks refused; ms per call flat against the mesh, peak
   memory; under 150 s and 70 GiB.
17. one process per card (``process_phase``, ``repro_torch.dist.processes``):
   ``torch.cuda.device_count()`` processes started by
   ``torch.multiprocessing`` (spawn), each on ``cuda:rank`` over NCCL, on a
   2x2 process mesh on four cards (1 x n else): (a) heat 16384² so4 k=1
   zero and periodic, with ``overlap=True``, fused k=4 heat and wave, (b)
   heat k=1 and fused k=4 at 16384² a rank, each under ``jit=False`` and
   ``jit=True, donate=True``, bitwise, K1/K2 launches and each graph's
   K1/K2/NCCL nodes counted, ms/step, each process's NCCL and K1/K2 device
   time (profiler), the strong-scaling speed-up and weak-scaling
   efficiency against phase 10, peak memory; (c) ``comm.allreduce`` over
   both axes; (d) a ``ResilientLoop`` killed after its snapshot; (e)
   yi-9b's decode (8 layers, B=8, T=32768) and its seq-sharded
   flash-decode at published widths, (f) granite-moe-1b-a400m's
   expert-parallel prefill (8 x 4096) and B=2 decode, on (data=1,
   model=n) processes, bitwise the stacked ranks on one card and within
   phase 16's tolerances of the flat run, with the routing decisions one
   batched router product over the stacked ranks would change.  Here,
   every (a)-(c) block is bitwise the single controller's ``jit=False``
   run over the same cards (SHA-256 of each rank's block), the snapshot
   resumes on this card's single controller bitwise, and each kernel of
   the path joins the kernels line (launches: every process's, summed).
   Each process records every part as it ends, and every part that ended
   is checked and logged before a failure fails the phase.  On one card
   the world is one process (``phase 17: world=1, no message crosses
   processes``).  A failed process, or a wait over 150 s, fails it.
   ``python3 chip_smoke.py --phase 17`` runs phase 0 and phase 17 alone,
   against one card's times of its cases taken in that run.  Each
   process's timed steps start from a barrier; the pace is the slowest
   process's.
18. tensor and data parallelism of the language models (``tp_phase``,
   ``train_step.ShardedTrainStep``, ``Trainer(state_shardings=...)``):
   ranks stacked on the card, (a) qwen2-7b at published width, 4 of 28
   layers, float32, 2 x 2048 tokens on (data=1, model=4) and (2, 2), (b)
   granite-moe-1b-a400m, 8 layers, capacity 4.0, on (2, 2), each one
   step's loss within 1e-5 of the flat port and every gradient leaf within
   1e-4 of its largest magnitude, one rank's state bytes against flat;
   (c) a ``Trainer(state_shardings=...)`` of qwen2-7b (1 layer) on (1, 4),
   its step-2 snapshot resumed on (2, 2) and on one device, each restored
   state bitwise the saved one; (g) the tensor-parallel decode
   (``launch.steps.ShardedDecode``) with one position a row: qwen2-7b at
   published width, 4 layers, float32, B=8 prompts of seeded lengths
   16-250 prefilled flat one at a time, grown to T=512 and stacked (8
   depths), 16 steps each row at its own position, fed the flat run's
   greedy tokens, on (1, 4) ``heads``, (2, 8) ``seq``, (1, 8) ``seq_all``
   and (8, 1) ``batch``: logits within 2e-5 and the cache within 2e-5 /
   1e-4 of the flat ``lm.decode_step`` at every step, ms a step against
   flat, one rank's cache bytes, and a ``[B]`` of equal positions bitwise
   the scalar position; under 150 s and 70 GiB.  ``python3
   chip_smoke.py --phase 18`` runs phase 0 and phase 18 alone, and on four
   cards adds one process per card over NCCL: (d) (a) and (b) bitwise the
   stacked ranks (a checksum of each block), (e) (c) saved on (1, 4)
   processes and resumed on (2, 2) processes and on one card, (f)
   qwen2-7b at published width and full depth, bf16 compute, float32
   state, remat, 4 x 4096 tokens on (1, 4), 3 ``Trainer`` steps timed from
   a barrier (the slowest process), its step-1 loss within 2e-3 of the
   flat forward on one card (measured 1.8e-04 apart on four H100 80GB
   HBM3 at 700 W, where bf16's own spread against float32 was 3.1e-05);
   (h) (g)'s decode on (1, 4) and (2, 2) processes, every step's logits
   block and the last cache blocks bitwise the stacked ranks'; under 300 s
   and 75 GiB a card.

19. the serving engine's slot axis, context parallelism and the sharded
   train step's microbatches and int8 compression over one process a card
   (``p19_phase``): (a) a world of one process, a ``StencilEngine`` whose
   buckets H (heat 16384² so4 fused k=4, K2, a pool of 4, 6 requests) and
   K (heat so2 k=1, K1, a pool of 4, 4 requests) run over a process mesh,
   the slot axis factored out of the world: every result and frame
   bitwise its solo ``time_loop``, and the single-controller slot-axis
   sibling bitwise the solo runs; K1 and K2 of its path join the kernels
   line; (b) ``causal_conv_cp`` (d_inner 8192, S 32768) and
   ``sliding_window_attention_cp`` (window 4096, head_dim 128, S 4096)
   over that world, bitwise the stacked ranks and the flat call; (c)
   ``ShardedTrainStep`` with 2 microbatches and int8 on stacked (2, 2)
   ranks, qwen2-7b (4 layers, 4 x 2048 tokens) and granite (8 layers),
   against the flat port: loss 1e-5, gradients 1e-4 of a leaf's max, the
   int8 gradients within one quantization step; under 90 s and 70 GiB.
   ``python3 chip_smoke.py --phase 19`` runs phase 0 and phase 19 alone,
   and on four cards adds (d) (a) over (slot=2, x=2) and (slot=1, 2x2)
   processes with a resize and an evacuation onto one card, (e) (b) over
   4 processes at S 32768 and F2 raised on every process, (f) (c) over
   (2, 2) processes bitwise the stacked ranks and qwen2-7b at full depth
   with 2 microbatches and int8 on (1, 4), 3 ``Trainer`` steps; under 300
   s and 75 GiB a card.

20. deep 3-D fused epochs (``deep_phase``), which no tile of shared memory
   holds (or, heat so8 k=4, only as 2x2x2 tiles), so K2 streams planes
   through rings of shared memory (its streaming plans), or keeps buffers
   in device memory (its scratch plans) where no stream fits: (a) at 256³
   heat so4 k=8, heat so8 k=4, wave so4 k=8 and so8 k=4 streaming, the
   scratch plans and 2x2x2 tiles they had before, and heat so4 k=2 forced
   off chip and forced to stream, K2 bitwise its plain version (the
   forced cases also K2 in shared memory at its tile), and a pool of 2
   slots in one launch against solo launches; (b) the main path at 1024³:
   fused heat so4 and so8 k=8, heat so8 k=4, wave so4 k=8 and so8 k=4,
   one K2 launch and no K1 launch an epoch, bitwise against the unfused
   route and ``Target(backend="torch")``, then ``jit=True, donate=True``
   bitwise ``jit=False`` with one K2 node and no K1 node in each captured
   graph; K2 timed beside its bound, its plain version, its old plan
   (bitwise) and the unfused route's ms an epoch, with its plan,
   registers, spills, shared memory, CTAs an SM and peak memory; (c) heat
   so4 k=8 over a 2x2x1 mesh of this card bitwise against one device,
   four K2 launches an epoch, its rank-local K2 bitwise the plain version
   at each corner's box.  Each 1024³ case joins the kernels line.
   ``python3 chip_smoke.py --phase 20`` runs phase 0 and phase 20 alone.

Phase 1 also runs K1 heat so4 at 1024² on a pool of 16 slots, and phase 6
K2 heat so4 k=4 at 16384² on a pool of 2, each in one launch, bitwise
against its plain version and against a launch on each slot alone, timed
beside those solo launches and beside B x the solo bound.

The line before the last is ``{"kernels": [...]}``: per main-path case,
the kernel's launches in that case's counted run, its time per launch,
the plain version's time, the least time the card could take (bytes over
3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is larger, from
the cost model's counts in ``launch/roofline.py``)
and, for single-operand linear applies, the time of ``F.conv2d``/``F.conv3d`` with the same star
(a yardstick only; the port never calls it; no single PyTorch call
computes a K2 epoch).  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads this when it starts: a fixed workspace makes its GEMMs
# deterministic, which phase 15's bitwise resume (under
# torch.use_deterministic_algorithms) needs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

STEPS = 8
SEED = 0
REPLACES = "src/repro/kernels/stencil_apply.py:81"
SOURCE = "src/repro_torch/kernels/stencil_apply.py"
K2_REPLACES = "src/repro/kernels/epoch_kernel.py:117"
K2_SOURCE = "src/repro_torch/kernels/epoch_kernel.py"
# ms per launch of K1 and K2 before their redesign for Hopper, copied from
# PERF.md (NVIDIA H100 80GB HBM3 at 700 W): printed beside this run's times
# in the log lines, never in the kernels line, which holds this run's numbers
BEFORE_MS = {
    "K1 heat2d_so2 16384x16384": 1.0151,
    "K1 heat2d_so4 16384x16384": 1.1109,
    "K1 heat2d_so8 16384x16384": 1.3936,
    "K1 heat3d_so4 1024^3": 5.1933,
    "K1 wave2d_so4 16384x16384 (program apply)": 1.3133,
    "K2 heat2d_so2 16384x16384 k=4 zero": 1.5206,
    "K2 heat2d_so2 16384x16384 k=4 periodic": 1.4403,
    "K2 heat2d_so4 16384x16384 k=4 zero": 2.3762,
    "K2 heat2d_so4 16384x16384 k=4 periodic": 2.3013,
    "K2 heat2d_so8 16384x16384 k=4 zero": 4.3618,
    "K2 heat2d_so8 16384x16384 k=4 periodic": 4.3286,
    "K2 wave2d_so4 16384x16384 k=4 zero": 3.5142,
    "K2 heat3d_so4 128^3 k=2 zero": 0.0378,
    "K2 heat2d_so4 16384x16384 k=4 zero, tile (32, 128)": 2.4673,
    "K2 heat3d_so4 128^3 k=2 zero, tile (8, 8, 32)": 0.0378,
}


# The fig-10 kernels of benchmarks/fig10_advection.py (PW advection and
# tracer advection), read by the psyclone-like frontend from this source;
# i, j, k are its loop indices and the functions never run.
def pw_advection(u, v, w, su, sv, sw):
    su[i, j, k] = 0.5 * (  # noqa: F821
        u[i, j, k] * (v[i, j, k] + v[i + 1, j, k])  # noqa: F821
        - u[i - 1, j, k] * (v[i - 1, j, k] + v[i, j, k])  # noqa: F821
    )
    sv[i, j, k] = 0.5 * (  # noqa: F821
        v[i, j, k] * (w[i, j, k] + w[i, j + 1, k])  # noqa: F821
        - v[i, j - 1, k] * (w[i, j - 1, k] + w[i, j, k])  # noqa: F821
    )
    sw[i, j, k] = 0.5 * (  # noqa: F821
        w[i, j, k] * (u[i, j, k] + u[i, j, k + 1])  # noqa: F821
        - w[i, j, k - 1] * (u[i, j, k - 1] + u[i, j, k])  # noqa: F821
    )


def tracer_advection(t, u, v, zwx, zwy, out):
    zwx[i, j, k] = u[i, j, k] * (t[i + 1, j, k] - t[i, j, k])  # noqa: F821
    zwy[i, j, k] = v[i, j, k] * (t[i, j + 1, k] - t[i, j, k])  # noqa: F821
    out[i, j, k] = t[i, j, k] - 0.1 * (  # noqa: F821
        zwx[i, j, k] - zwx[i - 1, j, k] + zwy[i, j, k] - zwy[i, j - 1, k]  # noqa: F821
    )


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seconds(fn, dev) -> float:
    """Seconds of ``fn()`` once the card has finished it (CUDA events on
    the card, the host's clock on the CPU); what ``fn`` returns is
    dropped."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def resilience_phase(dev, heat, wave, *, record, card="", steps=16, keep_last=2) -> list:
    """Phase 12: checkpoint and resilience (``repro_torch.resilience``)
    on ``dev`` for the time-loop programs ``heat`` (one buffer) and
    ``wave`` (two), through the compiled step on three targets:

    - A: ``Target(backend="cuda", exchange_every=4, fused_epoch=True,
      jit=True, donate=True)`` on one device (K2);
    - B: A over a 2x2 mesh of this device (K2 on each of 4 ranks);
    - C: ``Target(backend="cuda", jit=True, donate=True)`` at k=1 over
      the 2x2 mesh (K1);
    - D: C on one device (K1).

    Every run takes ``steps`` steps with a snapshot every epoch
    (``keep_last`` kept) in a temporary directory, removed at the end.
    Each loop starts from a fresh compile, as a new process would; each
    is driven epoch by epoch through ``ResilientLoop.advance_epoch``.
    Raises unless: the uninterrupted heat run on A is bitwise
    ``time_loop`` and ``jit=False``; heat killed on A at epoch 2 and
    resumed on B, killed on C at epoch 8 and resumed on A, and killed on
    A after a torn snapshot (step 8, so the resume picks step 4 and the
    startup GC removes one partial directory) are bitwise that run; wave
    killed on A at epoch 1 and resumed on B, and wave at k=1 killed on C
    at epoch 5 (rotation phase 1) and resumed on D, are bitwise its
    uninterrupted run on A; the K1 and K2 nodes each loop's graph replays
    ran (counted from zero when the loop starts) equal epochs x ranks x
    applies and are its launches on the kernels line, its captures one per
    rotation phase its ring reached,
    and no loop's ring was replaced mid-run; two traced epochs each of
    heat k=1 and of the heat resilient loop on A give a drift report
    whose modeled step is at most 1.05 x the measured one.  Logs the
    loop's own cost, each snapshot's size and seconds, the time to
    recover and the peak device memory.  ``record(name, compiled,
    launches)`` makes each kernel's entry of the kernels line; returns
    the entries."""
    import torch

    from repro_torch import api, obs
    from repro_torch.api import Target
    from repro_torch.checkpoint import global_stats
    from repro_torch.core.passes.decompose import make_strategy_2d
    from repro_torch.dist import Mesh, ShardedTensor, gather
    from repro_torch.kernels import reset_dispatch_stats
    from repro_torch.kernels.graphs import GraphCensus
    from repro_torch.resilience import FaultPlan, ResilientLoop, SimulatedFault, resume

    t12 = time.perf_counter()
    on_card = dev.type == "cuda"
    log(f"phase 12: checkpoint and resilience (repro_torch.resilience), {steps} steps a run, "
        f"a snapshot every epoch, keep_last={keep_last}; {card}")
    graphed = {"backend": "cuda", "jit": True, "donate": True}
    grid = {"mesh": Mesh([[dev, dev], [dev, dev]], ("x", "y")),
            "strategy": make_strategy_2d((2, 2))}
    fused = {"exchange_every": 4, "fused_epoch": True}
    A = Target(device=str(dev), **fused, **graphed)
    B = Target(**fused, **graphed, **grid)
    C = Target(**graphed, **grid)
    D = Target(device=str(dev), **graphed)  # k=1, one device
    label = {A.fingerprint: "A", B.fingerprint: "B", C.fingerprint: "C", D.fingerprint: "D"}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    first = {p: tuple(torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                      for f in p.input_fields) for p in (heat, wave)}
    gib = {p: sum(x.numel() * x.element_size() for x in s) / 2**30 for p, s in first.items()}
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held_before = torch.cuda.memory_allocated(dev) / 2**30

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def owned(state):
        """The state as global tensors that no ring holds."""
        return tuple(gather(x) if isinstance(x, ShardedTensor) else x.clone() for x in state)

    def bitwise(what, got, want):
        diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)),
              f"phase 12, {what}: differs (max |diff| {diff})")
        log(f"  {what}: bitwise equal")

    legs: list = []  # (target label, epochs, K1 and K2 launches) of each loop of the current run
    launches: dict = {}  # (program, target fingerprint) -> kernel launches counted in each loop
    saves: dict = {}  # (program, blocking or async) -> [(GiB, Checkpointer.last_save, blocked s)]
    short = {heat: "heat", wave: "wave"}

    def drive(loop, what):
        """Drive ``loop`` epoch by epoch to its end or its injected fault,
        with the graph counts zeroed when it starts and read when it ends;
        returns (final state or None, seconds of its first epoch without
        that epoch's save)."""
        e0 = loop.epoch
        first_s, ring = None, None
        got = None
        api.reset_graph_stats()
        while not loop.done:
            n_ev = len(loop.events)
            t0 = time.perf_counter()
            try:
                loop.advance_epoch()
            except SimulatedFault:
                break
            if first_s is None:
                sync()
                first_s = time.perf_counter() - t0 - sum(
                    ev[2] for ev in loop.events[n_ev:] if ev[0] == "checkpoint")
                ring = loop.compiled._ring
                check(ring is not None, f"{what}: no ring after the first epoch")
            if loop.checkpointer is not None and loop.events[-1][0] == "checkpoint":
                kind = (short[loop.program], "async" if loop.async_saves else "blocking")
                saves.setdefault(kind, []).append(
                    (gib[loop.program], loop.checkpointer.last_save, loop.events[-1][2]))
        else:
            got = loop.state
        if loop.checkpointer is not None:
            loop.checkpointer.wait()
        sync()
        stats = api.graph_stats()
        nodes = GraphCensus(dict(stats.kernel_nodes))
        check(loop.compiled._ring is ring,
              f"{what}: the compiled step built a new ring mid-run (a snapshot held the ring)")
        st, epochs = loop.compiled, loop.epoch - e0
        ranks = st.target.spatial_ranks if st.target.distributed else 1
        k1 = epochs * ranks * len(st.kernel_applies())
        k2 = epochs * ranks * len(st.kernel_epochs())
        caps = min(epochs, ring.phases)
        check((nodes.k1, nodes.k2) == (k1, k2),
              f"{what}: the replayed graphs ran {nodes.k1} K1 and {nodes.k2} K2 launches, "
              f"expected {k1} and {k2}")
        check(stats.replays == epochs and stats.captures == caps,
              f"{what}: {stats.replays} replays and {stats.captures} captures, expected "
              f"{epochs} and {caps} (one capture per rotation phase the ring reached)")
        key = (loop.program, st.target.fingerprint)
        launches[key] = launches.get(key, 0) + (nodes.k2 if st.kernel_epochs() else nodes.k1)
        legs.append((label[st.target.fingerprint], epochs, nodes.k1, nodes.k2, caps))
        if got is None:  # the process died: its compiled step and ring go with it
            api.forget(loop.program, loop.target)
        return got, first_s

    def start_run(prog, *targets):
        """Each target compiled anew (graphs and ring too)."""
        legs.clear()
        for t in targets:
            api.forget(prog, t)
        reset_dispatch_stats()

    def end_run(what, prog, *targets):
        log(f"  {what}: " + "; ".join(
            f"{t} {e} epochs, {n1} K1 and {n2} K2 launches, {c} captures"
            for t, e, n1, n2, c in legs)
            + " (launches counted from each loop's replayed graphs' nodes)")
        for t in targets:  # the run is over: its rings go
            api.forget(prog, t)

    def recovery(what, loop, first_s):
        t = loop.timings
        total = t["restore_s"] + t["place_s"] + t["compile_s"] + first_s
        log(f"  {what}: time to recover {total:.3f} s = restore {t['restore_s']:.3f} + placement "
            f"{t['place_s']:.3f} + compile {t['compile_s']:.3f} + first epoch (eager run, "
            f"capture, replay) {first_s:.3f}; {card}")

    root = tempfile.mkdtemp(prefix="repro-torch-ckpt-")
    try:
        need = max((keep_last + 1) * gib[wave], (keep_last + 2) * gib[heat]) + 1.0
        free = shutil.disk_usage(root).free / 2**30
        check(free >= need, f"phase 12 needs {need:.1f} GiB of free disk under {root} for its "
              f"snapshots, {free:.1f} GiB free")
        log(f"  snapshots under {root}: {free:.1f} GiB free, {need:.1f} GiB needed")
        runs = iter(range(1, 100))

        def new_dir():
            return os.path.join(root, f"run{next(runs)}")

        def loop_of(prog, target, d, **kw):
            return ResilientLoop(prog, target, first[prog], steps, directory=d,
                                 checkpoint_every=1, keep_last=keep_last, **kw)

        # 1. uninterrupted heat on A
        start_run(heat, A)
        d = new_dir()
        out, _ = drive(loop_of(heat, A, d), "heat on A, blocking saves")
        end_run("run 1, heat uninterrupted on A", heat, A)
        ref = owned(out)
        del out
        shutil.rmtree(d)
        bitwise("run 1 (ResilientLoop on A) vs compile(A).time_loop",
                owned(api.compile(heat, A).time_loop(first[heat], steps)), ref)
        no_jit = Target(device=str(dev), backend="cuda", **fused, jit=False)
        bitwise("run 1 vs jit=False", owned(api.compile(heat, no_jit).time_loop(first[heat], steps)),
                ref)
        # 1b. the same with async saves
        start_run(heat, A)
        d = new_dir()
        out, _ = drive(loop_of(heat, A, d, async_saves=True), "heat on A, async saves")
        end_run("run 1b, heat uninterrupted on A, async saves", heat, A)
        bitwise("run 1b (async saves) vs run 1", owned(out), ref)
        del out
        shutil.rmtree(d)

        # 2. heat killed on A at epoch 2, resumed on B
        start_run(heat, A, B)
        d = new_dir()
        loop = loop_of(heat, A, d, fault_plan=FaultPlan(kill_at_epoch=2))
        drive(loop, "heat killed on A")
        check(loop.step_count == 8, f"run 2 killed at step {loop.step_count}, expected 8")
        del loop
        loop = resume(heat, d, B, keep_last=keep_last)
        out, first_s = drive(loop, "heat resumed on B")
        recovery("run 2, heat resumed on B from step 8", loop, first_s)
        end_run("run 2, heat killed on A at epoch 2, resumed on B", heat, A, B)
        bitwise("run 2 (A -> B) vs run 1", owned(out), ref)
        del loop, out
        shutil.rmtree(d)

        # 3. heat killed on C at epoch 8, resumed on A
        start_run(heat, C, A)
        d = new_dir()
        loop = loop_of(heat, C, d, fault_plan=FaultPlan(kill_at_epoch=8))
        drive(loop, "heat killed on C")
        check(loop.step_count == 8, f"run 3 killed at step {loop.step_count}, expected 8")
        del loop
        loop = resume(heat, d, A, keep_last=keep_last)
        out, first_s = drive(loop, "heat resumed on A")
        recovery("run 3, heat resumed on A from step 8", loop, first_s)
        end_run("run 3, heat killed on C (k=1) at epoch 8, resumed on A (k=4)", heat, C, A)
        bitwise("run 3 (C -> A) vs run 1", owned(out), ref)
        del loop, out
        shutil.rmtree(d)

        # 4. wave: uninterrupted on A, then killed on A at epoch 1, resumed on B
        start_run(wave, A)
        d = new_dir()
        out, _ = drive(loop_of(wave, A, d), "wave on A, blocking saves")
        end_run("run 4a, wave uninterrupted on A", wave, A)
        wave_ref = owned(out)
        del out
        shutil.rmtree(d)
        bitwise("run 4a (wave ResilientLoop on A) vs compile(A).time_loop",
                owned(api.compile(wave, A).time_loop(first[wave], steps)), wave_ref)
        start_run(wave, A, B)
        d = new_dir()
        loop = loop_of(wave, A, d, fault_plan=FaultPlan(kill_at_epoch=1))
        drive(loop, "wave killed on A")
        phase = loop._phase
        del loop
        loop = resume(wave, d, B, keep_last=keep_last)
        check(loop.step_count == 4 and loop._phase == phase,
              f"run 4 resumed at step {loop.step_count}, phase {loop._phase}; expected 4, {phase}")
        out, first_s = drive(loop, "wave resumed on B")
        recovery(f"run 4, wave resumed on B from step 4 (rotation phase {phase})", loop, first_s)
        end_run("run 4, wave killed on A at epoch 1, resumed on B", wave, A, B)
        bitwise("run 4 (wave A -> B) vs run 4a", owned(out), wave_ref)
        del loop, out
        shutil.rmtree(d)

        # 4b. wave at k=1 killed on C at an odd epoch (rotation phase 1),
        # one snapshot (at step 5), resumed on D without snapshots
        start_run(wave, C, D)
        d = new_dir()
        loop = ResilientLoop(wave, C, first[wave], steps, directory=d, checkpoint_every=5,
                             keep_last=keep_last, fault_plan=FaultPlan(kill_at_epoch=5))
        drive(loop, "wave killed on C")
        del loop
        loop = resume(wave, d, D, checkpoint_every=0)
        check(loop.step_count == 5 and loop._phase == 1,
              f"run 4b resumed at step {loop.step_count}, phase {loop._phase}; expected 5, 1")
        out, first_s = drive(loop, "wave resumed on D")
        recovery("run 4b, wave resumed on D from step 5 (rotation phase 1)", loop, first_s)
        end_run("run 4b, wave k=1 killed on C at epoch 5, resumed on D (one device)", wave, C, D)
        bitwise("run 4b (wave C -> D, k=1) vs run 4a (k=4 fused)", owned(out), wave_ref)
        del loop, out, wave_ref
        shutil.rmtree(d)

        # 5. a torn snapshot: step 8 commits, is torn, and the run dies
        start_run(heat, A)
        d = new_dir()
        loop = loop_of(heat, A, d, fault_plan=FaultPlan(truncate_step=8, kill_at_epoch=2))
        drive(loop, "heat on A, torn at step 8")
        del loop
        gcs = global_stats().gcs
        loop = resume(heat, d, A, keep_last=keep_last)
        gcs = global_stats().gcs - gcs
        check(loop.step_count == 4 and gcs == 1,
              f"run 5 resumed at step {loop.step_count} after {gcs} startup GCs, expected 4 and 1")
        out, first_s = drive(loop, "heat resumed on A after a torn snapshot")
        recovery("run 5, heat resumed on A from step 4 (step 8 torn, 1 GC)", loop, first_s)
        end_run("run 5, heat torn at step 8 and killed on A, resumed on A", heat, A)
        bitwise("run 5 (torn snapshot) vs run 1", owned(out), ref)
        del loop, out
        shutil.rmtree(d)

        for (what, mode), rows in saves.items():
            size = rows[0][0]
            host = sorted(r[1]["to_host_s"] for r in rows)
            write = sorted(r[1]["write_s"] for r in rows)
            blocked = sorted(r[2] for r in rows)
            mid = len(rows) // 2
            log(f"  {mode} snapshots of {what}: {len(rows)} of {size:.3f} GiB; device to host (gather + "
                f".cpu()) median {host[mid]:.3f} s [{host[0]:.3f}-{host[-1]:.3f}], write median "
                f"{write[mid]:.3f} s [{write[0]:.3f}-{write[-1]:.3f}], the loop blocked median "
                f"{blocked[mid]:.3f} s [{blocked[0]:.3f}-{blocked[-1]:.3f}] per snapshot; {card}")

        # ResilientLoop's own cost: no snapshots, beside time_loop
        n_long = 4 * steps
        step_a = api.compile(heat, A)
        step_a.time_loop(first[heat], n_long)  # captures the graphs
        times: dict = {"ResilientLoop(checkpoint_every=0)": [], "time_loop": []}
        for which in ["time_loop", "loop", "loop", "time_loop", "time_loop", "loop"]:
            if which == "loop":
                loop = ResilientLoop(heat, A, first[heat], n_long, checkpoint_every=0)
                times["ResilientLoop(checkpoint_every=0)"].append(_seconds(loop.run, dev))
                del loop
            else:
                times["time_loop"].append(
                    _seconds(lambda: step_a.time_loop(first[heat], n_long), dev))
        epochs = step_a.epochs(n_long)
        log(f"  heat on A, {n_long} steps ({epochs} epochs): " + ", ".join(
            f"{name} {sorted(ts)[1] / epochs * 1e3:.4f} ms/epoch [{min(ts) / epochs * 1e3:.4f}-"
            f"{max(ts) / epochs * 1e3:.4f}]" for name, ts in times.items())
            + f" (median [min-max] of 3 runs in turns, the state copied into the ring "
            f"once a run); {card}")

        # 7. traced epochs: heat k=1 on one device, the heat resilient loop on A
        traced = []
        obs.enable()
        try:
            # a traced epoch of each first: op by op, the allocator's first
            # requests of this route are not the epochs measured
            api.compile(heat, D).time_loop(first[heat], 1)
            api.compile(heat, A).time_loop(first[heat], A.exchange_every)
            obs.clear()
            api.compile(heat, D).time_loop(first[heat], 2)
            traced.append(("heat k=1, one device, time_loop", api.compile(heat, D), obs.spans()))
            obs.clear()
            d = new_dir()
            loop = ResilientLoop(heat, A, first[heat], 2 * A.exchange_every, directory=d,
                                 checkpoint_every=1, keep_last=keep_last)
            loop.run()
            traced.append(("heat k=4 fused on A, ResilientLoop", loop.compiled, obs.spans()))
            del loop
            shutil.rmtree(d)
        finally:
            obs.disable()
            obs.clear()
        for what, st, spans in traced:
            names = [s.name for s in spans]
            check(names.count("epoch") == 2, f"{what}: {names.count('epoch')} epoch spans")
            if "ResilientLoop" in what:
                check(names.count("checkpoint.save") == 2,
                      f"{what}: {names.count('checkpoint.save')} checkpoint.save spans")
            path = obs.write_chrome(os.path.join(root, f"trace_{len(os.listdir(root))}.json"), spans)
            rep = obs.drift_report(spans=spans, terms=st.cost())
            ranks = st.target.spatial_ranks if st.target.distributed else 1
            log(f"  traced {what}: {len(spans)} spans ({', '.join(sorted(set(names)))}) "
                f"written to {os.path.basename(path)}; {card}")
            for line in str(rep).splitlines():
                log("    " + line)
            check(rep.epochs == 2 and ranks * rep.modeled_step_s <= 1.05 * rep.measured_step_s,
                  f"{what}: the modeled step {rep.modeled_step_s} s of {ranks} rank(s) exceeds "
                  f"1.05 x the measured {rep.measured_step_s} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    records = []
    for prog, name in ((heat, "heat"), (wave, "wave")):
        for target in (A, B, C, D):
            n = launches.get((prog, target.fingerprint))
            if n:
                records.append(record(f"{name} {'x'.join(map(str, prog.field_args[0].type.bounds.shape))}"
                                      f" resilient on {label[target.fingerprint]}",
                                      api.compile(prog, target), n))
    for prog in (heat, wave):
        for target in (A, B, C, D, no_jit):
            api.forget(prog, target)
    if on_card:
        torch.cuda.empty_cache()
        log(f"  peak device memory of phase 12: "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, of which "
            f"{held_before:.2f} GiB were held before the phase began; {card}")
    sec = time.perf_counter() - t12
    log(f"phase 12: {sec:.1f} s")
    check(sec < 180, f"phase 12 took {sec:.1f} s, more than 180 s")
    return records


def oec_heat(shape, so=4, alpha=0.1, boundary="zero"):
    """Heat through the oec-like builder, as the serving tests build their
    programs: ``u + alpha * lap(u)``, the ``so``-th order Laplacian star at
    spacing 1 (``core.fd``), zero BC (or ``boundary``)."""
    from repro_torch.core.fd import laplacian_star
    from repro_torch.frontends.oec_like import ProgramBuilder

    star = sorted(laplacian_star(len(shape), so).items())
    pb = ProgramBuilder(f"heat_so{so}", shape)
    u, out = pb.input("u"), pb.output("out")

    def body(b, v):
        lap = sum((v.at(*off) * c for off, c in star[1:]), v.at(*star[0][0]) * star[0][1])
        return v.at(*(0,) * len(shape)) + lap * alpha

    pb.store(pb.apply([pb.load(u)], body), out)
    return pb.finish(boundary=boundary)


def oec_wave(shape, so=4, c2=0.1):
    """Wave through the oec-like builder: ``2 u - u_prev + c2 * lap(u)``,
    two time buffers (oldest first), zero BC."""
    from repro_torch.core.fd import laplacian_star
    from repro_torch.frontends.oec_like import ProgramBuilder

    star = sorted(laplacian_star(len(shape), so).items())
    pb = ProgramBuilder(f"wave_so{so}", shape)
    um, u0, out = pb.input("u_prev"), pb.input("u_now"), pb.output("u_next")

    def body(b, vm, v):
        lap = sum((v.at(*off) * c for off, c in star[1:]), v.at(*star[0][0]) * star[0][1])
        zero = (0,) * len(shape)
        return 2.0 * v.at(*zero) - vm.at(*zero) + lap * c2

    pb.store(pb.apply([pb.load(um), pb.load(u0)], body), out)
    return pb.finish(boundary="zero")


def serving_targets(dev, big=16384, small=1024) -> list:
    """``(label, program, target)`` of every pool phase 13 runs (main builds
    their kernels with the rest, all at once): the buckets H, W and K of
    case 1, the small tenants of case 2 (and case 4's heat), case 3's
    distributed bucket at slot width 1 and its 8-rank sibling."""
    from repro_torch.api import Target, pooled_target
    from repro_torch.core.passes.decompose import make_strategy_2d
    from repro_torch.dist import Mesh

    fused = {"backend": "cuda", "exchange_every": 4, "fused_epoch": True}
    grid = {"mesh": Mesh([[dev, dev], [dev, dev]], ("x", "y")),
            "strategy": make_strategy_2d((2, 2))}
    heat, wave, small_heat = oec_heat((big, big)), oec_wave((big, big)), oec_heat((small, small))
    on_grid = Target(**fused, **grid)
    return [
        ("H", heat, Target(device=str(dev), **fused)),
        ("W", wave, Target(device=str(dev), **fused)),
        ("K", heat, Target(device=str(dev), backend="cuda")),
        ("S", small_heat, Target(device=str(dev), backend="cuda")),
        ("D", heat, on_grid),
        ("D1", heat, pooled_target(on_grid, slots=1, devices=[dev])),
        ("D8", heat, pooled_target(on_grid, slots=2, devices=[dev] * 8)),
    ]


def serving_phase(dev, *, record, card="", big=16384, small=1024) -> list:
    """Phase 13: the stencil serving engine (``repro_torch.serve.stencil``)
    on ``dev``, driven through ``submit``/``step``/``run``:

    1. one engine, three full-width buckets: H (heat ``big``² so4, fused
       k=4, K2) in a pool of 4 with 6 requests of 16-48 steps (two queue;
       one streams a frame every 16 steps); W (wave, fused k=4) in a pool
       of 2 with 3 requests of 16 steps; K (heat k=1, K1) in a pool of 4
       with 4 requests of 16 steps;
    2. 32 small tenants (heat ``small``² so4 k=1, 64 steps each) arriving
       Poisson (mean 2 per engine step, ``default_rng(0)``) into a pool of
       16 warmed by an untimed request; then the same 32 requests solo,
       one after another;
    3. a distributed bucket: H's heat over a 2x2 mesh of this device in a
       pool of 2 (3 requests; the slot axis as wide as the inventory
       allows: 1 on one card), and ``pooled_target(.., slots=2, devices=
       [dev] * 8)`` compiled directly, 8 steps on ``[2, big, big]``;
    4. at ``small``²: an autoscaled burst (a grow, a shrink, retirement),
       then three requests (a frame every 8 steps) evacuated from one
       engine into a temporary directory and admitted by another.

    Raises unless: every result (resized, evacuated and admitted ones
    too) and every frame is bitwise the request's solo
    ``compile(program, target).time_loop``; each engine step's dispatch
    counters match the live slots it dispatched; every dispatch is one
    replay of its pool's graph, whose own kernel nodes are 1 K2 (H, W), 1
    K1 per apply (K, case 2), 4 K2 (case 3; 8 on the 8-rank sibling)
    however many slots are live, and each step's K1/K2 launches are those
    nodes; each pool width captures one graph per rotation phase it
    reached and keeps its ring; device memory falls back to within 64 MiB
    once a case's buckets have retired; ``obs.snapshot()`` shows the
    serve, checkpoint and kernel counts; the peak device memory stays
    under 60 GiB and the phase under 150 s (on the card).  ``record(name,
    compiled, launches, slots)`` makes a pooled kernel's entry of the
    kernels line; returns the entries."""
    import numpy as np
    import torch

    from repro_torch import api, obs
    from repro_torch.kernels import dispatch_stats
    from repro_torch.serve.stencil import PoolSizerConfig, StencilEngine, StencilEngineConfig

    t13 = time.perf_counter()
    on_card = dev.type == "cuda"
    log(f"phase 13: the serving engine (repro_torch.serve.stencil), heat and wave {big}^2 so4, "
        f"heat {small}^2 so4; {card}")
    targets = {label: (prog, t) for label, prog, t in serving_targets(dev, big, small)}
    heat, H = targets["H"]
    wave, W = targets["W"]
    _, K = targets["K"]
    small_heat, S = targets["S"]
    _, D = targets["D"]
    gen = torch.Generator(device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def state_of(prog, seed):
        """Request ``seed``'s initial state, made anew on the device."""
        gen.manual_seed(SEED + 1000 + seed)
        return tuple(torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                     for f in prog.input_fields)

    def allocated():
        if not on_card:
            return 0
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated(dev)

    def census(ring):
        """(K1, K2) nodes of one replay of a ring's graphs, as each graph's
        census read them (every rotation phase the same)."""
        counts = {(n.k1, n.k2) for _, n, _ in ring.graphs.values()}
        check(len(counts) == 1, f"phase 13: a pool's graphs hold {counts} K1/K2 nodes")
        return counts.pop()

    def solo_check(what, prog, target, seed, n_steps, got, frames=()):
        """``got``, and each frame at its step, bitwise the solo run of
        request ``seed``; the solo artifact's graphs are released after."""
        solo = api.compile(prog, target)
        state, done = state_of(prog, seed), 0
        for f in frames:
            if f.step > done:
                state = solo.time_loop(state, f.step - done)
                done = f.step
            check(all(np.array_equal(a, x.cpu().numpy()) for a, x in zip(f.arrays, state)),
                  f"phase 13, {what}: the frame at step {f.step} differs from the solo run")
        want = solo.time_loop(state, n_steps - done) if n_steps > done else state
        diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)),
              f"phase 13, {what}: differs from its solo time_loop (max |diff| {diff})")
        solo.release_graphs()

    class Tally:
        """What the engine steps of one case did, per bucket (``names``:
        bucket key -> label): its dispatches, their live slots, its K1/K2
        launches, its rings (one per pool width); and the host's seconds
        per engine step beside the dispatches.  A dispatch replays one
        graph of its pool's ring; on the card the first dispatch of each
        rotation phase also runs the phase once eagerly before capturing it,
        so its launches count twice."""

        def __init__(self, engine, names):
            self.engine, self.names = engine, names
            self.dispatches, self.live, self.launches, self.rings = {}, {}, {}, {}
            self.graphs_seen, self.eager = {}, {}
            self.host, self.wall, self.captures = [], 0.0, 0

        def step(self):
            eng = self.engine
            working = [k for k, g in eng.scheduler.groups.items() if g.active or g.queue]
            # live slots of each dispatch: admission fills the free slots
            # from the queue first (a resize may change the width: then one
            # bucket works, and the step's live count is its own)
            going = {k: len(g.active) + min(len(g.free), len(g.queue))
                     for k, g in eng.scheduler.groups.items() if k in working}
            before, g0 = dispatch_stats().as_dict(), api.graph_stats()
            replays0, captures0 = g0.replays, g0.captures
            t0 = time.perf_counter()
            m = eng.step()
            dt = time.perf_counter() - t0
            self.wall += dt
            after, gs = dispatch_stats().as_dict(), api.graph_stats()
            if eng.sizer is not None:
                check(len(working) <= 1, "phase 13: an autoscaled step of several buckets")
                going = {k: m.live_slots for k in working}
            check(m.live_slots == sum(going.values())
                  and m.batched_dispatches == sum(v >= 2 for v in going.values())
                  and m.solo_dispatches == sum(v == 1 for v in going.values()),
                  f"phase 13: step {m.engine_step}: {m.live_slots} live slots, "
                  f"{m.batched_dispatches} batched and {m.solo_dispatches} solo dispatches for "
                  f"the live slots {sorted(going.values())}")
            check(gs.replays - replays0 == len(going),
                  f"phase 13: {gs.replays - replays0} graph replays for {len(going)} dispatches")
            want, seconds = [0, 0], 0.0
            for key, n in going.items():
                group, name = eng.scheduler.groups[key], self.names[key]
                pool = group.executable
                ring = pool._ring
                # one ring for the life of each pool executable (one a width)
                new = (name, id(pool)) not in self.rings
                seen = self.rings.setdefault((name, id(pool)), (pool, group.capacity, ring))
                check(seen[2] is ring,
                      f"phase 13, {name}: the pool's ring was replaced at width {group.capacity}")
                captured = len(ring.graphs) - (0 if new else self.graphs_seen[id(ring)])
                self.graphs_seen[id(ring)] = len(ring.graphs)
                per = census(ring)
                runs = 1 + (captured if on_card else 0)  # the replay, and eager runs
                nodes = (per[0] * runs, per[1] * runs)
                want = [want[0] + nodes[0], want[1] + nodes[1]]
                self.dispatches[name] = self.dispatches.get(name, 0) + 1
                self.live.setdefault(name, []).append(n)
                done = self.launches.get(name, (0, 0))
                self.launches[name] = (done[0] + nodes[0], done[1] + nodes[1])
                self.eager[name] = self.eager.get(name, 0) + runs - 1
                seconds += eng.metrics.step_seconds[f"{key[0]}/{key[1]}"][-1]
            got = [after["apply_launches"] - before["apply_launches"],
                   after["fused_epoch_launches"] - before["fused_epoch_launches"]]
            check(got == want, f"phase 13: step {m.engine_step} launched K1 {got[0]} and K2 "
                  f"{got[1]} times; the graphs it replayed hold {want[0]} and {want[1]} nodes")
            self.captures += gs.captures - captures0
            self.host.append(dt - seconds)
            return m

        def finish(self, per_dispatch, work):
            """Check each bucket's launches per dispatch (``per_dispatch``:
            label -> (K1, K2) nodes) and the captures (one per rotation
            phase a pool width reached); log each bucket's latencies and
            GPts/s (``work``: label -> points x steps of its requests)."""
            for name, per in per_dispatch.items():
                d = self.dispatches[name] + self.eager[name]
                check(self.launches[name] == (per[0] * d, per[1] * d),
                      f"phase 13, bucket {name}: K1/K2 launches {self.launches[name]} for "
                      f"{self.dispatches[name]} dispatches and {self.eager[name]} eager runs of "
                      f"{per} nodes each")
            graphs = [(name, width, len(r.graphs), r.phases)
                      for (name, _), (_, width, r) in self.rings.items()]
            check(self.captures == sum(g[2] for g in graphs)
                  and all(1 <= g[2] <= g[3] for g in graphs),
                  f"phase 13: {self.captures} captures; the pools' rings hold (bucket, width, "
                  f"graphs, rotation phases) {graphs}")
            lat = self.engine.metrics.step_latency()
            for key, name in self.names.items():
                if name not in self.dispatches:
                    continue
                stats = lat[f"{key[0]}/{key[1]}"]
                log(f"  bucket {name}: {self.dispatches[name]} pooled dispatches ("
                    f"{self.eager[name]} of them also ran eagerly before a capture; live slots "
                    f"{min(self.live[name])}..{max(self.live[name])}), p50 "
                    f"{stats['p50_s'] * 1e3:.3f} ms, p99 {stats['p99_s'] * 1e3:.3f} ms a dispatch, "
                    f"{work[name] / 1e9 / (stats['mean_s'] * stats['count']):.3f} GPts/s over its "
                    f"dispatches, K1/K2 launches {self.launches[name]} "
                    f"(graph nodes {per_dispatch[name]} a dispatch)")
            host = sorted(self.host)
            log(f"  host: {1e3 * host[len(host) // 2]:.3f} ms per engine step beside the dispatches "
                f"(median; mean {1e3 * sum(host) / len(host):.3f} ms, frames and results copied "
                f"out included; {len(host)} steps, {self.wall:.3f} s stepping); captures (bucket, "
                f"width, graphs, rotation phases) {graphs}")

    def enqueue(engine, jobs, label, prog, target, seed, n_steps, **kw):
        """Submit request ``seed`` (its state made on the device) and file
        its handle under its rid in ``jobs``; nothing else keeps it."""
        h = engine.submit(prog, state_of(prog, seed), n_steps, target=target, **kw)
        jobs[h.rid] = (label, prog, target, seed, n_steps, h)

    def bucket_names(**by_label):
        """Bucket key -> label, for ``label=(program, target)``."""
        return {(p.fingerprint, t.fingerprint): label for label, (p, t) in by_label.items()}

    def retire_all(engine, tally):
        for _ in range(engine.config.bucket_idle_steps + 1):
            if not engine.scheduler.groups:
                break
            tally.step()
        check(not engine.scheduler.groups, "phase 13: a drained bucket did not retire")

    def run_checked(engine, tally, jobs, arrivals=()):
        """Step ``engine`` until every job finished, submitting each of
        ``arrivals`` ((engine step, submit)) at its step; each finished
        request is checked against its solo run as it finishes, and the
        engine's copy of its result dropped (the tenant has it)."""
        arrivals, i = list(arrivals), 0
        while engine.pending or arrivals:
            while arrivals and arrivals[0][0] <= i:
                arrivals.pop(0)[1]()
            tally.step()
            i += 1
            for req in list(engine.finished):
                label, prog, target, seed, n, h = jobs.pop(req.rid)
                solo_check(f"{label} request {req.rid} ({n} steps)", prog, target, seed, n,
                           h.result(), list(h.frames()))
                engine.finished.remove(req)
        check(not jobs, f"phase 13: requests {sorted(jobs)} never finished")

    records = []
    gib = 2**30

    # -- case 1: three full-width buckets in one engine -------------------------
    mem0 = allocated()
    eng = StencilEngine(StencilEngineConfig(slots_per_group=4, bucket_idle_steps=1))
    eng.scheduler.group_for(api.compile(wave, W), capacity=2)  # W's pool of 2
    jobs, seed = {}, 0
    plan = [("H", heat, H, n) for n in (16, 32, 32, 48, 16, 32)]
    plan += [("W", wave, W, 16)] * 3 + [("K", heat, K, 16)] * 4
    for label, prog, target, n in plan:
        enqueue(eng, jobs, label, prog, target, seed, n, tenant=label,
                frame_every=16 if (label, n) == ("H", 48) else 0)
        seed += 1
    tally = Tally(eng, bucket_names(H=(heat, H), W=(wave, W), K=(heat, K)))
    t0 = time.perf_counter()
    run_checked(eng, tally, jobs)
    retire_all(eng, tally)
    tally.finish({"H": (0, 1), "W": (0, 1), "K": (1, 0)},
                 {"H": 176 * big * big, "W": 48 * big * big, "K": 64 * big * big})
    check(len(set(tally.live["H"])) > 1, "phase 13: bucket H always had the same live slots")
    log(f"  case 1: {time.perf_counter() - t0:.2f} s with the solo checks; "
        f"{(176 + 48 + 64) * big * big / 1e9 / tally.wall:.3f} GPts/s over the engine's steps")
    launches = dict(tally.launches)
    del eng, tally
    mem1 = allocated()
    check(abs(mem1 - mem0) <= 64 * 2**20,
          f"phase 13, case 1: {mem1 / 2**20:.1f} MiB allocated after its buckets retired, "
          f"{mem0 / 2**20:.1f} MiB before their first request")
    records += [record(f"{what} {big}x{big}, serving pool of {slots}", api.compile(prog, t),
                       sum(launches[name]), slots)
                for name, what, prog, t, slots in (
                    ("H", "heat2d_so4 k=4 fused", heat, H, 4),
                    ("W", "wave2d_so4 k=4 fused", wave, W, 2),
                    ("K", "heat2d_so4 k=1", heat, K, 4))]

    # -- case 2: many small tenants, then the same requests solo ----------------
    arrive = np.cumsum(np.random.default_rng(0).exponential(1.0 / 2.0, size=32))
    eng = StencilEngine(StencilEngineConfig(slots_per_group=16, bucket_idle_steps=1))
    handles = []

    def submitter(j):
        def go():
            handles.append(eng.submit(small_heat, state_of(small_heat, 100 + j), 64, target=S,
                                      tenant=f"small{j}"))
        return go

    tally = Tally(eng, bucket_names(S=(small_heat, S)))
    # untimed warm-up: one request of 4 steps builds the pool of 16's
    # executable and captures both of its rotation phases, as the solo
    # loop's warm-up below captures its own
    jobs = {}
    enqueue(eng, jobs, "S", small_heat, S, 99, 4, tenant="warm-up")
    run_checked(eng, tally, jobs)
    wall0, steps0, k1_0 = tally.wall, len(tally.host), tally.launches["S"][0]
    live0 = len(tally.live["S"])
    bucket = "/".join(next(iter(eng.scheduler.groups)))
    dispatches0 = len(eng.metrics.step_seconds[bucket])
    arrivals = [(int(a), submitter(j)) for j, a in enumerate(arrive)]
    snap_a = obs.snapshot()
    i = 0
    while eng.pending or arrivals:
        while arrivals and arrivals[0][0] <= i:
            arrivals.pop(0)[1]()
        tally.step()
        i += 1
    snap_b = obs.snapshot()
    pooled_s = tally.wall - wall0
    window = sorted(list(eng.metrics.step_seconds[bucket])[dispatches0:])
    live = tally.live["S"][live0:]
    retire_all(eng, tally)
    work = 32 * 64 * small * small
    tally.finish({"S": (1, 0)}, {"S": work + 4 * small * small})
    for ns, key in (("kernel", "apply_launches"), ("serve", "requests_completed"),
                    ("serve", "batched_dispatches")):
        log(f"  obs.snapshot() {ns}.{key}: +{snap_b[ns][key] - snap_a[ns][key]}")
    check(snap_b["kernel"]["apply_launches"] - snap_a["kernel"]["apply_launches"]
          == tally.launches["S"][0] - k1_0, "phase 13: obs.snapshot()'s K1 launches are not the "
          "graph census of the engine's steps")
    check(snap_b["serve"]["requests_completed"] - snap_a["serve"]["requests_completed"] == 32,
          "phase 13: obs.snapshot() does not count the 32 completed requests")
    solo = api.compile(small_heat, S)
    states = [state_of(small_heat, 100 + j) for j in range(32)]
    solo.time_loop(states[0], 64)  # warm-up: the solo ring's graphs
    t0 = time.perf_counter()
    solos = [solo.time_loop(s, 64) for s in states]
    if on_card:
        torch.cuda.synchronize(dev)
    solo_s = time.perf_counter() - t0
    for h, want in zip(handles, solos):
        check(all(torch.equal(g, w) for g, w in zip(h.result(), want)),
              f"phase 13, small request {h.rid}: differs from its solo time_loop")
    log(f"  case 2: 32 requests of 64 steps at {small}^2, Poisson arrivals (2 per engine step), "
        f"after an untimed warm-up request: pooled {work / 1e9 / pooled_s:.3f} GPts/s "
        f"({pooled_s:.3f} s of engine steps, {len(tally.host) - steps0} steps; dispatch p50 "
        f"{1e3 * window[len(window) // 2]:.4f} ms, p99 "
        f"{1e3 * window[min(len(window) - 1, int(0.99 * len(window)))]:.4f} ms over "
        f"{len(window)} dispatches, {sum(window):.4f} s in all, the rest of the steps host work; "
        f"{sum(live) / len(live):.2f} live slots a dispatch), solo one after another {work / 1e9 / solo_s:.3f} GPts/s "
        f"({solo_s:.3f} s, {1e3 * solo_s / (32 * 64):.4f} ms a step); "
        f"{pooled_s and solo_s / pooled_s:.2f}x")
    launches_s = sum(tally.launches["S"])
    del eng, tally, handles, solos, states
    solo.release_graphs()
    records.append(record(f"heat2d_so4 k=1 {small}x{small}, serving pool of 16",
                          api.compile(small_heat, S), launches_s, 16))

    # -- case 3: a distributed bucket, and an 8-rank slot-axis sibling -----------
    mem0 = allocated()
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2, bucket_idle_steps=1))
    jobs = {}
    for j in range(3):
        enqueue(eng, jobs, "D", heat, D, 200 + j, 16, tenant=f"grid{j}")
    tally = Tally(eng, bucket_names(D=(heat, D)))
    run_checked(eng, tally, jobs)
    (group,) = eng.scheduler.groups.values()
    width = group.executable.target.mesh.shape["slot"]
    check(width == 1, f"phase 13: a slot axis of {width} on one card")
    retire_all(eng, tally)
    tally.finish({"D": (0, 4)}, {"D": 48 * big * big})
    launches_d = sum(tally.launches["D"])
    del eng, tally, group
    mem1 = allocated()
    check(abs(mem1 - mem0) <= 64 * 2**20,
          f"phase 13, case 3: {mem1 / 2**20:.1f} MiB allocated after its bucket retired, "
          f"{mem0 / 2**20:.1f} MiB before its first request")
    records.append(record(f"heat2d_so4 k=4 fused {big}x{big} per rank of 2x2, serving pool of 2",
                          api.compile(heat, targets["D1"][1]), launches_d, 2))
    wide = api.compile(heat, targets["D8"][1])
    pool = torch.stack([state_of(heat, 300 + j)[0] for j in range(2)])
    wide.time_loop((pool,), 8)  # warm-up: every rotation phase captured
    before = dispatch_stats().as_dict()
    (out,) = wide.time_loop((pool,), 8)
    k2n = dispatch_stats().fused_epoch_launches - before["fused_epoch_launches"]
    check(census(wide._ring) == (0, 8) and k2n == 16,
          f"phase 13: the 8-rank slot-axis sibling launched K2 {k2n} times in 2 epochs, its "
          f"graph holds {census(wide._ring)} K1/K2 nodes")
    solo = api.compile(heat, D)
    for j in range(2):
        (want,) = solo.time_loop((pool[j],), 8)
        check(torch.equal(out[j], want), f"phase 13: slot {j} of the 8-rank sibling differs")
    log(f"  case 3: 3 requests on a 2x2 mesh in a pool of 2 (slot axis {width}), and "
        f"pooled_target(slots=2, devices=[card] * 8) on [2, {big}, {big}]: 8 K2 nodes a replay, "
        "bitwise per slot")
    wide.release_graphs()
    solo.release_graphs()
    del pool, out, want

    # -- case 4: an autoscaled burst, then migration between engines -------------
    ckpt0 = obs.snapshot()["checkpoint"]["saves"]
    eng = StencilEngine(StencilEngineConfig(
        slots_per_group=2, bucket_idle_steps=4,
        autoscale=PoolSizerConfig(min_capacity=1, max_capacity=16, ewma_alpha=1.0,
                                  cooldown_steps=1)))
    resize_s = []
    resize = eng.resize_bucket

    def timed_resize(*a, **k):
        t0 = time.perf_counter()
        resize(*a, **k)
        resize_s.append(time.perf_counter() - t0)

    eng.resize_bucket = timed_resize
    jobs = {}
    for j, n in enumerate([8] * 11 + [96]):
        enqueue(eng, jobs, "burst", small_heat, S, 400 + j, n, tenant=f"burst{j}")
    tally = Tally(eng, bucket_names(S=(small_heat, S)))
    run_checked(eng, tally, jobs)
    retire_all(eng, tally)
    snap = eng.metrics.snapshot()
    auto = snap["autoscale"]
    check(auto["grows"] >= 1 and auto["shrinks"] >= 1, f"phase 13: autoscale {auto}")
    for event in auto["events"]:
        missing = {"action", "from_capacity", "to_capacity", "queue_depth", "queue_ewma",
                   "utilization_ewma"} - set(event)
        check(not missing, f"phase 13: an autoscale event without {missing}")
    check(snap["buckets_retired"] == 1, "phase 13: the drained burst bucket did not retire")
    tally.finish({"S": (1, 0)}, {"S": (11 * 8 + 96) * small * small})
    drained = eng.metrics.requests_evacuated
    log(f"  case 4: {auto['grows']} grows and {auto['shrinks']} shrinks ("
        + ", ".join(f"{e['from_capacity']}->{e['to_capacity']}" for e in auto["events"])
        + f"), each resize {min(resize_s):.4f}-{max(resize_s):.4f} s (drain {drained} requests "
        "to checkpoints, rebuild, readmit)")
    del eng, tally
    first = StencilEngine(StencilEngineConfig(slots_per_group=2))
    hops = []
    for j in range(3):
        hops.append((first.submit(small_heat, state_of(small_heat, 500 + j), 32, target=S,
                                  frame_every=8), 500 + j))
    for _ in range(10):
        first.step()
    before_hop = [list(h.frames()) for h, _ in hops]
    d = tempfile.mkdtemp(prefix="repro-torch-evacuate-")
    try:
        t0 = time.perf_counter()
        evacuated = first.evacuate(small_heat.fingerprint, d)
        evac_s = time.perf_counter() - t0
        second = StencilEngine(StencilEngineConfig(slots_per_group=2))
        t0 = time.perf_counter()
        admitted = second.admit_evacuated(d, small_heat)
        admit_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check([r.steps_done for r in evacuated] == [10, 10, 0]
          and [h.steps_done for h in admitted] == [10, 10, 0],
          f"phase 13: evacuated at {[r.steps_done for r in evacuated]}, admitted at "
          f"{[h.steps_done for h in admitted]}")
    second.run()
    for (h0, s), h, early in zip(hops, admitted, before_hop):
        frames = early + list(h.frames())
        steps = [f.step for f in frames]
        check(steps == [8, 16, 24, 32], f"phase 13: frames across the hop at {steps}")
        solo_check(f"migrated request {h0.rid}", small_heat, S, s, 32, h.result(), frames)
    snap_c = obs.snapshot()
    saves = snap_c["checkpoint"]["saves"] - ckpt0
    check(saves == drained + 3, f"phase 13: {saves} checkpoint saves, expected {drained} resize "
          "drains + 3 evacuations")
    check(snap_c["serve"]["engines"] >= 2 and snap_c["serve"]["requests_evacuated"] >= 3
          and snap_c["serve"]["requests_resumed"] >= 3,
          f"phase 13: obs.snapshot()['serve'] = {snap_c['serve']}")
    log(f"  case 4: 3 requests evacuated in {evac_s:.4f} s, admitted in {admit_s:.4f} s, "
        "bitwise, frames 8, 16, 24, 32 across the hop; obs.snapshot() checkpoint.saves "
        f"+{saves}, serve {snap_c['serve']}")
    del first, second, hops, admitted, evacuated
    solo = api.compile(small_heat, S)
    solo.release_graphs()
    check(obs.snapshot()["compile"]["cache_capacity"] == api.cache_capacity(),
          "phase 13: obs.snapshot()'s cache capacity")

    sec = time.perf_counter() - t13
    if on_card:
        peak = torch.cuda.max_memory_allocated(dev) / gib
        log(f"  peak device memory of phase 13: {peak:.2f} GiB; {card}")
        check(peak < 60, f"phase 13: peak device memory {peak:.2f} GiB, not under 60 GiB")
    log(f"phase 13: {sec:.1f} s")
    if on_card:
        check(sec < 150, f"phase 13 took {sec:.1f} s, more than 150 s")
    return records


# -- phase 14: the language-model serving engine ---------------------------

LM_MAIN = "qwen2-7b"
NEAR_TIE = 1e-3  # a top-two logit margin under this is a near-tie


def solo_greedy(params, cfg, prompt, n_new, max_len, dev):
    """One request alone: ``forward_prefill``, ``grow_cache``, then
    ``decode_step`` token by token (``tests/test_serve.py``'s
    ``_reference_greedy``).  Returns ``(tokens, first_logits, margins)``:
    the greedy tokens, the logits of the first, and each step's top-two
    logit margin."""
    import torch

    from repro_torch.models import lm

    v = cfg.vocab_size
    logits, cache = lm.forward_prefill(params, cfg, torch.tensor([prompt], device=dev),
                                       q_chunk=min(len(prompt), 512))
    cache = lm.grow_cache(cfg, cache, max_len, len(prompt))
    first = logits[0, :v].float().cpu()
    toks, margins = [], []
    pos = len(prompt)
    for i in range(n_new):
        row = logits[0, :v].float()
        top = torch.topk(row, 2).values
        margins.append(float(top[0] - top[1]))
        toks.append(int(torch.argmax(row)))
        if i == n_new - 1:
            break
        logits, cache = lm.decode_step(params, cfg, torch.tensor([toks[-1]], device=dev), pos, cache)
        pos += 1
    return toks, first, margins


def same_as_solo(label, got, solo) -> str:
    """``got`` equals the solo run's tokens, or first differs where the solo
    run's top-two margin is a near-tie (then nothing after it is
    compared); any other difference fails.  Returns what was found."""
    toks, _, margins = solo
    check(len(got) == len(toks), f"{label}: {len(got)} tokens, its solo run {len(toks)}")
    for i, (g, s) in enumerate(zip(got, toks)):
        if g != s:
            check(margins[i] < NEAR_TIE,
                  f"{label}: token {i} is {g}, its solo run's {s} (top-two margin "
                  f"{margins[i]:.3g}, not a near-tie under {NEAR_TIE})")
            return (f"token {i} differs at a near-tie (solo top-two margin {margins[i]:.3g}); "
                    f"not compared further")
    return "every token equals its solo run"


def lm_phase(dev, *, card="", cut=None, prompt_lens=(16, 250), max_len=512, n_new=32,
             buckets=(32, 64, 128, 256)) -> None:
    """Phase 14: ``repro_torch.serve.Engine`` and the language models.

    1. qwen2-7b at full width and depth in bfloat16 (its dtype): params from
       a seeded generator on the card; 8 slots of 512 positions, 16 prompts
       of seeded lengths in ``prompt_lens``, 32 new tokens each; every
       request gets its tokens and every logit is finite; prefill ms per
       bucket (first call and warmed), decode ms per engine step, decode
       tokens/s over live slots, time to first token, host ms per step and
       peak memory are logged;
    2. the same params in float32: 6 requests through 4 slots, each equal
       to its solo greedy run (a first difference is allowed only where the
       solo run's top-two margin is under ``NEAR_TIE``, and then nothing
       after it is compared);
    3. every other config at its published width, depth cut to one
       supercell (seamless: one encoder layer), float32: decoder-only
       configs through the Engine (4 requests, 8 new tokens) against their
       solo runs, MoE routing lossless (capacity drops depend on what
       shares the batch); seamless and internvl2 (the Engine passes no
       modality) through ``forward_prefill`` and 8 ``decode_step``s on a
       batch of 2, each row against the row alone;
    4. every ``reduced_config`` in float32 on the card and on the CPU:
       prefill logits and 4 decode steps within rtol = atol = 1e-4 (plus
       the rounding noise of the config, measured as in
       ``tests/test_torch_models.py``).

    ``cut`` maps each config to the one run (on the card: none; the CPU
    rehearsal passes ``reduced_config``).  Raises on any failed check."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.base import reduced_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, EngineConfig

    on_card = dev.type == "cuda"
    cut = cut or (lambda c: c)
    gib = 2**30
    t14 = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def allocated() -> float:
        if not on_card:
            return 0.0
        sync()
        return torch.cuda.memory_allocated(dev) / gib

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    free()
    log(f"phase 14: the language-model serving engine (repro_torch.serve.Engine); "
        f"{allocated():.2f} GiB allocated on entry; {card}")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def reckon(cfg) -> float:
        """The params' bytes, from their shapes alone."""
        return sum(t.numel() * 4 for t in lm.leaves(lm.init_params(cfg, device="meta")).values())

    def params_of(cfg, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return lm.init_params(cfg, generator=gen, device=dev)

    def prompts_of(cfg, n, lo, hi, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))).tolist()
                for _ in range(n)]

    # -- 1. qwen2-7b, bf16, full width and depth -------------------------------
    cfg = cut(get_config(LM_MAIN))
    log(f"  case 1: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; params {reckon(cfg) / 1e9:.2f} GB (float32)")
    params = params_of(cfg, SEED)
    log(f"  params on the card: {allocated():.2f} GiB allocated")

    def serve_main():
        """Case 1; its locals (the engine, its wrapped methods) go on return."""
        ecfg = EngineConfig(max_slots=8, max_len=max_len, max_new_tokens=n_new, prefill_buckets=buckets)
        prompts = prompts_of(cfg, 16, *prompt_lens, SEED)

        # prefill ms per bucket: first call, then warmed (3 calls, CUDA events)
        eng = Engine(params, cfg, ecfg)
        for b in buckets:
            fn = eng._prefill_fn(b)
            toks = torch.randint(0, cfg.vocab_size, (1, b), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(b))
            first_s = _seconds(lambda: fn(params, toks), dev)
            warm_s = min(_seconds(lambda: fn(params, toks), dev) for _ in range(3))
            log(f"  prefill bucket {b}: first call {first_s * 1e3:.3f} ms, warmed "
                f"{warm_s * 1e3:.3f} ms ({b / warm_s:.0f} tokens/s); {card}")
        del eng

        eng = Engine(params, cfg, ecfg)
        steps, ttft, admitting = [], {}, [False]
        decode_calls = []  # (seconds, the step's own decode (not an admission's)?, live slots)
        real_decode, real_admit, real_sample = eng._decode, eng._admit, eng._sample

        def decode(*args):
            s = _seconds(lambda: decode.out.append(real_decode(*args)), dev)
            decode_calls.append((s, not admitting[0], int(eng.live.sum())))
            return decode.out.pop()

        decode.out = []

        prefill_calls = []
        real_prefill_fn = eng._prefill_fn

        def prefill_fn(bucket):
            fn = real_prefill_fn(bucket)

            def timed(*args):
                out = []
                prefill_calls.append(_seconds(lambda: out.append(fn(*args)), dev))
                check(bool(torch.isfinite(out[0][0]).all()), "case 1: a non-finite prefill logit")
                return out[0]

            return timed

        def admit(req, slot):
            admitting[0] = True
            try:
                real_admit(req, slot)
            finally:
                admitting[0] = False
            sync()
            ttft[req.rid] = time.perf_counter() - t_run

        def sample(logits):
            check(bool(torch.isfinite(logits).all()), f"case 1: a non-finite logit ({cfg.name})")
            return real_sample(logits)

        eng._decode, eng._admit, eng._sample, eng._prefill_fn = decode, admit, sample, prefill_fn
        rids = [eng.add_request(p) for p in prompts]
        t_run = time.perf_counter()
        while eng.queue or eng.active:
            n_calls, n_prefills = len(decode_calls), len(prefill_calls)
            t0 = time.perf_counter()
            eng.step()
            sync()
            wall = time.perf_counter() - t0
            calls = decode_calls[n_calls:]
            (main,) = [(s, n) for s, is_main, n in calls if is_main]
            inside = sum(s for s, _, _ in calls) + sum(prefill_calls[n_prefills:])
            steps.append((wall, main[0], inside, main[1]))
        run_s = time.perf_counter() - t_run
        done = {r.rid: r for r in eng.finished}
        check(sorted(done) == rids and all(len(done[r].out) == n_new for r in rids),
              f"case 1: requests finished with {sorted(len(r.out) for r in eng.finished)} tokens, "
              f"expected 16 with {n_new}")
        decode_ms = [s * 1e3 for _, s, _, _ in steps]
        tok_s = sum(n for _, _, _, n in steps) / (sum(decode_ms) / 1e3)
        host_ms = [(w - inside) * 1e3 for w, _, inside, _ in steps]
        log(f"  case 1: 16 requests, {n_new} tokens each, in {len(steps)} engine steps, {run_s:.3f} s; "
            f"decode ms per step: median {float(np.median(decode_ms)):.3f}, min {min(decode_ms):.3f}, "
            f"max {max(decode_ms):.3f} (CUDA events, card synchronized); decode tokens/s over live "
            f"slots {tok_s:.1f}; host ms per step (step wall time minus its decode and prefill "
            f"calls): median {float(np.median(host_ms)):.3f}, max {max(host_ms):.3f}; {card}")
        log(f"  case 1: time to first token, s (request: prompt length): " + ", ".join(
            f"{r}: {ttft[r]:.3f} ({len(prompts[r])})" for r in rids))
        if on_card:
            log(f"  case 1: peak device memory {torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB; {card}")
            decode_profile(eng)
        del eng

    def decode_profile(eng):
        """Where a decode step's time goes: one step over the 8 slots (the
        run's last positions), the host's time to enqueue it (no call waits
        for the card), and the card's busy time by kernel
        (``torch.profiler``)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        tok, pos = eng.last_token, eng.positions

        def call():
            return lm.decode_step(params, cfg, tok, pos, eng.cache)

        call()
        sync()
        t0 = time.perf_counter()
        call()
        host = time.perf_counter() - t0
        sync()
        wall = _seconds(call, dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            sync()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

        def us(e):
            v = getattr(e, "self_device_time_total", None)
            return getattr(e, "self_cuda_time_total", 0) if v is None else v

        busy = sum(us(e) for e in rows) / 1e3
        top = sorted(rows, key=us, reverse=True)[:6]
        log(f"  case 1: one decode step: {wall * 1e3:.3f} ms (CUDA events), host enqueue "
            f"{host * 1e3:.3f} ms, card busy {busy:.3f} ms in {sum(e.count for e in rows)} kernels "
            f"(idle {max(0.0, 1 - busy / (wall * 1e3)) * 100:.1f} %); by kernel, ms: " + "; ".join(
                f"{e.key[:60]} x{e.count} {us(e) / 1e3:.3f}" for e in top) + f"; {card}")

    # -- 2. the same params in float32: continuous batching is transparent ------
    def transparent():
        """Case 2; its locals go on return."""
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        n_new32 = 8
        prompts32 = prompts_of(cfg32, 6, *prompt_lens, SEED + 2)
        eng = Engine(params, cfg32, EngineConfig(max_slots=4, max_len=max_len, max_new_tokens=n_new32,
                                                 prefill_buckets=buckets))
        firsts, last = {}, [None]
        real_first, real_sample = eng._first_token, eng._sample

        def sample32(logits):
            last[0] = logits
            return real_sample(logits)

        def first_token(req, n, bucket, padded_logits):
            t = real_first(req, n, bucket, padded_logits)
            firsts[req.rid] = last[0][0 if bucket == n else req.slot, : cfg32.vocab_size].float().cpu()
            return t

        eng._sample, eng._first_token = sample32, first_token
        rids = [eng.add_request(p) for p in prompts32]
        done = {r.rid: r.out for r in eng.run()}
        for rid, p in zip(rids, prompts32):
            solo = solo_greedy(params, cfg32, p, n_new32, max_len, dev)
            found = same_as_solo(f"case 2, request {rid}", done[rid], solo)
            diff = float((firsts[rid] - solo[1]).abs().max())
            log(f"  case 2, request {rid} (prompt {len(p)}): {found}; first token's logits differ "
                f"from its solo run by at most {diff:.3g}")

    serve_main()
    transparent()
    del params
    free()
    log(f"  cases 1-2 done, {allocated():.2f} GiB allocated after freeing their params")

    # -- 3. every other config at its published width, one supercell ------------
    for arch in ARCHS:
        if arch == LM_MAIN:
            continue
        full = get_config(arch)
        cell = len(full.block_pattern)
        over = dict(n_layers=cell, dtype="float32")
        if full.is_encoder_decoder:
            over["n_encoder_layers"] = 1
        if full.moe is not None:
            # lossless routing: which assignments a full expert drops
            # depends on what else shares the batch
            over["moe"] = dataclasses.replace(full.moe, capacity_factor=float(full.moe.num_experts))
        cfg = cut(dataclasses.replace(full, **over))
        notes = [f"n_layers {full.n_layers} -> {cfg.n_layers}"]
        if full.is_encoder_decoder:
            notes.append(f"n_encoder_layers {full.n_encoder_layers} -> {cfg.n_encoder_layers}")
        if full.moe is not None:
            notes.append(f"capacity_factor {full.moe.capacity_factor} -> {cfg.moe.capacity_factor}")
        notes.append(f"dtype {full.dtype} -> float32")
        t_cfg = time.perf_counter()
        log(f"  case 3, {arch}: d_model {cfg.d_model}, vocab {cfg.vocab_size}, params "
            f"{reckon(cfg) / 1e9:.2f} GB (float32), {allocated():.2f} GiB allocated before them; "
            f"reduced: {'; '.join(notes)}")
        params = params_of(cfg, SEED + 3)
        if cfg.modality is None:
            prompts = prompts_of(cfg, 4, 5, 24, SEED + 4)
            eng = Engine(params, cfg, EngineConfig(max_slots=4, max_len=64, max_new_tokens=8,
                                                   prefill_buckets=(32,)))
            rids = [eng.add_request(p) for p in prompts]
            done = {r.rid: r.out for r in eng.run()}
            found = [same_as_solo(f"case 3, {arch}, request {rid}", done[rid],
                                  solo_greedy(params, cfg, p, 8, 64, dev))
                     for rid, p in zip(rids, prompts)]
            del eng
        else:
            # a batch of 2 through forward_prefill and 8 decode_steps, each
            # row against the same row alone
            g = torch.Generator(device=dev).manual_seed(SEED + 5)
            n_text = 12
            frames = cfg.num_modality_tokens if cfg.modality == "vision" else 16
            mod = torch.randn(2, frames, cfg.modality_dim, generator=g, device=dev)
            toks = torch.randint(0, cfg.vocab_size, (2, n_text), generator=g, device=dev)

            def greedy(rows):
                logits, cache = lm.forward_prefill(params, cfg, toks[rows], mod[rows])
                n = cache["slot0"]["k"].shape[2]  # positions of the prompt
                cache = lm.grow_cache(cfg, cache, n + 8, n)
                out, margins = [], []
                for i in range(8):
                    rows_l = logits[:, : cfg.vocab_size].float()
                    check(bool(torch.isfinite(rows_l).all()), f"case 3, {arch}: a non-finite logit")
                    top = torch.topk(rows_l, 2, dim=-1).values
                    margins.append((top[:, 0] - top[:, 1]).tolist())
                    out.append(rows_l.argmax(-1))
                    if i < 7:
                        logits, cache = lm.decode_step(params, cfg, out[-1], n + i, cache)
                return torch.stack(out, 1).tolist(), list(zip(*margins))

            both, _ = greedy(slice(0, 2))
            found = []
            for r in range(2):
                alone, margins = greedy(slice(r, r + 1))
                found.append(same_as_solo(f"case 3, {arch}, row {r}", both[r],
                                          (alone[0], None, list(margins[0]))))
        log(f"  case 3, {arch}: {'; '.join(sorted(set(found)))}; {time.perf_counter() - t_cfg:.1f} s")
        del params
        free()

    # -- 4. the card against the CPU, every reduced config -----------------------
    cpu = torch.device("cpu")
    for arch in ARCHS:
        cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
        host = lm.init_params(cfg, generator=torch.Generator().manual_seed(SEED + 6), device=cpu)
        rng = np.random.default_rng(SEED + 7)
        n_text = 16 - (cfg.num_modality_tokens if cfg.modality == "vision" else 0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, n_text)))
        mod = None
        if cfg.modality is not None:
            frames = cfg.num_modality_tokens if cfg.modality == "vision" else 16
            mod = torch.as_tensor(rng.standard_normal((2, frames, cfg.modality_dim)).astype(np.float32))

        def run(params, d):
            logits, cache = lm.forward_prefill(params, cfg, toks.to(d), None if mod is None else mod.to(d),
                                               q_chunk=8)
            n = 16
            cache = lm.grow_cache(cfg, cache, n + 4, n)
            outs = [logits]
            tok = torch.as_tensor(rng_tok, device=d)
            for i in range(4):
                logits, cache = lm.decode_step(params, cfg, tok, n + i, cache)
                outs.append(logits)
                tok = (tok + 1 + i) % cfg.vocab_size
            return [o.float().cpu() for o in outs]

        rng_tok = rng.integers(0, cfg.vocab_size, size=(2,))
        want = run(host, cpu)
        card_params = lm.tree_map(lambda t: t.to(dev), host)
        got = run(card_params, dev)
        g = torch.Generator().manual_seed(0)
        moved = lm.tree_map(lambda a: a * (1 + 2.0**-24 * torch.randn(a.shape, generator=g)), host)
        noise = max(float((a - b).abs().max()) for a, b in zip(run(moved, cpu), want))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        for i, (a, b) in enumerate(zip(got, want)):
            ok = torch.allclose(a, b, rtol=1e-4, atol=1e-4 + noise)
            check(ok, f"case 4, {arch}: {'prefill' if i == 0 else f'decode step {i}'} logits differ "
                      f"between the card and the CPU by {float((a - b).abs().max()):.3g} (rounding "
                      f"noise {noise:.3g})")
        log(f"  case 4, {arch} (reduced): card against CPU, prefill + 4 decode steps, max |diff| "
            f"{err:.3g} (rounding noise {noise:.3g})")
        del card_params
    free()

    sec = time.perf_counter() - t14
    if on_card:
        peak = torch.cuda.max_memory_allocated(dev) / gib
        log(f"  peak device memory of phase 14: {peak:.2f} GiB; {card}")
        check(peak < 70, f"phase 14: peak device memory {peak:.2f} GiB, not under 70 GiB")
    log(f"phase 14: {sec:.1f} s")
    if on_card:
        check(sec < 180, f"phase 14 took {sec:.1f} s, more than 180 s")


# -- phase 15: language-model training ----------------------------------------

TRAIN_MAIN = "granite-moe-1b-a400m"


def train_phase(dev, *, card="", cut=None, seq_len=4096, global_batch=8, steps=6, every=3,
                q_chunk=1024, microbatches=2) -> None:
    """Phase 15: ``repro_torch.train`` (optimizer, train step, trainer, data).

    1. granite-moe-1b-a400m at its published width and depth (24 layers,
       d_model 1024, 32 experts top-8; 1.385 B float32 parameters from a
       seeded generator, bf16 compute), ``TrainOptions(remat=True,
       q_chunk=1024, microbatches=2)``, synthetic tokens of ``seq_len``
       at a global batch of ``global_batch``: the ``Trainer`` takes
       ``steps`` steps with a checkpoint every ``every`` into a temporary
       directory (free disk checked first); every loss and aux loss finite;
       ms per step (the loss read back: the card synchronized), tokens/s,
       the host's enqueue ms and loop ms per step, each save's to-host and
       write seconds, peak memory.  Then again, SIGTERM to this process
       during step ``every``: the trainer stops after it with a committed
       checkpoint, a new ``Trainer`` resumes from it, and its last steps
       give params, moments and counters bitwise the uninterrupted run's,
       every step's loss too.  Both runs under
       ``torch.use_deterministic_algorithms(True)`` (index_add_ and the
       index backward accumulate with atomics otherwise);
    2. every ``reduced_config`` in float32, card against CPU: the loss of
       one train step within 1e-5 and every gradient leaf within 1e-4 of
       its largest magnitude, plus, for xlstm-1.3b, its rounding noise (the
       same run with parameters moved by a relative 2**-24, on the CPU).

    ``cut`` maps the config to the one run (on the card: none; the CPU
    rehearsal passes ``reduced_config``).  Raises on any failed check."""
    import dataclasses
    import gc
    import signal
    import threading

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.base import reduced_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig, put_batch_on

    on_card = dev.type == "cuda"
    cut = cut or (lambda c: c)
    gib = 2**30
    t15 = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    free()
    alloc0 = torch.cuda.memory_allocated(dev) / gib if on_card else 0.0
    log(f"phase 15: language-model training (repro_torch.train); {alloc0:.2f} GiB allocated on "
        f"entry; {card}")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- 1. granite-moe-1b-a400m at full width and depth ----------------------
    cfg = cut(get_config(TRAIN_MAIN))
    n_params = sum(t.numel() for t in lm.leaves(lm.init_params(cfg, device="meta")).values())
    options = ts.TrainOptions(remat=True, q_chunk=q_chunk, microbatches=microbatches)
    opt_cfg = opt.OptimizerConfig()
    data = DataConfig(seq_len=seq_len, global_batch=global_batch, vocab_size=cfg.vocab_size,
                      seed=SEED + 9)
    tokens = seq_len * global_batch
    log(f"  case 1: {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} KV), {cfg.moe.num_experts} experts top-{cfg.moe.top_k}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B float32 parameters "
        f"({16 * n_params / 1e9:.1f} GB with gradients and two moments), {cfg.dtype} compute; "
        f"{options}; {global_batch} x {seq_len} tokens a step")

    def init_state():
        return ts.init_train_state(torch.Generator(device=dev).manual_seed(SEED + 8), cfg, dev)

    train_step = ts.make_train_step(cfg, opt_cfg, options)

    class Recorder:
        """The train step as the trainer calls it, recording each step's
        metrics and the host's time to enqueue it; ``sigterm_at`` sends
        SIGTERM to this process while that step (1-based) runs."""

        def __init__(self, sigterm_at=None):
            self.rows, self.sigterm_at, self.last = [], sigterm_at, None

        def __call__(self, state, batch):
            t0 = time.perf_counter()
            loop_s = None if self.last is None else t0 - self.last
            n = int(state["step"]) + 1
            if n == self.sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
            new, metrics = train_step(state, batch)
            enqueue_s = time.perf_counter() - t0
            sync()
            step_s = time.perf_counter() - t0
            self.rows.append(dict({k: float(v) for k, v in metrics.items()}, step=n,
                                  enqueue_s=enqueue_s, step_s=step_s, loop_s=loop_s))
            self.last = time.perf_counter()
            return new, metrics

    def report(what, rec, trainer):
        for r in rec.rows:
            vals = [r[k] for k in ("loss", "ce", "z_loss", "moe_lb_loss", "moe_z_loss", "grad_norm")]
            check(all(np.isfinite(vals)), f"case 1, {what}, step {r['step']}: a non-finite metric {r}")
            log(f"    {what}, step {r['step']}: {1e3 * r['step_s']:.1f} ms ({tokens / r['step_s']:.0f} "
                f"tokens/s), host enqueue {1e3 * r['enqueue_s']:.1f} ms"
                + ("" if r["loop_s"] is None else
                   f", host between steps {1e3 * r['loop_s']:.1f} ms (data, batch to the card, saves)")
                + f"; loss {r['loss']:.6f} (ce {r['ce']:.6f}, z {r['z_loss']:.6g}, moe_lb "
                  f"{r['moe_lb_loss']:.6f}, moe_z {r['moe_z_loss']:.6g}), grad_norm "
                  f"{r['grad_norm']:.4f}, lr {r['lr']:.3g}")
        if trainer.ckpt is not None and trainer.ckpt.last_save:
            ls = trainer.ckpt.last_save
            log(f"    {what}: the last save {ls.get('to_host_s', 0):.3f} s to the host, write "
                f"{ls.get('write_s', float('nan')):.3f} s ({trainer.ckpt.stats.saves} saves)")

    def remove(path):
        """``shutil.rmtree(path)`` on a thread: unlinking two snapshots
        (31 GiB) takes the card's host ~7-12 s, which the next work overlaps."""
        t = threading.Thread(target=shutil.rmtree, args=(path, True), daemon=True)
        t.start()
        return t

    root = tempfile.mkdtemp(prefix="repro-torch-train-")
    deterministic = torch.are_deterministic_algorithms_enabled()
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        need = 2.2 * 12 * n_params / gib + 1.0  # two snapshots of params and moments
        disk = shutil.disk_usage(root).free / gib
        check(disk >= need, f"phase 15 needs {need:.1f} GiB of free disk under {root}, {disk:.1f} free")
        log(f"  checkpoints under {root}: {disk:.1f} GiB free, {need:.1f} GiB needed")
        torch.use_deterministic_algorithms(True)

        def trainer(rec, d):
            return Trainer(rec, init_state, data,
                           TrainerConfig(total_steps=steps, checkpoint_every=every,
                                         checkpoint_dir=d, log_every=1), device=dev)

        # the uninterrupted run
        t0 = time.perf_counter()
        rec_a = Recorder()
        tr_a = trainer(rec_a, os.path.join(root, "a"))
        out_a = tr_a.run()
        sec_a = time.perf_counter() - t0
        check(out_a["final_step"] == steps, f"case 1: the run ended at step {out_a['final_step']}")
        report("uninterrupted", rec_a, tr_a)
        times = sorted(r["step_s"] for r in rec_a.rows[1:]) or [rec_a.rows[0]["step_s"]]
        med = times[len(times) // 2]
        log(f"  case 1, uninterrupted: {steps} steps in {sec_a:.1f} s; median {1e3 * med:.1f} ms a step "
            f"after the first ({tokens / med:.0f} tokens/s), host enqueue median "
            f"{1e3 * sorted(r['enqueue_s'] for r in rec_a.rows)[steps // 2]:.1f} ms; {card}")
        want, want_losses = tr_a.state, [r["loss"] for r in rec_a.rows]
        del tr_a
        removing = remove(os.path.join(root, "a"))  # while the next run computes

        # preempted by SIGTERM during step `every`, then resumed by a new trainer
        t0 = time.perf_counter()
        rec_b = Recorder(sigterm_at=every)
        tr_b = trainer(rec_b, os.path.join(root, "b"))
        tr_b.install_signal_handler()
        out_b = tr_b.run()
        signal.signal(signal.SIGTERM, sigterm)
        check(out_b["final_step"] == every,
              f"case 1: SIGTERM during step {every}, but the run ended at step {out_b['final_step']}")
        check(tr_b.ckpt.available_steps() == [every],
              f"case 1: committed snapshots {tr_b.ckpt.available_steps()} after SIGTERM")
        report("preempted", rec_b, tr_b)
        del tr_b
        free()
        t1 = time.perf_counter()
        rec_c = Recorder()
        tr_c = trainer(rec_c, os.path.join(root, "b"))
        restore_s = time.perf_counter() - t1
        check(tr_c.start_step == every, f"case 1: resumed at step {tr_c.start_step}")
        out_c = tr_c.run()
        sec_b = time.perf_counter() - t0
        report("resumed", rec_c, tr_c)
        check(out_c["final_step"] == steps, f"case 1: the resumed run ended at {out_c['final_step']}")
        got, exp = lm.leaves(tr_c.state), lm.leaves(want)
        check(sorted(got) == sorted(exp), "case 1: the resumed state has other leaves")
        differ = [k for k in exp if got[k].dtype != exp[k].dtype or not torch.equal(got[k], exp[k])]
        check(not differ, f"case 1: resumed != uninterrupted at {differ[:5]} ({len(differ)} leaves)")
        losses = [r["loss"] for r in rec_b.rows] + [r["loss"] for r in rec_c.rows]
        check(losses == want_losses, f"case 1: losses {losses} against {want_losses}")
        log(f"  case 1, preempted and resumed: restore and placement {restore_s:.3f} s, {len(exp)} "
            f"leaves (params, m, v, count, step) bitwise the uninterrupted run's, every loss equal; "
            f"{sec_b:.1f} s")
        del tr_c, want, got, exp
        removing.join()
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        torch.use_deterministic_algorithms(deterministic)
        removing = remove(root)  # joined at the end of the phase
    free()
    if on_card:
        peak1 = torch.cuda.max_memory_allocated(dev) / gib
        log(f"  case 1: peak device memory {peak1:.2f} GiB; {card}")

    # -- where a step's time goes: the same step with 2 of the layers -----------
    # (a profile of all 24 takes the profiler ~40 s to digest: 58 k kernels)
    t_prof = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=min(2, cfg.n_layers))
    state2 = ts.init_train_state(torch.Generator(device=dev).manual_seed(SEED + 8), cfg2, dev)
    step2 = ts.make_train_step(cfg2, opt_cfg, options)
    batch2 = put_batch_on(dev)(make_source(data).batch_at(0))
    step2(state2, batch2)
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]) as prof:
        step2(state2, batch2)
        sync()
    wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def us(e):
        v = getattr(e, "self_device_time_total", None)
        return getattr(e, "self_cuda_time_total", 0) if v is None else v

    busy = sum(us(e) for e in rows) / 1e3
    top = sorted(rows, key=us, reverse=True)[:10]
    log(f"  case 1, one step with {cfg2.n_layers} of the layers under torch.profiler: {wall * 1e3:.1f} ms, "
        + (f"card busy {busy:.1f} ms in {sum(e.count for e in rows)} kernels (idle "
           f"{max(0.0, 1 - busy / (wall * 1e3)) * 100:.1f} %); by kernel, ms: " + "; ".join(
               f"{e.key[:48]} x{e.count} {us(e) / 1e3:.1f}" for e in top) if on_card
           else "card busy not measured (no card)") + f"; {time.perf_counter() - t_prof:.1f} s in all; {card}")
    del state2, step2, batch2, prof
    free()

    # -- 2. every reduced config, card against CPU ------------------------------
    cpu = torch.device("cpu")
    for arch in ARCHS:
        t_cfg = time.perf_counter()
        rcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
        host = lm.init_params(rcfg, generator=torch.Generator().manual_seed(SEED + 10), device=cpu)
        rng = np.random.default_rng(SEED + 11)
        n_text = 16 - (rcfg.num_modality_tokens if rcfg.modality == "vision" else 0)
        batch = {"tokens": torch.as_tensor(rng.integers(0, rcfg.vocab_size, size=(2, n_text)))}
        if rcfg.modality is not None:
            frames = rcfg.num_modality_tokens if rcfg.modality == "vision" else 16
            batch["modality"] = torch.as_tensor(
                rng.standard_normal((2, frames, rcfg.modality_dim)).astype(np.float32))
        grad_fn = ts.value_and_grad(ts.make_loss_fn(rcfg, ts.TrainOptions(q_chunk=8)))

        def run(params, d):
            (loss, _), grads = grad_fn(params, {k: v.to(d) for k, v in batch.items()})
            return loss.cpu(), {k: g.cpu() for k, g in lm.leaves(grads).items()}

        want_loss, want = run(host, cpu)
        scale = {k: max(float(g.abs().max()), 1e-30) for k, g in want.items()}
        got_loss, got = run(lm.tree_map(lambda t: t.to(dev), host), dev)
        noise = 0.0
        if arch == "xlstm-1.3b":  # ill-conditioned at its reduced size (PERF.md)
            g = torch.Generator().manual_seed(0)
            moved = lm.tree_map(lambda a: a * (1 + 2.0**-24 * torch.randn(a.shape, generator=g)), host)
            m_loss, m_grads = run(moved, cpu)
            noise = max([float((m_loss - want_loss).abs())]
                        + [float((m_grads[k] - want[k]).abs().max()) / scale[k] for k in want])
        loss_err = float((got_loss - want_loss).abs())
        check(loss_err <= 1e-5 + noise,
              f"case 2, {arch}: loss {float(got_loss)} on the card, {float(want_loss)} on the CPU "
              f"(noise {noise:.3g})")
        err = 0.0
        for k in want:
            e = float((got[k] - want[k]).abs().max()) / scale[k]
            err = max(err, e)
            check(e <= 1e-4 + noise, f"case 2, {arch}: gradient {k} differs by {e:.3g} of its max "
                                     f"between the card and the CPU (noise {noise:.3g})")
        log(f"  case 2, {arch} (reduced): one train step's loss and {len(want)} gradient leaves, card "
            f"against CPU: loss |diff| {loss_err:.3g}, gradients max |diff| {err:.3g} of each leaf's "
            f"max (rounding noise {noise:.3g}); {time.perf_counter() - t_cfg:.1f} s")
    free()

    removing.join()
    sec = time.perf_counter() - t15
    if on_card:
        peak = torch.cuda.max_memory_allocated(dev) / gib
        log(f"  peak device memory of phase 15: {peak:.2f} GiB; {card}")
        check(peak < 70, f"phase 15: peak device memory {peak:.2f} GiB, not under 70 GiB")
    log(f"phase 15: {sec:.1f} s")
    if on_card:
        check(sec < 180, f"phase 15 took {sec:.1f} s, more than 180 s")


MESH_DECODE = "yi-9b"
MESH_EP = "granite-moe-1b-a400m"


def lm_mesh_phase(dev, *, card="", cut=None, layers=(8, 4, 8), decode=(8, 32768),
                  long=(1, 131072), prefill=(8, 4096), small_decode=(2, 512),
                  conv=(32768, 8192), window=(32768, 4096, 128), max_s=150.0,
                  max_gib=70.0) -> None:
    """Phase 16: the language models over a mesh of ranks on this card.

    Every mesh is a ``repro_torch.dist.Mesh`` whose ranks all sit on
    ``dev``; everything runs in float32.  Per case: ms per call (flat
    against the mesh), the mesh and its layout, peak memory.

    1. yi-9b decode, ``"seq"`` layout: published widths, ``layers[0]`` of
       48 layers, B, T = ``decode`` (decode_32k's cache, batch cut from 128)
       filled from a seeded generator, pos T-100, a (data=2, model=8) mesh
       through ``launch.steps.build_step``: logits and every cache leaf
       within 2e-5 of the flat decode (``_online_softmax_decode``) on the
       same card; a mesh step allocates no second copy of the cache (less
       than one layer's K between before and after);
    2. yi-9b decode, ``"seq_all"``: B, T = ``long`` (long_500k's cache cut
       by 4), ``layers[1]`` layers, the same mesh: logits within 2e-5;
    3. granite-moe-1b-a400m, expert parallelism: published widths,
       ``layers[2]`` of 24 layers, capacity factor 4.0 (no shard drops a
       token), a (data=2, model=4) mesh: a prefill of ``prefill`` tokens
       through ``build_step("prefill")`` (``ep_block``: the all-to-alls)
       and a decode step of B = ``small_decode[0]`` through
       ``build_step("decode")`` (``ep_block_small``), each within 1e-5 of
       the single-rank path; ``moe_apply`` on layer 0 for both paths, its
       aux losses data shard 0's (recomputed from ``_route`` on that
       shard's slices) within 1e-6;
    4. the expert-parallel train step: ``forward_train`` loss and
       gradients of reduced granite-moe-1b-a400m and olmoe-1b-7b on a (2, 4)
       mesh, the card against the same mesh of CPU ranks: loss within
       1e-5, every gradient leaf within 1e-4 of its largest magnitude;
    5. context parallelism over 8 sequence ranks: ``causal_conv_cp`` at
       jamba's d_inner 8192 (``conv``: S, channels), conv width 4, bitwise
       one rank; ``sliding_window_attention_cp`` at gemma2's window 4096
       and head_dim 128, one head (``window``: S, W, D): each rank's output
       bitwise the window function on the global slice, the first 8192
       queries within 1e-5 of ``kernels.ref.sliding_window_attention_ref``,
       and over 16 ranks (a shard thinner than the window) ``ValueError``.

    ``cut`` maps each config to the one run (on the card: none; the CPU
    rehearsal passes ``reduced_config``).  Raises on any failed check; the
    phase must take under ``max_s`` seconds and ``max_gib`` GiB."""
    import dataclasses
    import gc
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, reduced_config
    from repro_torch.dist import Mesh, kv_cache_layout, use_mesh
    from repro_torch.dist.context_parallel import (
        causal_conv_cp,
        sliding_window_attention_cp,
        window_attention_local,
    )
    from repro_torch.kernels.ref import sliding_window_attention_ref
    from repro_torch.launch.steps import build_step
    from repro_torch.models import lm, moe
    from repro_torch.models.mamba import _causal_conv
    from repro_torch.train import train_step as ts

    on_card = dev.type == "cuda"
    cut = cut or (lambda c: c)
    gib = 2**30
    t16 = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def allocated() -> int:
        sync()
        return torch.cuda.memory_allocated(dev) if on_card else 0

    def peak() -> float:
        return torch.cuda.max_memory_allocated(dev) / gib if on_card else 0.0

    def mesh_of(shape, names):
        devs = np.empty(math.prod(shape), dtype=object)
        for i in range(devs.size):
            devs[i] = dev
        return Mesh(devs.reshape(shape), names)

    def ms(fn, reps=3) -> float:
        fn()  # warm
        return min(_seconds(fn, dev) for _ in range(reps)) * 1e3

    def config(arch, n_layers, **kw):
        return dataclasses.replace(cut(get_config(arch)), dtype="float32", n_layers=n_layers, **kw)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def fill(tree, seed):
        g = gen(seed)
        lm.tree_map(lambda t: t.normal_(generator=g), tree)
        return tree

    def close(what, got, want, tol):
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
              f"{what}: max |mesh - flat| {err:.3e} over the tolerance {tol}")
        return err

    free()
    log(f"phase 16: language models over a mesh of ranks on this card (launch.steps.build_step, "
        f"use_mesh); {allocated() / gib:.2f} GiB allocated on entry; {card}")

    def decode_case(label, cfg, B, T, want_layout, seed):
        t0 = time.perf_counter()
        mesh = mesh_of((2, 8), ("data", "model"))
        layout = kv_cache_layout(B, T, cfg.n_kv_heads, mesh)
        check(layout == want_layout, f"{label}: layout {layout}, expected {want_layout}")
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        params = lm.init_params(cfg, generator=gen(seed), device=dev)
        fn, _, in_specs, out_specs = build_step(cfg, ShapeConfig(label, T, B, "decode"), mesh)
        cache = fill(lm.init_cache(cfg, B, T, device=dev), seed + 1)
        flat_cache = lm.tree_map(torch.clone, cache)
        token = torch.randint(0, cfg.vocab_size, (B,), generator=gen(seed + 2), device=dev,
                              dtype=torch.int32)
        at = T - min(100, T // 4)
        pos = torch.tensor(at, dtype=torch.int32, device=dev)
        batch = {"token": token, "pos": pos, "cache": cache}
        flat_logits, _ = lm.decode_step(params, cfg, token, pos, flat_cache)
        before = allocated()
        logits, new_cache = fn(params, batch)
        after = allocated()
        layer_k = cache["slot0"]["k"][0].numel() * cache["slot0"]["k"].element_size()
        check(all(a is b for a, b in zip(lm.leaves(new_cache).values(), lm.leaves(cache).values())),
              f"{label}: the mesh step returned other cache tensors than it was given")
        check(after - before < layer_k,
              f"{label}: a mesh step left {(after - before) / gib:.3f} GiB more allocated "
              f"(one layer's K is {layer_k / gib:.3f} GiB): a copy of the cache")
        err = close(f"{label} logits", logits, flat_logits, 2e-5)
        cache_err = max(close(f"{label} cache {k}", v, lm.leaves(flat_cache)[k], 2e-5)
                        for k, v in lm.leaves(new_cache).items())
        flat_ms = ms(lambda: lm.decode_step(params, cfg, token, pos, flat_cache))
        mesh_ms = ms(lambda: fn(params, batch))
        cache_gb = sum(t.numel() * t.element_size() for t in lm.leaves(cache).values()) / 1e9
        log(f"  {label}: {cfg.name} {cfg.n_layers} layers, B={B}, T={T}, pos={at}, mesh "
            f"(data=2, model=8) on this card, layout {layout} (cache spec "
            f"{tuple(in_specs[1]['cache']['slot0']['k'])}), cache {cache_gb:.2f} GB a copy; "
            f"max |mesh - flat| logits {err:.3e}, cache {cache_err:.3e}; a mesh step's "
            f"allocation change {(after - before) / 2**20:.1f} MiB (one layer's K "
            f"{layer_k / 2**20:.0f} MiB); ms per decode step: flat {flat_ms:.3f}, mesh "
            f"{mesh_ms:.3f}; logits spec {tuple(out_specs[0])}; peak {peak():.2f} GiB; "
            f"{time.perf_counter() - t0:.1f} s")
        return peak()

    # -- 1-2. yi-9b decode: "seq" and "seq_all" --------------------------------
    peaks = [decode_case("case 1 (seq)", config(MESH_DECODE, layers[0]), *decode, "seq",
                         SEED + 160)]
    free()
    peaks.append(decode_case("case 2 (seq_all)", config(MESH_DECODE, layers[1]), *long,
                             "seq_all", SEED + 163))
    free()

    # -- 3. granite-moe-1b-a400m, expert parallelism -----------------------------
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    base = cut(get_config(MESH_EP))
    cfg = config(MESH_EP, layers[2], moe=dataclasses.replace(base.moe, capacity_factor=4.0))
    mesh = mesh_of((2, 4), ("data", "model"))
    params = lm.init_params(cfg, generator=gen(SEED + 166), device=dev)
    Bp, Sp = prefill
    fn, _, _, _ = build_step(cfg, ShapeConfig("prefill", Sp, Bp, "prefill"), mesh)
    tokens = torch.randint(0, cfg.vocab_size, (Bp, Sp), generator=gen(SEED + 167), device=dev,
                           dtype=torch.int32)
    logits, cache = fn(params, {"tokens": tokens})
    flat_logits, flat_cache = lm.forward_prefill(params, cfg, tokens, q_chunk=min(1024, Sp))
    err = close("case 3 prefill logits", logits, flat_logits, 1e-5)
    cache_err = max(close(f"case 3 prefill cache {k}", v, lm.leaves(flat_cache)[k], 1e-5)
                    for k, v in lm.leaves(cache).items())
    del cache, flat_cache
    flat_ms = ms(lambda: lm.forward_prefill(params, cfg, tokens, q_chunk=min(1024, Sp)), 2)
    mesh_ms = ms(lambda: fn(params, {"tokens": tokens}), 2)
    log(f"  case 3 prefill: {cfg.name} {cfg.n_layers} layers, {cfg.moe.num_experts} experts "
        f"top-{cfg.moe.top_k}, capacity factor {cfg.moe.capacity_factor}, {Bp} x {Sp} tokens, "
        f"mesh (data=2, model=4): ep_block; max |mesh - flat| logits {err:.3e}, cache "
        f"{cache_err:.3e}; ms per prefill: flat {flat_ms:.2f}, mesh {mesh_ms:.2f}; peak "
        f"{peak():.2f} GiB")
    p0 = lm.tree_map(lambda t: t[0], params["cells"]["slot0"]["moe"])
    f32 = torch.float32
    for label, shape in (("ep_block", (Bp, Sp, cfg.d_model)), ("ep_block_small", (2, 1, cfg.d_model))):
        x = torch.randn(shape, generator=gen(SEED + 168), device=dev)
        y1, _ = moe.moe_apply(p0, x, cfg, f32)
        with use_mesh(mesh):
            y2, aux = moe.moe_apply(p0, x, cfg, f32)
        y_err = close(f"case 3 moe_apply {label} y", y2, y1, 1e-5)
        xt = x[: shape[0] // 2].reshape(-1, shape[-1])
        if label == "ep_block_small":
            want = moe._route(p0, xt, cfg, f32)[2]
        else:
            parts = [moe._route(p0, s, cfg, f32)[2] for s in xt.chunk(4)]
            want = {k: sum(a[k] for a in parts) / 4 for k in parts[0]}
        aux_err = max(float((aux[k] - want[k]).abs()) for k in aux)
        check(aux_err <= 1e-6, f"case 3 moe_apply {label}: aux {aux_err:.3e} from data shard 0's")

        def ep():
            with use_mesh(mesh):
                moe.moe_apply(p0, x, cfg, f32)

        log(f"  case 3 moe_apply {label} {tuple(shape)}: max |EP - single rank| y {y_err:.3e}; "
            f"aux = data shard 0's within {aux_err:.3e}; ms: single rank "
            f"{ms(lambda: moe.moe_apply(p0, x, cfg, f32)):.3f}, EP {ms(ep):.3f}")
    Bd, Td = small_decode
    fn, _, _, _ = build_step(cfg, ShapeConfig("decode", Td, Bd, "decode"), mesh)
    cache = fill(lm.init_cache(cfg, Bd, Td, device=dev), SEED + 169)
    flat_cache = lm.tree_map(torch.clone, cache)
    token = torch.randint(0, cfg.vocab_size, (Bd,), generator=gen(SEED + 170), device=dev,
                          dtype=torch.int32)
    pos = torch.tensor(Td - 50, dtype=torch.int32, device=dev)
    logits, _ = fn(params, {"token": token, "pos": pos, "cache": cache})
    flat_logits, _ = lm.decode_step(params, cfg, token, pos, flat_cache)
    err = close("case 3 decode logits", logits, flat_logits, 1e-5)
    flat_ms = ms(lambda: lm.decode_step(params, cfg, token, pos, flat_cache))
    mesh_ms = ms(lambda: fn(params, {"token": token, "pos": pos, "cache": cache}))
    log(f"  case 3 decode: B={Bd}, T={Td}: ep_block_small; max |mesh - flat| logits {err:.3e}; "
        f"ms per decode step: flat {flat_ms:.3f}, mesh {mesh_ms:.3f}; peak {peak():.2f} GiB")
    log(f"  case 3: {time.perf_counter() - t0:.1f} s")
    peaks.append(peak())
    del params, cache, flat_cache, logits, flat_logits, fn
    free()

    # -- 4. the expert-parallel train step, card against CPU ranks ----------------
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_devs = np.empty(8, dtype=object)
    for i in range(8):
        cpu_devs[i] = cpu
    cpu_mesh = Mesh(cpu_devs.reshape(2, 4), ("data", "model"))
    for arch in (MESH_EP, "olmoe-1b-7b"):
        rcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
        seed = SEED + 171 + 2 * len(arch)
        host = lm.init_params(rcfg, generator=torch.Generator().manual_seed(seed), device=cpu)
        toks = torch.from_numpy(
            np.random.default_rng(seed + 1).integers(0, rcfg.vocab_size, (4, 16)))

        def loss_grads(params, tokens, m, rcfg=rcfg):
            def loss(p, b):
                with use_mesh(m):
                    return ts.make_loss_fn(rcfg, ts.TrainOptions(q_chunk=8))(p, b)
            return ts.value_and_grad(loss)(params, {"tokens": tokens})

        (want, _), wgrads = loss_grads(host, toks, cpu_mesh)
        t_arch = time.perf_counter()
        (got, _), grads = loss_grads(lm.tree_map(lambda t: t.to(dev), host), toks.to(dev), mesh)
        sync()
        sec = time.perf_counter() - t_arch
        check(abs(float(got) - float(want)) <= 1e-5,
              f"case 4 {arch}: loss {float(got)} on the card, {float(want)} on CPU ranks")
        worst = 0.0
        for k, g in lm.leaves(grads).items():
            w = lm.leaves(wgrads)[k]
            scale = max(float(w.abs().max()), 1e-30)
            e = float((g.cpu() - w).abs().max()) / scale
            check(e <= 1e-4, f"case 4 {arch} grad {k}: {e:.3e} of its max")
            worst = max(worst, e)
        log(f"  case 4 {arch} (reduced): loss {float(got):.6f} (|card - CPU ranks| "
            f"{abs(float(got) - float(want)):.3e}), gradients within {worst:.3e} of each "
            f"leaf's max, mesh (data=2, model=4) on this card; {sec * 1e3:.1f} ms a loss and "
            f"its gradients")

    log(f"  case 4: {time.perf_counter() - t0:.1f} s")

    # -- 5. context parallelism over 8 sequence ranks ----------------------------
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    seq8 = mesh_of((8,), ("seq",))
    Sc, C = conv
    g = gen(SEED + 173)
    x = torch.randn(1, Sc, C, generator=g, device=dev)
    w = torch.randn(4, C, generator=g, device=dev)
    b = torch.randn(C, generator=g, device=dev)
    one = _causal_conv(x, w, b)[0]
    got = causal_conv_cp(x, w, b, seq8, "seq")
    check(torch.equal(got, one), "case 5 causal_conv_cp over 8 ranks differs from one rank")
    conv_ms = ms(lambda: causal_conv_cp(x, w, b, seq8, "seq"), 2)
    one_ms = ms(lambda: _causal_conv(x, w, b), 2)
    log(f"  case 5 causal_conv_cp: [1, {Sc}, {C}], width 4, 8 ranks: bitwise one rank; ms: one "
        f"rank {one_ms:.3f}, 8 ranks {conv_ms:.3f}")
    del x, w, b, one, got
    free()
    Sw, W, D = window
    q, k, v = (torch.randn(1, Sw, 1, D, generator=g, device=dev) for _ in range(3))
    t_win = time.perf_counter()
    out = sliding_window_attention_cp(q, k, v, W, seq8, "seq")
    sync()
    win_s = time.perf_counter() - t_win
    S_loc = Sw // 8
    kv = F.pad(torch.stack([k, v]), (0, 0, 0, 0, W - 1, 0))
    for r in range(8):
        want = window_attention_local(kv[:, :, r * S_loc:r * S_loc + W - 1 + S_loc], r * S_loc,
                                      q[:, r * S_loc:(r + 1) * S_loc], W)
        check(torch.equal(out[:, r * S_loc:(r + 1) * S_loc], want),
              f"case 5 window attention rank {r}: not the window function on the global slice")
        del want
    del kv
    n = min(8192, Sw)
    ref = sliding_window_attention_ref(*(t[0, :n].transpose(0, 1) for t in (q, k, v)), W)
    err = close("case 5 window attention against the oracle", out[0, :n].transpose(0, 1), ref,
                1e-5)
    try:
        sliding_window_attention_cp(q, k, v, W, mesh_of((16,), ("seq",)), "seq")
        raise AssertionError("case 5: 16 ranks (a shard thinner than the window) did not raise")
    except ValueError as e:
        check("deeper than the shard length" in str(e), f"case 5: {e}")
        refused = str(e)
    log(f"  case 5 sliding_window_attention_cp: [1, {Sw}, 1, {D}], window {W}, 8 ranks "
        f"(S_loc {S_loc}): each rank bitwise the window function on the global slice; first "
        f"{n} queries within {err:.3e} of the oracle; {win_s * 1e3:.1f} ms a call; 16 ranks: "
        f"ValueError ({refused}); peak {peak():.2f} GiB")
    log(f"  case 5: {time.perf_counter() - t0:.1f} s")
    peaks.append(peak())
    del q, k, v, out, ref
    free()

    sec = time.perf_counter() - t16
    log(f"phase 16: {sec:.1f} s, peak {max(peaks):.2f} GiB; {card}")
    check(sec < max_s, f"phase 16 took {sec:.1f} s, more than {max_s} s")
    check(max(peaks) < max_gib, f"phase 16 peaked at {max(peaks):.2f} GiB, more than {max_gib}")


# -- phase 17: one process per card ------------------------------------------

LM_DECODE = "yi-9b"


def process_cases(world, n2, weak):
    """``(name, (kind, boundary), target kwargs, global shape)`` of phase
    17's stencil cases over a world of ``world`` processes: strong scaling
    at ``n2``² (k=1 zero, periodic and with overlap, fused k=4 heat and
    wave) and weak scaling at ``weak``² a rank (k=1 and fused k=4); a world
    of one runs the periodic k=1 and fused k=4 heat at ``n2``² alone."""
    fused = {"exchange_every": 4, "fused_epoch": True}
    gx, gy = process_grid(world)
    strong = [
        ("heat k=1 zero", ("heat", "zero"), {}),
        ("heat k=1 periodic", ("heat", "periodic"), {}),
        ("heat k=1 overlap", ("heat", "zero"), {"overlap": True}),
        ("heat k=4 fused", ("heat", "zero"), fused),
        ("wave k=4 fused", ("wave", "zero"), fused),
    ]
    if world == 1:
        return [(n, p, kw, (n2, n2)) for n, p, kw in (strong[1], strong[3])]
    weak_cases = [("weak heat k=1", ("heat", "zero"), {}),
                  ("weak heat k=4 fused", ("heat", "zero"), fused)]
    return ([(n, p, kw, (n2, n2)) for n, p, kw in strong]
            + [(n, p, kw, (weak * gx, weak * gy)) for n, p, kw in weak_cases])


def process_grid(world):
    """The 2-D process mesh of phase 17: 2x2 on four cards, 1 x n else."""
    return (2, 2) if world == 4 else (1, world)


def process_program(kind, boundary, shape):
    return oec_heat(shape, 4, boundary=boundary) if kind == "heat" else oec_wave(shape, 4)


def process_state(prog, dev):
    """The seeded global input state of a phase-17 case on ``dev`` (the
    same values on every card and on the CPU generator's device)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 170)
    outs = set(prog.output_fields)
    return [torch.randn(f.type.bounds.shape, generator=g, device=dev)
            for f in prog.field_args if f not in outs]


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _advance(step, state, epochs):
    for _ in range(epochs):
        state = step.advance(state)
    return state


def process_child(rank, world, tmp, spec):
    """One process of phase 17: join the world (NCCL on ``cuda:rank``, or
    gloo on the CPU for a rehearsal), run every case on this process's
    rank and write what it measured to ``<tmp>/rank<r>.json``, again after
    each case, so that the parent can check the cases that ended before a
    failure.  Any failed check raises, and the process exits non-zero; the
    language models' differences are recorded, and the parent checks
    them.  Its progress, and every
    thread's stack if it is still running ``spec["dump_s"]`` seconds in,
    go to ``<tmp>/rank<r>.log`` (the parent prints them if it fails)."""
    import faulthandler

    sys.path.insert(0, spec["src"])
    import torch

    from repro_torch.dist import processes

    progress = open(os.path.join(tmp, f"rank{rank}.log"), "w", buffering=1)
    faulthandler.dump_traceback_later(spec["dump_s"], file=progress)
    t0 = time.perf_counter()

    def note(msg):
        progress.write(f"{time.perf_counter() - t0:7.1f} s  {msg}\n")

    if spec["device"] == "cpu":  # a rehearsal: one thread a process
        torch.set_num_threads(1)
    store = os.path.abspath(os.path.join(tmp, "store"))
    w = processes.init(device=spec["device"], rank=rank, world_size=world, local_rank=rank,
                       init_method=f"file://{store}", timeout_s=120)
    note(f"joined the world on {w.device} ({w.backend})")
    out = {"rank": rank, "cases": {}}

    def save():
        path = os.path.join(tmp, f"rank{rank}.json")
        with open(path + ".part", "w") as f:
            json.dump(out, f)
        os.replace(path + ".part", path)

    try:
        for name, (kind, bc), kw, shape in process_cases(world, spec["n2"], spec["weak"]):
            out["cases"][name] = _process_case(w, name, process_program(kind, bc, shape), kw,
                                               spec["steps"], note)
            save()
        out["allreduce"] = _process_allreduce(w)
        save()
        note("comm.allreduce")
        out["snapshot"] = _process_snapshot(w, tmp, spec)
        save()
        note("snapshot")
        out["lm"] = {}
        _process_lm(w, spec, out["lm"], save)
        note("language models")
        out["done"] = True
        save()
        processes.barrier()
    except BaseException:
        # a failed check: its traceback for the parent, and an exit that
        # waits on no peer (leaving the world would wait on them all)
        import traceback

        note("failed:\n" + traceback.format_exc())
        progress.close()
        os._exit(1)
    faulthandler.cancel_dump_traceback_later()
    processes.shutdown()
    progress.close()


def _process_case(w, name, prog, kw, steps, note):
    """One stencil case on this process's rank: ``jit=False`` and ``jit=True,
    donate=True`` from the same state, bitwise; the launches of the
    counted compiled run; each graph's census; ms per step; the NCCL and
    K1/K2 device time by the profiler; peak memory; K1 and K2 against
    their plain versions at this rank's shapes and box; the digest of this
    rank's block of the result."""
    import torch

    from repro_torch import api
    from repro_torch.core.lowering import eval_apply_body
    from repro_torch.core.passes.decompose import make_strategy_2d
    from repro_torch.dist import processes
    from repro_torch.kernels import dispatch_stats, reset_dispatch_stats
    from repro_torch.kernels import epoch_kernel as k2
    from repro_torch.kernels import stencil_apply as k1

    dev, on_card = w.device, w.device.type == "cuda"
    grid = process_grid(w.size)
    mesh = processes.process_mesh(grid, ("x", "y"))
    coords = mesh.coords(w.rank)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    base = dict(mesh=mesh, strategy=make_strategy_2d(grid), backend="cuda", **kw)
    eager = api.compile(prog, api.Target(jit=False, **base))
    graphed = api.compile(prog, api.Target(jit=True, donate=True, **base))
    epochs = eager.epochs(steps)
    state0 = process_state(prog, dev)
    want = [x.shards[0] for x in _advance(eager, eager.shard_state(state0), epochs)]
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    sync()
    note(f"{name}: jit=False")
    _advance(graphed, graphed.shard_state(state0), epochs)  # captures every rotation phase
    sync()
    note(f"{name}: captured")
    reset_dispatch_stats()
    got = _advance(graphed, graphed.shard_state(state0), epochs)
    sync()
    stats = dispatch_stats()
    k1n, k2n = stats.apply_launches, stats.fused_epoch_launches
    for g, x in zip(got, want):
        check(torch.equal(g.shards[0], x), f"phase 17 {name}: rank {w.rank}'s jit=True block "
                                           "differs from its jit=False block")
    applies, fused = graphed.kernel_applies(), graphed.kernel_epochs()
    # on the CPU (a rehearsal) the wrappers run their plain versions, which
    # launch nothing
    want_n = (len(applies) * epochs, len(fused) * epochs) if on_card else (0, 0)
    check((k1n, k2n) == want_n,
          f"phase 17 {name}: rank {w.rank} launched K1 {k1n} and K2 {k2n} times in {epochs} "
          f"epochs, expected {len(applies)} and {len(fused)} an epoch")
    rec = {"k1": k1n, "k2": k2n, "epochs": epochs, "digest": [_digest(x) for x in want],
           "census": []}
    if on_card:
        for _, nodes, _ in graphed._ring.graphs.values():
            check((nodes.k1, nodes.k2) == (len(applies), len(fused)),
                  f"phase 17 {name}: a graph of rank {w.rank} holds {nodes.k1} K1 and "
                  f"{nodes.k2} K2 nodes")
            check(w.size == 1 or nodes.nccl > 0,
                  f"phase 17 {name}: a graph of rank {w.rank} holds no NCCL node")
            rec["census"].append([nodes.k1, nodes.k2, nodes.nccl, nodes.copies, nodes.fills])
        state = got
        # every process starts its timed steps together: without the
        # barrier a process's time holds its wait for the slowest peer's
        # start, and only the fastest process reads the pace
        sync()
        processes.barrier()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state = _advance(graphed, state, epochs)
        b.record()
        b.synchronize()
        rec["ms"] = a.elapsed_time(b) / steps
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state = _advance(graphed, state, epochs)
            sync()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

        def dev_ms(pred):
            us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                     for e in rows if pred(e.key))
            return us / 1e3 / steps

        rec["nccl_ms"] = dev_ms(lambda k: "nccl" in k.lower())
        rec["k1_ms"] = dev_ms(lambda k: "k1_apply" in k)
        rec["k2_ms"] = dev_ms(lambda k: "k2_epoch" in k)
        rec["busy_ms"] = dev_ms(lambda k: True)
        del state
    else:
        t0 = time.perf_counter()
        _advance(graphed, got, epochs)
        rec["ms"] = (time.perf_counter() - t0) * 1e3 / steps
    del got
    # each kernel of this rank's path against its plain version, on its box
    g = torch.Generator(device=dev).manual_seed(SEED + 171)
    for op in applies:
        arrays = [torch.randn(o.type.bounds.shape, generator=g, device=dev) for o in op.operands]
        origins = [o.type.bounds.lb for o in op.operands]
        k1_out = k1.run_apply_cuda(op, arrays, origins, op.result_bounds, device=dev)
        for x, y in zip(k1_out, eval_apply_body(op, arrays, origins, op.result_bounds)):
            check(torch.equal(x, y), f"phase 17 {name}: K1 differs from its plain version on "
                                     f"rank {w.rank}")
    for op in fused:
        arrays = [torch.randn(a.type.bounds.shape, generator=g, device=dev) for a in op.body.args]
        k2_out = k2.run_epoch_cuda(op, arrays, None if on_card else k2.region_masks(op, dev, coords),
                                   tile=graphed.target.tile, coords=coords)
        plain = k2._emit_region(op, arrays, k2.region_masks(op, dev, coords),
                                lambda v: v.type.bounds)
        check(all(torch.equal(x, y) for x, y in zip(k2_out, plain)),
              f"phase 17 {name}: K2 differs from its plain version at rank {w.rank}'s box {coords}")
    sync()
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0
    api.forget(prog, eager.target)
    api.forget(prog, graphed.target)
    if on_card:
        torch.cuda.empty_cache()
    note(f"{name}: done")
    return rec


def allreduce_values(rank, dev):
    import torch

    g = torch.Generator().manual_seed(SEED + 172 + rank)
    return torch.randn((3, 5), generator=g).to(dev)


def allreduce_func():
    """``comm.allreduce`` (sum) over both mesh axes of a 3x5 field."""
    from repro_torch.core import ir
    from repro_torch.core.dialects import comm, stencil

    core = stencil.Bounds((0, 0), (3, 5))
    func = ir.FuncOp("reduce", [stencil.FieldType(core), stencil.FieldType(core)])
    src, dst = func.body.args
    load = func.body.add_op(stencil.LoadOp(src))
    red = func.body.add_op(comm.AllReduceOp(load.results[0], ("x", "y"), "sum"))
    func.body.add_op(stencil.StoreOp(red.results[0], dst, core))
    func.body.add_op(ir.ReturnOp([]))
    return func


def _process_allreduce(w):
    import torch

    from repro_torch.core.lowering import StencilInterpreter
    from repro_torch.dist import processes

    grid = process_grid(w.size)
    mesh = processes.process_mesh(grid, ("x", "y"))
    interp = StencilInterpreter(allreduce_func(), dict(mesh.shape), distributed=True, mesh=mesh)
    x = allreduce_values(w.rank, w.device)
    ((got,),) = interp.run_ranks([(x, torch.zeros_like(x))], [mesh.coords(w.rank)])
    return got.cpu().tolist()


SNAPSHOT_STEPS, SNAPSHOT_KILL = 8, 5


def _process_snapshot(w, tmp, spec):
    """A ``ResilientLoop`` of heat k=1 over the process mesh, a snapshot
    every 2 epochs, killed before epoch ``SNAPSHOT_KILL``: process 0 has
    written the snapshot of step 4 under ``<tmp>/ckpt``."""
    from repro_torch import api
    from repro_torch.core.passes.decompose import make_strategy_2d
    from repro_torch.dist import processes
    from repro_torch.resilience import FaultPlan, ResilientLoop, SimulatedFault

    grid = process_grid(w.size)
    prog = process_program("heat", "zero", (spec["n2"], spec["n2"]))
    target = api.Target(mesh=processes.process_mesh(grid, ("x", "y")),
                        strategy=make_strategy_2d(grid), backend="cuda", jit=True, donate=True)
    loop = ResilientLoop(prog, target, process_state(prog, w.device), SNAPSHOT_STEPS,
                         directory=os.path.join(tmp, "ckpt"), checkpoint_every=2, keep_last=1,
                         fault_plan=FaultPlan(kill_at_epoch=SNAPSHOT_KILL))
    try:
        loop.run()
        raise AssertionError("phase 17: the snapshot run was not killed")
    except SimulatedFault:
        pass
    api.forget(prog, target)
    return {"killed_at_step": loop.step_count}


def _process_lm(w, spec, out, save):
    """(e) yi-9b's decode and its seq-sharded flash-decode, (f)
    granite-moe-1b-a400m's expert-parallel prefill and decode, on the
    production axes over the world (data=1, model=world): each forward
    against the stacked ranks of the same mesh on this card and against
    the flat run, and ms per call for all three, into ``out`` (saved after
    each part); the parent checks the differences.  For the prefill also
    the routing decisions that plain router products would take otherwise
    (see ``routing_flips``).  Over several processes granite's B=2 decode
    runs ``ep_block_small``, which gives each expert ceil(B K / E) = 1 slot
    and drops an assignment when both tokens pick one expert (the
    reference's capacity); its flat run takes the same capacity."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, reduced_config
    from repro_torch.dist import Mesh, kv_cache_layout, use_mesh
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import attention, lm, moe

    dev, on_card = w.device, w.device.type == "cuda"
    cut = reduced_config if spec["reduced"] else (lambda c: c)
    pmesh = make_process_mesh()
    devs = np.empty(w.size, dtype=object)
    for i in range(w.size):
        devs[i] = dev
    stacked = Mesh(devs.reshape(1, w.size), ("data", "model"))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def ms(fn):
        fn()
        sync()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    def compare(part, procs, stack, flat, tol):
        """Record the process mesh against the stacked ranks of one card
        (bitwise or not, the largest difference) and against the flat run
        (``tol``, phase 16's)."""
        got, want = procs.float(), flat.float()
        err = float((got - want).abs().max())
        out[part] = {
            "bitwise": bool(torch.equal(procs, stack)),
            "vs_stacked": float((got - stack.float()).abs().max()),
            "err": err, "tol": tol,
            "close": err <= tol * (1 + float(want.abs().max()))
                     and bool(torch.allclose(got, want, rtol=tol, atol=tol)),
        }

    # (e) yi-9b decode: build_step on the world's axes, then the seq-sharded
    # flash-decode at its widths
    B, T = spec["decode"]
    cfg = dataclasses.replace(cut(get_config(LM_DECODE)), dtype="float32",
                              n_layers=spec["layers"][0])
    params = lm.init_params(cfg, generator=gen(SEED + 180), device=dev)
    cache = lm.tree_map(lambda t: t.normal_(generator=gen(SEED + 181)),
                        lm.init_cache(cfg, B, T, device=dev))
    token = torch.randint(0, cfg.vocab_size, (B,), generator=gen(SEED + 182), device=dev,
                          dtype=torch.int32)
    pos = torch.tensor(T - min(100, T // 4), dtype=torch.int32, device=dev)
    runs = {}
    for label, mesh in (("processes", pmesh), ("stacked", stacked), ("flat", None)):
        fn = build_step(cfg, ShapeConfig("decode", T, B, "decode"), mesh)[0] if mesh else None
        c = lm.tree_map(torch.clone, cache)
        batch = {"token": token, "pos": pos, "cache": c}
        step = (lambda b=batch, fn=fn: fn(params, b)) if fn else (
            lambda c=c: lm.decode_step(params, cfg, token, pos, c))
        runs[label] = (step()[0], ms(step))
        del c, batch
    compare("decode", *(runs[k][0] for k in ("processes", "stacked", "flat")), 2e-5)
    out["decode"].update(layout=kv_cache_layout(B, T, cfg.n_kv_heads, pmesh),
                         ms={k: v[1] for k, v in runs.items()})
    save()
    del runs
    k, v = cache["slot0"]["k"][0], cache["slot0"]["v"][0]
    Kh, hd = cfg.n_kv_heads, cfg.head_dim
    qg = torch.randn(B, Kh, cfg.n_heads // Kh, hd, generator=gen(SEED + 183), device=dev)
    valid = torch.ones(B, T, dtype=torch.bool, device=dev)
    f32 = torch.float32
    flash = {}
    for label, mesh in (("processes", pmesh), ("stacked", stacked)):
        with use_mesh(mesh):
            call = (lambda mesh=mesh: attention._flash_decode_sharded(
                qg, k, v, valid, cfg, f32, mesh, "seq"))
            flash[label] = (call(), ms(call))
    def flat():  # one softmax over the whole cache, in float32
        s = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(hd)
        s = attention.softcap(s, cfg.attn_softcap)
        s = torch.where(valid[:, None, None, :], s, attention.NEG_INF)
        return torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, dim=-1), v)

    compare("flash", flash["processes"][0], flash["stacked"][0], flat(), 2e-5)
    out["flash"]["ms"] = {"processes": flash["processes"][1], "stacked": flash["stacked"][1],
                          "flat": ms(flat)}
    save()
    del params, cache, flash, k, v, qg, valid
    if on_card:
        torch.cuda.empty_cache()

    # (f) granite-moe-1b-a400m: expert-parallel prefill and decode
    base = cut(get_config("granite-moe-1b-a400m"))
    cfg = dataclasses.replace(base, dtype="float32", n_layers=spec["layers"][1],
                              moe=dataclasses.replace(base.moe, capacity_factor=4.0))
    params = lm.init_params(cfg, generator=gen(SEED + 184), device=dev)
    Bp, Sp = spec["prefill"]
    tokens = torch.randint(0, cfg.vocab_size, (Bp, Sp), generator=gen(SEED + 185), device=dev,
                           dtype=torch.int32)
    runs, routed = {}, []
    for label, mesh in (("processes", pmesh), ("stacked", stacked), ("flat", None)):
        if mesh is None:
            call = (lambda: lm.forward_prefill(params, cfg, tokens, q_chunk=min(1024, Sp)))
        else:
            fn = build_step(cfg, ShapeConfig("prefill", Sp, Bp, "prefill"), mesh)[0]
            call = (lambda fn=fn: fn(params, {"tokens": tokens}))
        if label == "stacked":  # each rank's router call of the first run
            plain_route = moe._route
            moe._route = lambda p, xt, *a: routed.append((xt, p["router"])) or plain_route(p, xt, *a)
            try:
                first = call()[0]
            finally:
                moe._route = plain_route
            runs[label] = (first, ms(call))
        else:
            runs[label] = (call()[0], ms(call))
    compare("prefill", *(runs[k][0] for k in ("processes", "stacked", "flat")), 1e-5)
    out["prefill"]["ms"] = {k: v[1] for k, v in runs.items()}
    out["prefill"]["routing"] = routing_flips(routed, w.size, cfg.moe.top_k)
    save()
    del runs, routed
    Bd, Td = spec["small_decode"]
    cache = lm.tree_map(lambda t: t.normal_(generator=gen(SEED + 186)),
                        lm.init_cache(cfg, Bd, Td, device=dev))
    token = torch.randint(0, cfg.vocab_size, (Bd,), generator=gen(SEED + 187), device=dev,
                          dtype=torch.int32)
    pos = torch.tensor(Td - min(50, Td // 4), dtype=torch.int32, device=dev)
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    flat_cfg = cfg
    if w.size > 1 and E % w.size == 0:  # ep_block_small's capacity on the flat run
        slots = max(1, -(-(Bd * K) // E))
        flat_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=slots * E / (Bd * K)))
    runs = {}
    for label, mesh in (("processes", pmesh), ("stacked", stacked), ("flat", None)):
        c = lm.tree_map(torch.clone, cache)
        if mesh is None:
            call = (lambda c=c: lm.decode_step(params, flat_cfg, token, pos, c))
        else:
            fn = build_step(cfg, ShapeConfig("decode", Td, Bd, "decode"), mesh)[0]
            call = (lambda fn=fn, c=c: fn(params, {"token": token, "pos": pos, "cache": c}))
        runs[label] = (call()[0], ms(call))
    compare("ep_decode", *(runs[k][0] for k in ("processes", "stacked", "flat")), 1e-5)
    out["ep_decode"]["ms"] = {k: v[1] for k, v in runs.items()}
    del runs, params, cache
    sync()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0
    save()
    if on_card:
        torch.cuda.empty_cache()


def routing_flips(routed, n, k):
    """The router calls of a stacked expert-parallel run, ``n`` a layer
    (one per rank, in rank order: ``(tokens [t, d], router [d, e])``): per
    layer, how many tokens two plain products route to another set of
    top-``k`` experts than the router's own product in fixed blocks
    (``moe.router_logits``) does: one batched product over the stacked
    ranks (``[1, n, t, d] x [1, n, d, e]``) and one product over all the
    layer's tokens (``[n t, d] x [d, e]``, as a single rank takes them);
    and the tokens routed."""
    import torch

    from repro_torch.models.moe import router_logits, top_k

    def experts(logits):
        return top_k(torch.softmax(logits, dim=-1), k)[1].sort(-1).values

    batched, flat, tokens = [], [], 0
    for i in range(0, len(routed), n):
        xs, router = [x for x, _ in routed[i:i + n]], routed[i][1]
        own = torch.cat([experts(router_logits(x, router, torch.float32)) for x in xs])
        stacked = torch.einsum("...nd,...de->...ne", torch.stack(xs)[None],
                               router.expand(1, n, *router.shape))
        batched.append(int((experts(stacked[0]).flatten(0, 1) != own).any(-1).sum()))
        flat.append(int((experts(torch.cat(xs) @ router) != own).any(-1).sum()))
        tokens += own.shape[0]
    return {"batched": batched, "flat": flat, "tokens": tokens}


def process_phase(dev, *, card="", world=None, n2=16384, weak=16384, steps=STEPS,
                  one_card_ms=None, reduced=False, layers=(8, 8), decode=(8, 32768),
                  prefill=(8, 4096), small_decode=(2, 512), max_s=150.0, max_gib=70.0) -> dict:
    """Phase 17: one process per card (``repro_torch.dist.processes``),
    ``torch.cuda.device_count()`` of them on the card (``world`` gloo
    processes on the CPU for a rehearsal), each on ``cuda:rank`` over
    NCCL, started by ``torch.multiprocessing`` (spawn).

    Each process runs :func:`process_child`: the stencil cases of
    :func:`process_cases` on a 2-D process mesh (2x2 on four cards, 1 x n
    else), ``comm.allreduce`` over both axes, a ``ResilientLoop`` killed
    after its snapshot, and the language models on (data=1, model=world).
    Here, afterwards: every case's blocks are bitwise the single
    controller's ``jit=False`` run of the same mesh over the same cards
    (``Mesh`` of ``cuda:0..n-1``; one device for a world of one), by a
    SHA-256 of each rank's block; the all-reduce is the single
    controller's; the snapshot resumes on this card's single controller
    bitwise its uninterrupted run; each language model's forward is
    bitwise its stacked ranks and within phase 16's tolerances of the flat
    run.  Every part that every process ended is checked and logged; then
    a process that failed, a wait over ``max_s`` seconds or any failed
    check fails the phase.  Returns, per case, the K1 and K2 launches of
    every process summed and each process's measurements."""
    import multiprocessing

    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core.lowering import StencilInterpreter
    from repro_torch.core.passes.decompose import make_strategy_2d
    from repro_torch.dist import Mesh
    from repro_torch.kernels import stencil_apply as k1
    from repro_torch.resilience import resume

    on_card = dev.type == "cuda"
    n = torch.cuda.device_count() if on_card else int(world)
    grid = process_grid(n)
    t17 = time.perf_counter()
    log(f"phase 17: one process per card, {n} process(es) over "
        f"{'NCCL' if on_card else 'gloo'}, a {grid[0]}x{grid[1]} process mesh; {card}")
    if n == 1:
        log("phase 17: world=1, no message crosses processes")
    cases = process_cases(n, n2, weak)
    cards = np.empty(n, dtype=object)
    for r in range(n):
        cards[r] = torch.device("cuda", r) if on_card else torch.device("cpu")
    single_mesh = Mesh(cards.reshape(grid), ("x", "y"))
    if on_card:  # every source the processes launch, built here in parallel
        sources = []
        for name, (kind, bc), kw, shape in cases:
            t = api.Target(mesh=single_mesh, strategy=make_strategy_2d(grid), backend="cuda",
                           jit=False, **kw)
            sources += api.compile(process_program(kind, bc, shape), t).kernel_sources()
        k1.build(list(dict.fromkeys(sources)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="phase17-")
    spec = {"src": str(Path(__file__).resolve().parent / "src"),
            "device": "cuda" if on_card else "cpu", "n2": n2, "weak": weak, "steps": steps,
            "reduced": reduced, "layers": list(layers), "decode": list(decode),
            "prefill": list(prefill), "small_decode": list(small_decode), "dump_s": max(max_s - 10, 1.0)}
    try:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=process_child, args=(r, n, tmp, spec)) for r in range(n)]
        t_spawn = time.perf_counter()
        for p in procs:
            p.start()
        try:
            # until every process has ended, one has failed (its peers then
            # wait on it forever) or the time is up
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode not in (None, 0) for p in procs)
                   and time.perf_counter() - t_spawn < max_s):
                time.sleep(0.2)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.terminate()
            for p in procs:
                p.join(10)
        wait_s = time.perf_counter() - t_spawn
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * n:
            for r in range(n):
                path = os.path.join(tmp, f"rank{r}.log")
                if os.path.exists(path):
                    with open(path) as f:
                        log(f"  rank {r}'s progress:\n" + f.read()[-6000:])
        results = []
        for r in range(n):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
            else:
                results.append({"cases": {}})
        log(f"  {n} process(es) ran in {wait_s:.1f} s (start, process-group set-up, every case), "
            f"exit codes {codes}")
        # every part that each process ended is checked and logged before
        # the phase fails on any of them
        failed = []

        def verify(ok, msg):
            if not ok:
                failed.append(msg)
                log(f"  FAILED: {msg}")

        def ended(part):
            return all(part in res for res in results)

        # the single controller over the same cards, jit=False, block by block
        summary = {}
        for name, (kind, bc), kw, shape in cases:
            if not all(name in res["cases"] for res in results):
                continue
            prog = process_program(kind, bc, shape)
            t = api.Target(mesh=single_mesh, strategy=make_strategy_2d(grid), backend="cuda",
                           jit=False, **kw)
            step = api.compile(prog, t)
            state = _advance(step, step.shard_state(process_state(prog, cards[0])),
                             step.epochs(steps))
            for r in range(n):
                blocks = [x.shards[r] if hasattr(x, "shards") else x for x in state]
                verify([_digest(b) for b in blocks] == results[r]["cases"][name]["digest"],
                       f"phase 17 {name}: rank {r}'s block differs from the single controller's")
            del state
            api.forget(prog, t)
            recs = [res["cases"][name] for res in results]
            summary[name] = {"k1": sum(x["k1"] for x in recs), "k2": sum(x["k2"] for x in recs),
                             "per_rank": recs, "shape": shape, "kind": kind, "boundary": bc,
                             "kw": kw}
            worst = max(x["ms"] for x in recs)
            line = (f"  {name} {shape[0]}x{shape[1]} over {n} process(es), against the single "
                    f"controller; {worst:.4f} ms/step under jit (the slowest process; "
                    f"{', '.join('%.4f' % x['ms'] for x in recs)}); K1 {summary[name]['k1']}, "
                    f"K2 {summary[name]['k2']} launches in {recs[0]['epochs']} epochs")
            if on_card:
                line += ("; per process NCCL / K1 / K2 / busy device ms a step: "
                         + "; ".join(f"{x['nccl_ms']:.4f} / {x['k1_ms']:.4f} / {x['k2_ms']:.4f} / "
                                     f"{x['busy_ms']:.4f}" for x in recs)
                         + f"; graph census [K1, K2, NCCL, copies, fills] {recs[0]['census']}; "
                         + f"peak {max(x['peak_gib'] for x in recs):.2f} GiB a process")
                verify(max(x["peak_gib"] for x in recs) < max_gib,
                       f"phase 17 {name}: a process peaked over {max_gib} GiB")
            one = (one_card_ms or {}).get(name)
            if one and not name.startswith("weak"):
                line += f"; speed-up {one / worst:.2f}x over {one:.4f} ms/step on one card"
            elif one:
                line += (f"; weak-scaling efficiency {one / worst:.3f} ({one:.4f} ms/step for "
                         f"one {weak}^2 rank on one card)")
            log(line)
            if on_card:
                torch.cuda.empty_cache()
        verify(len(summary) == len(cases),
               f"phase 17: {len(cases) - len(summary)} stencil case(s) did not end on every process")

        # comm.allreduce over both axes: the single controller's ranks
        if ended("allreduce"):
            interp = StencilInterpreter(allreduce_func(), dict(single_mesh.shape),
                                        distributed=True)
            vals = [allreduce_values(r, cards[r]) for r in range(n)]
            want = interp.run_ranks([(x, torch.zeros_like(x)) for x in vals],
                                    [single_mesh.coords(r) for r in range(n)])
            for r in range(n):
                verify(want[r][0].cpu().tolist() == results[r]["allreduce"],
                       f"phase 17: comm.allreduce on rank {r} differs from the single controller")
            log(f"  comm.allreduce (sum over x and y) on {n} process(es), against the single "
                "controller's ranks")

        # the snapshot the processes wrote, resumed on this card's single controller
        if ended("snapshot"):
            prog = process_program("heat", "zero", (n2, n2))
            one = api.Target(device=str(dev), backend="cuda", jit=True, donate=True)
            t0 = time.perf_counter()
            loop = resume(prog, os.path.join(tmp, "ckpt"), one)
            verify(loop.step_count == 4, f"phase 17: the snapshot resumed at step {loop.step_count}")
            got = [api.gather(x).clone() for x in loop.run()]
            resume_s = time.perf_counter() - t0
            ref = api.compile(prog, api.Target(device=str(dev), backend="cuda", jit=False))
            for g_, w_ in zip(got, ref.time_loop(process_state(prog, dev), SNAPSHOT_STEPS)):
                verify(torch.equal(g_, w_), "phase 17: the processes' snapshot resumed on one "
                                            "device differs from the uninterrupted run")
            del got, loop
            api.forget(prog, one)
            log(f"  ResilientLoop over {n} process(es) killed at step "
                f"{results[0]['snapshot']['killed_at_step']}; its step-4 snapshot (written by "
                f"process 0) resumed on the single controller of this card in {resume_s:.2f} s, "
                "against the uninterrupted run")

        # the language models: every process bitwise its stacked ranks, and
        # within phase 16's tolerances of the flat run
        lm_recs = [res.get("lm", {}) for res in results]
        names = {"decode": f"(e) {LM_DECODE} decode logits",
                 "flash": f"(e) {LM_DECODE} seq-sharded flash-decode",
                 "prefill": "(f) granite prefill logits",
                 "ep_decode": "(f) granite B=2 decode logits (flat: at ep_block_small's capacity)"}
        for part, what in names.items():
            if not all(part in x for x in lm_recs):
                verify(False, f"phase 17 {what}: did not end on every process")
                continue
            recs = [x[part] for x in lm_recs]
            verify(all(x["bitwise"] for x in recs),
                   f"phase 17 {what}: the process mesh differs from the stacked ranks (max |diff| "
                   f"{max(x['vs_stacked'] for x in recs):.3e})")
            verify(all(x["close"] for x in recs),
                   f"phase 17 {what}: {max(x['err'] for x in recs):.3e} from the flat run, over "
                   f"{recs[0]['tol']}")
            m = recs[0]["ms"]
            line = (f"  {what} on (data=1, model={n}) processes: "
                    f"{max(x['vs_stacked'] for x in recs):.3e} from the stacked ranks "
                    f"({'bitwise' if all(x['bitwise'] for x in recs) else 'not bitwise'}), "
                    f"{max(x['err'] for x in recs):.3e} from flat; ms: processes "
                    f"{m['processes']:.3f}, stacked on one card {m['stacked']:.3f}, flat "
                    f"{m['flat']:.3f}")
            if part == "decode":
                line += (f"; layout {recs[0]['layout']}, B={decode[0]}, T={decode[1]}, "
                         f"{layers[0]} layers")
            if part == "prefill":
                rt = recs[0]["routing"]
                line += (f"; {prefill[0]}x{prefill[1]}, {layers[1]} layers, capacity factor 4.0; "
                         f"of {rt['tokens']} tokens routed, a batched router product over the "
                         f"stacked ranks would send {sum(rt['batched'])} to other experts (per "
                         f"layer {rt['batched']}), one product over all of a layer's tokens "
                         f"{sum(rt['flat'])} ({rt['flat']})")
            log(line)
        if all("peak_gib" in x for x in lm_recs):
            log(f"  language models: peak {max(x['peak_gib'] for x in lm_recs):.2f} GiB a process")
            if on_card:
                verify(max(x["peak_gib"] for x in lm_recs) < max_gib,
                       f"phase 17: a language-model process peaked over {max_gib} GiB")
        check(codes == [0] * n, f"phase 17: the processes exited with {codes} "
                                f"({len(hung)} still running after {wait_s:.1f} s were stopped)")
        check(not failed, f"phase 17: {len(failed)} check(s) failed: {failed}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sec = time.perf_counter() - t17
    log(f"phase 17: {sec:.1f} s; {card}")
    check(sec < max_s, f"phase 17 took {sec:.1f} s, more than {max_s} s")
    return summary


# --------------------------------------------------------------------------
# phase 18: tensor and data parallelism of the language models
# --------------------------------------------------------------------------

TP_DENSE, TP_MOE = "qwen2-7b", "granite-moe-1b-a400m"


def tp_config(arch, n_layers, cut=None, dtype="float32", capacity=None):
    """``arch`` at its published widths (``cut`` on the CPU), ``n_layers``
    deep, in ``dtype``; ``capacity`` the MoE capacity factor."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace((cut or (lambda c: c))(get_config(arch)), dtype=dtype,
                              n_layers=n_layers)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    return cfg


def tp_tokens(cfg, B, S, dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)


def tp_meshes(dev, shape):
    import numpy as np

    from repro_torch.dist import Mesh

    devs = np.empty(int(np.prod(shape)), dtype=object)
    for i in range(devs.size):
        devs[i] = dev
    return Mesh(devs.reshape(shape), ("data", "model"))


def tp_grads_case(dev, cfg, mesh, tokens, seed, *, flat=None, digests=False, options=None):
    """One sharded train step's loss and gradients of ``cfg`` on ``mesh``
    (stacked ranks on ``dev``, or this process's rank of a process mesh)
    from the parameters drawn with ``seed``: against ``flat`` (the flat
    port's ``(loss, metrics, grads)``) where it is given, and with
    ``digests`` the loss and the checksum (:func:`words_checksum`) of every
    rank's block of the gradients and of the state after the update (zero
    moments in).  ``options`` (default ``TrainOptions(q_chunk=...)``) may
    ask for microbatches and int8 compression: the compressed gradients
    are then held against the flat ones' compression (:func:`int8_check`)
    and digested too, and the update takes them.  Returns a record."""
    import gc

    import torch

    from repro_torch.dist.sharding import (
        block_bytes, gather_placed, place_tree, rank_block,
    )
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import ShardedTrainStep, TrainOptions, init_train_state

    on_card = dev.type == "cuda"
    B, S = tokens.shape
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(),
                            options or TrainOptions(q_chunk=min(1024, S)), mesh, B)
    pspecs = step.state_specs["params"]
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
    placed = place_tree(params, pspecs, mesh)
    del params
    gc.collect()
    batch = step.place_batch({"tokens": tokens})
    if on_card:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    (loss, metrics), grads = step.value_and_grad(placed, batch)
    if on_card:
        torch.cuda.synchronize(dev)
    rec = {"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
           "metrics": {k: float(v) for k, v in metrics.items()}}
    shapes = init_train_state(None, cfg, device="meta")
    rec["state_bytes"] = block_bytes(shapes["params"], pspecs, mesh) * 3
    rec["flat_state_bytes"] = sum(t.numel() * t.element_size()
                                  for t in lm.leaves(shapes["params"]).values()) * 3
    if flat is not None:
        f_loss, f_metrics, f_grads = flat
        rec["loss_err"] = abs(rec["loss"] - f_loss)
        worst, where = 0.0, ""
        for path, g in lm.leaves(grads).items():
            spec = lm.leaves(pspecs)[path]
            want = lm.leaves(f_grads)[path]
            got = gather_placed(g, mesh, spec)
            e = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if e > worst:
                worst, where = e, path
            del got
        rec["grad_err"], rec["grad_worst"] = worst, where
    compressed = step.compress(grads)
    if flat is not None and compressed is not grads:
        rec["int8"] = int8_check(compressed, grads, f_grads, pspecs, mesh)
    if compressed is not grads:
        grads = compressed
    del compressed
    if digests:
        ranks = (mesh.process_rank,) if mesh.processes else range(mesh.size)
        flat_g = lm.leaves(grads)
        rec["digests"] = {r: {"loss": repr(rec["loss"])} for r in ranks}
        for r in ranks:
            rec["digests"][r].update({
                f"grad {k}": words_checksum(
                    g if mesh.processes else rank_block(g, mesh, lm.leaves(pspecs)[k], r))
                for k, g in flat_g.items()})
        moments = {"m": lm.tree_map(torch.zeros_like, placed),
                   "v": lm.tree_map(torch.zeros_like, placed),
                   "count": torch.zeros((), dtype=torch.int32, device=dev)}
        new_p, new_o, _ = opt.adamw_update(step.opt_cfg, grads, moments, placed, specs=pspecs,
                                           mesh=mesh)
        del grads, moments
        for part, tree in (("params", new_p), ("m", new_o["m"]), ("v", new_o["v"])):
            for k, x in lm.leaves(tree).items():
                spec = lm.leaves(pspecs)[k]
                for r in ranks:
                    rec["digests"][r][f"{part} {k}"] = words_checksum(
                        x if mesh.processes else rank_block(x, mesh, spec, r))
        del new_p, new_o
    del placed, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return rec


def tp_flat(dev, cfg, tokens, seed, mesh=None, options=None):
    """The flat port's ``(loss, metrics, grads)`` of the parameters drawn
    with ``seed`` (under ``use_mesh(mesh)`` for an MoE config: the
    expert-parallel branch, whose aux losses are data shard 0's, as the
    sharded step's are); with ``options.microbatches = n``, the flat train
    step's loop over ``n`` microbatches of global rows (the loss and the
    metrics their means, ``g / n`` accumulated in order), before any
    compression."""
    import contextlib

    import torch

    from repro_torch.dist import use_mesh
    from repro_torch.models import lm
    from repro_torch.train.train_step import TrainOptions, make_loss_fn, value_and_grad

    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
    S = tokens.shape[1]
    ctx = use_mesh(mesh) if (mesh is not None and cfg.moe is not None) else contextlib.nullcontext()
    options = options or TrainOptions(q_chunk=min(1024, S))
    grad_fn = value_and_grad(make_loss_fn(cfg, options))
    n = max(1, options.microbatches)
    grads, losses, metricses = None, [], []
    with ctx:
        for i in range(n):
            mb = {"tokens": tokens.reshape((n, tokens.shape[0] // n) + tuple(tokens.shape[1:]))[i]}
            (loss, metrics), g = grad_fn(params, mb)
            if n == 1:
                grads = g
            else:
                grads = lm.tree_map(torch.zeros_like, g) if grads is None else grads
                grads = lm.tree_map(lambda a, x: a.add_(x / n), grads, g)
            del g
            losses.append(float(loss))
            metricses.append({k: float(v) for k, v in metrics.items()})
    del params
    # the means as the reference takes them: of the float32 values
    mean = lambda xs: float(torch.tensor(xs, dtype=torch.float32).mean())  # noqa: E731
    return (mean(losses), {k: mean([m[k] for m in metricses]) for k in metricses[0]}, grads)


def tp_trainer(dev, cfg, mesh, directory, total, B, S, seed, *, every=2, timed=None,
               options=None):
    """A ``Trainer(state_shardings=...)`` of ``cfg`` on ``mesh`` with a
    synthetic data stream of ``B`` x ``S`` tokens, its snapshots under
    ``directory`` (none with ``directory=None``)."""
    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (
        ShardedTrainStep, TrainOptions, init_placed_train_state,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig, shardings_of

    step = ShardedTrainStep(cfg, opt.OptimizerConfig(),
                            options or TrainOptions(q_chunk=min(1024, S)), mesh, B)
    data = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size, seed=seed)
    tcfg = TrainerConfig(total_steps=total, checkpoint_every=every if directory else 10**9,
                         log_every=1, checkpoint_dir=directory)
    fn = timed(step) if timed else step
    fn.place_batch = step.place_batch
    trainer = Trainer(fn, lambda: init_placed_train_state(
        torch.Generator(device=dev).manual_seed(seed), cfg, mesh, step.state_specs, device=dev),
        data, tcfg, state_shardings=shardings_of(step.state_specs, mesh))
    return trainer, step


def tp_flat_trainer(dev, cfg, directory, B, S):
    """The flat port's ``Trainer`` on ``dev`` over ``directory``'s
    snapshots (3 steps, no snapshot of its own)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainOptions, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    return Trainer(make_train_step(cfg, opt.OptimizerConfig(), TrainOptions(
        q_chunk=min(1024, S))), None, DataConfig(seq_len=S, global_batch=B,
                                                 vocab_size=cfg.vocab_size, seed=SEED + 182),
        TrainerConfig(total_steps=3, checkpoint_every=10**9, log_every=1,
                      checkpoint_dir=directory), device=dev)


# Phase 18 (g)/(h): the tensor-parallel decode with one position a row.
# qwen2-7b has 4 KV heads: each mesh gives one cache layout
# (``dist.sharding.kv_cache_layout``); (h) runs two of them over processes.
TP_DECODE_MESHES = {(1, 4): "heads", (2, 8): "seq", (1, 8): "seq_all", (8, 1): "batch"}
TP_DECODE_PROCESS_MESHES = ((1, 4), (2, 2))


def tp_decode_rows(dev, cfg, params, B, T, prompt_lens, seed):
    """``B`` prompts of distinct seeded lengths in ``prompt_lens`` (lowest,
    highest), each prefilled flat alone, its cache grown to ``T``
    (``lm.grow_cache``), the rows stacked into one ``[B]`` cache, so that
    the rows sit at ``B`` depths.  Returns ``(cache, positions [B], the
    prefills' greedy tokens [B])``."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.choice(np.arange(prompt_lens[0], prompt_lens[1] + 1), B,
                                       replace=False)]
    caches, first = [], []
    for n in lens:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(dev)
        logits, cache = lm.forward_prefill(params, cfg, toks, q_chunk=min(n, 512))
        caches.append(lm.grow_cache(cfg, cache, T, n))
        first.append(int(logits[0, :cfg.vocab_size].argmax()))
    cache = {k: {n: torch.cat([c[k][n] for c in caches], dim=1) for n in caches[0][k]}
             for k in caches[0]}
    return cache, torch.tensor(lens, device=dev), torch.tensor(first, device=dev)


def tp_decode_flat(dev, cfg, params, cache, pos, tok, steps):
    """``steps`` flat ``lm.decode_step`` s from ``cache`` (written in place),
    each row at its own position ``pos + step``, each step fed the last
    one's greedy tokens.  Returns ``(feeds, logits, caches, seconds)``: the
    tokens fed at each step, the logits and a copy of the cache after it,
    and its seconds (host clock, the card synchronized)."""
    import torch

    from repro_torch.models import lm

    feeds, outs, caches, secs = [], [], [], []
    for i in range(steps):
        feeds.append(tok)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(params, cfg, tok, pos + i, cache)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        outs.append(logits)
        caches.append(lm.tree_map(torch.clone, cache))
        tok = logits[:, :cfg.vocab_size].argmax(-1)
    return feeds, outs, caches, secs


def tp_decode_case(dev, cfg, params, mesh, cache0, pos0, feeds, *, flat=None, digests=False):
    """``launch.steps.ShardedDecode`` of ``cfg`` on ``mesh`` (stacked ranks
    on ``dev``, or this process's rank of a process mesh): the parameters
    and ``cache0`` placed (``place_tree``), one step for each of ``feeds``
    at the ``[B]`` positions ``pos0 + step``.  Returns a record: the cache
    layout, each step's seconds (host clock, synchronized), one rank's
    cache bytes against flat; against ``flat`` (the flat run's logits and
    caches a step, :func:`tp_decode_flat`) the worst logits and cache
    errors over the steps; with ``digests`` per rank the checksum of its
    logits block at every step and of its cache blocks after the last."""
    import torch

    from repro_torch.dist.sharding import (
        block_bytes, gather_placed, gather_tree, kv_cache_layout, place, place_tree, rank_block,
    )
    from repro_torch.launch.steps import ShardedDecode
    from repro_torch.models import lm

    _, B, T = cache0["slot0"]["k"].shape[:3]
    dec = ShardedDecode(cfg, mesh, B, T)
    placed = place_tree(params, dec.param_specs, mesh)
    cache = place_tree(cache0, dec.cache_specs, mesh)
    shapes = lm.init_cache(cfg, B, T, device="meta")
    rec = {"layout": kv_cache_layout(B, T, cfg.n_kv_heads, mesh), "s": [],
           "logits_err": 0.0, "cache_err": 0.0, "logits_ok": True, "cache_ok": True,
           "cache_bytes": block_bytes(shapes, dec.cache_specs, mesh),
           "flat_cache_bytes": sum(t.numel() * t.element_size()
                                   for t in lm.leaves(shapes).values())}
    ranks = (mesh.process_rank,) if mesh.processes else range(mesh.size)
    if digests:
        rec["digests"] = {r: {} for r in ranks}
    for i, tok in enumerate(feeds):
        tok = place(tok, mesh, dec.token_spec)
        _sync(dev)
        t0 = time.perf_counter()
        logits = dec(placed, tok, pos0 + i, cache)
        _sync(dev)
        rec["s"].append(time.perf_counter() - t0)
        if flat is not None:
            f_logits, f_caches = flat[0][i], flat[1][i]
            got = gather_placed(logits, mesh, dec.logits_spec)
            rec["logits_err"] = max(rec["logits_err"], float((got - f_logits).abs().max()))
            rec["logits_ok"] &= bool(torch.allclose(got, f_logits, rtol=2e-5, atol=2e-5))
            got = lm.leaves(gather_tree(cache, dec.cache_specs, mesh))
            for path, want in lm.leaves(f_caches).items():
                rec["cache_err"] = max(rec["cache_err"], float((got[path] - want).abs().max()))
                rec["cache_ok"] &= bool(torch.allclose(got[path], want, rtol=2e-5, atol=1e-4))
            del got
        for r in rec.get("digests", ()):
            block = logits if mesh.processes else rank_block(logits, mesh, dec.logits_spec, r)
            rec["digests"][r][f"logits {i}"] = words_checksum(block)
    for r in rec.get("digests", ()):
        for path, x in lm.leaves(cache).items():
            spec = lm.leaves(dec.cache_specs)[path]
            rec["digests"][r][f"cache {path}"] = words_checksum(
                x if mesh.processes else rank_block(x, mesh, spec, r))
    return rec


def tp_decode_part(dev, *, cut, card, layers, decode, prompt_lens, meshes, digests, peak,
                   free) -> dict:
    """Phase 18 (g) (see :func:`tp_phase`).  Returns what (h) holds the
    processes to: the tokens fed at each step and, with ``digests``, each
    rank's checksums on every mesh of ``TP_DECODE_PROCESS_MESHES``."""
    import statistics

    import torch

    from repro_torch.dist.sharding import place, place_tree
    from repro_torch.launch.steps import ShardedDecode
    from repro_torch.models import lm

    t0 = time.perf_counter()
    B, T, steps = decode
    cfg = tp_config(TP_DENSE, layers, cut)
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 184),
                            device=dev)
    cache0, pos0, tok0 = tp_decode_rows(dev, cfg, params, B, T, prompt_lens, SEED + 185)
    feeds, f_logits, f_caches, f_s = tp_decode_flat(
        dev, cfg, params, lm.tree_map(torch.clone, cache0), pos0, tok0, steps)
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    log(f"  (g) ShardedDecode of qwen2-7b (d_model {cfg.d_model}, {cfg.n_kv_heads} KV heads), "
        f"{layers} layers, float32, B={B} "
        f"rows prefilled alone at positions {pos0.tolist()}, T={T}, {steps} steps each row at "
        f"its own position, fed the flat run's greedy tokens: flat lm.decode_step "
        f"{med(f_s):.3f} ms a step (median; first {f_s[0] * 1e3:.3f})")
    out = {"feeds": [f.tolist() for f in feeds], "digests": {}, "ms": {}}
    runs = dict(meshes)
    if digests:
        for shape in TP_DECODE_PROCESS_MESHES:
            runs.setdefault(shape, None)
    for shape, want in runs.items():
        mesh = tp_meshes(dev, shape)
        rec = tp_decode_case(dev, cfg, params, mesh, cache0, pos0, feeds,
                             flat=(f_logits, f_caches),
                             digests=digests and shape in TP_DECODE_PROCESS_MESHES)
        if want is not None:
            check(rec["layout"] == want,
                  f"phase 18 (g) {shape}: the cache layout is {rec['layout']}, not {want}")
        check(rec["logits_ok"], f"phase 18 (g) {shape}: logits {rec['logits_err']:.3e} from "
                                "the flat decode's, over 2e-5")
        check(rec["cache_ok"], f"phase 18 (g) {shape}: the cache {rec['cache_err']:.3e} from "
                               "the flat decode's, over 2e-5 / 1e-4")
        if "digests" in rec:
            out["digests"][shape] = rec["digests"]
        out["ms"][shape] = med(rec["s"])
        log(f"  (g) {shape} {rec['layout']}: {med(rec['s']):.3f} ms a step against "
            f"{med(f_s):.3f} flat ({med(rec['s']) / med(f_s):.2f}x; first step "
            f"{rec['s'][0] * 1e3:.3f}); logits within {rec['logits_err']:.2e} of flat at every "
            f"step (limit 2e-5), the cache within {rec['cache_err']:.2e} (2e-5 / 1e-4); one "
            f"rank's cache {rec['cache_bytes'] / 1e6:.1f} MB against "
            f"{rec['flat_cache_bytes'] / 1e6:.1f} MB flat; peak {peak():.2f} GiB")
        free()
    del f_caches, f_logits
    # a [B] of equal positions against the scalar position, bitwise
    shape = next(iter(meshes))
    mesh = tp_meshes(dev, shape)
    p = int(pos0.max())
    got = []
    for pos in (p, torch.full((B,), p, device=dev)):
        dec = ShardedDecode(cfg, mesh, B, T)
        cache = place_tree(cache0, dec.cache_specs, mesh)
        logits = dec(place_tree(params, dec.param_specs, mesh),
                     place(feeds[0], mesh, dec.token_spec), pos, cache)
        got.append((logits, lm.leaves(cache)))
    (a, ca), (b, cb) = got
    check(torch.equal(a, b) and all(torch.equal(ca[k], cb[k]) for k in ca),
          f"phase 18 (g) {shape}: a [B] of equal positions differs from the scalar position")
    del got, a, b, ca, cb, cache, params, cache0
    free()
    log(f"  (g) a [B] of {p}s on {shape}: logits and every cache leaf bitwise the scalar "
        f"position's; (g) {time.perf_counter() - t0:.1f} s, peak {peak():.2f} GiB; {card}")
    return out


# Phase 18 (i)/(j): MoE on the reference's single-rank route.  Granite's 32
# experts split over no model axis of (4, 1) (one rank) or of (1, 3) (32 % 3):
# every rank routes the global tokens with the capacity of all of them.
TP_MOE_MESHES = ((4, 1), (1, 3))
TP_MOE_PROCESS_MESH = (4, 1)


class moe_drops:
    """Inside the ``with``, every MoE dispatch's dropped assignments and
    its assignments, a pair a call in call order (``.counts``): a stacked
    rank dispatches its own tokens in a call of its own (``per_rank``)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.plain = plain = moe._dispatch_scatter
        self.counts = []

        def dispatch(xt, gate_idx, E, C):
            buf, dest, kept = plain(xt, gate_idx, E, C)
            self.counts.append((int((~kept).sum()), kept.numel()))
            return buf, dest, kept

        moe._dispatch_scatter = dispatch
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._dispatch_scatter = self.plain
        return False


def tp_moe_flat_infer(cfg, params, toks, steps, feeds=None):
    """The flat prefill of ``toks`` and ``steps`` decode steps from its
    cache (grown by ``steps``), each step fed ``feeds[i]`` or, without
    ``feeds``, the last step's greedy tokens.  Returns ``(logits a step
    (the prefill's first), feeds, seconds a step (the prefill's first))``."""
    import torch

    from repro_torch.models import lm

    S = toks.shape[1]
    outs, secs, fed = [], [], []
    with torch.no_grad():
        _sync(toks.device)
        t0 = time.perf_counter()
        logits, cache = lm.forward_prefill(params, cfg, toks, q_chunk=min(1024, S))
        _sync(toks.device)
        secs.append(time.perf_counter() - t0)
        cache = lm.grow_cache(cfg, cache, S + steps, S)
        outs.append(logits)
        for i in range(steps):
            tok = feeds[i] if feeds is not None else outs[-1][:, :cfg.vocab_size].argmax(-1)
            fed.append(tok)
            _sync(toks.device)
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, tok, S + i, cache)
            _sync(toks.device)
            secs.append(time.perf_counter() - t0)
            outs.append(logits)
    return outs, fed, secs


def tp_moe_infer(cfg, params, mesh, toks, feeds, *, digests=False):
    """``ShardedPrefill`` of ``toks`` on ``mesh`` (stacked ranks, or this
    process's rank of a process mesh) and one ``ShardedDecode`` step for
    each of ``feeds`` at positions S, S+1, ... from the prefill's own cache
    (gathered, grown, placed).  Returns ``(logits a step, gathered (the
    prefill's first), seconds a step, per rank the checksums of its logits
    blocks)``."""
    from repro_torch.dist.sharding import (
        gather_placed, gather_tree, place, place_tree, rank_block,
    )
    from repro_torch.launch.steps import ShardedDecode, ShardedPrefill
    from repro_torch.models import lm

    dev = toks.device
    B, S = toks.shape
    T = S + len(feeds)
    pre = ShardedPrefill(cfg, mesh, B, S, q_chunk=min(1024, S))
    placed = place_tree(params, pre.param_specs, mesh)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = pre(placed, {"tokens": place(toks, mesh, pre.batch_specs["tokens"])})
    _sync(dev)
    secs = [time.perf_counter() - t0]
    blocks = [(logits, pre.logits_spec)]
    dec = ShardedDecode(cfg, mesh, B, T)
    cache = place_tree(lm.grow_cache(cfg, gather_tree(cache, pre.cache_specs, mesh), T, S),
                       dec.cache_specs, mesh)
    for i, tok in enumerate(feeds):
        tok = place(tok, mesh, dec.token_spec)
        _sync(dev)
        t0 = time.perf_counter()
        logits = dec(placed, tok, S + i, cache)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        blocks.append((logits, dec.logits_spec))
    ranks = (mesh.process_rank,) if mesh.processes else range(mesh.size)
    sums = {r: {f"logits {i}": words_checksum(x if mesh.processes else rank_block(x, mesh, s, r))
                for i, (x, s) in enumerate(blocks)} for r in ranks} if digests else {}
    return [gather_placed(x, mesh, s) for x, s in blocks], secs, sums


def tp_moe_part(dev, *, cut, card, layers, tokens, capacity, meshes, steps, digests, peak,
                free) -> dict:
    """Phase 18 (i) (see :func:`tp_phase`).  Returns what (j) holds the
    processes to: the decode's feeds and, with ``digests``, each rank's
    checksums on :data:`TP_MOE_PROCESS_MESH`."""
    import statistics

    import torch

    from repro_torch.models import lm

    t0 = time.perf_counter()
    B, S = tokens
    cfg = tp_config(TP_MOE, layers, cut, capacity=capacity)
    seed, toks = SEED + 186, tp_tokens(cfg, B, S, dev, SEED + 187)
    on_card = dev.type == "cuda"
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731

    def reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

    free()
    reset()
    tf = time.perf_counter()
    with moe_routing() as f_route:
        flat = tp_flat(dev, cfg, toks, seed)
    f_s, f_peak = time.perf_counter() - tf, peak()
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
    with moe_routing() as f_iroute, moe_drops() as f_drops:
        f_out, feeds, f_secs = tp_moe_flat_infer(cfg, params, toks, steps)
    dropped = sum(d for d, _ in f_drops.counts[:cfg.n_layers])
    assigned = sum(n for _, n in f_drops.counts[:cfg.n_layers])
    log(f"  (i) granite-moe-1b-a400m (d_model {cfg.d_model}, {cfg.moe.num_experts} experts, "
        f"top-{cfg.moe.top_k}, capacity factor {cfg.moe.capacity_factor}), {layers} layers, "
        f"float32, {B}x{S} tokens, MoE on the single-rank route: flat train step "
        f"{f_s * 1e3:.0f} ms (peak {f_peak:.2f} GiB), prefill {f_secs[0] * 1e3:.1f} ms, "
        f"decode {med(f_secs[1:]):.3f} ms a step (median of {steps}); the prefill dropped "
        f"{dropped} of {assigned} assignments over its {cfg.n_layers} layers")
    out = {"feeds": [f.tolist() for f in feeds], "digests": {}, "peak_gib": f_peak}
    for shape in meshes:
        tm = time.perf_counter()
        mesh = tp_meshes(dev, shape)
        n = mesh.size
        keep = digests and shape == TP_MOE_PROCESS_MESH
        free()
        reset()
        with moe_routing() as s_route:
            rec = tp_grads_case(dev, cfg, mesh, toks, seed, flat=flat, digests=keep)
        s_peak = peak()
        calls = s_route.calls
        check(len(calls) == n * len(f_route.calls) and all(
            torch.equal(calls[i], calls[i - i % n]) for i in range(len(calls))),
            f"phase 18 (i) {shape}: the ranks did not route every token alike")
        ties = ""
        if any(not torch.equal(a, b) for a, b in zip(calls[::n], f_route.calls)):
            # a top-k near-tie routed otherwise: the flat step again with the
            # sharded step's choices there (see moe_routing)
            unpinned = (rec["loss_err"], rec["grad_err"], rec["grad_worst"])
            with moe_routing(pin=calls[::n]) as pinned:
                pflat = tp_flat(dev, cfg, toks, seed)
            rec = tp_grads_case(dev, cfg, mesh, toks, seed, flat=pflat, digests=keep)
            del pflat
            check(pinned.pinned > 0 and pinned.gap < 1e-5,
                  f"phase 18 (i) {shape}: {pinned.pinned} token(s) pinned, the largest margin "
                  f"{pinned.gap:.3e} (a routing difference that is no near-tie)")
            ties = (f"; {pinned.pinned} token routing(s) differed from flat at top-k near-ties "
                    f"(margin <= {pinned.gap:.2e}; unpinned: loss {unpinned[0]:.2e}, gradient "
                    f"{unpinned[2]} {unpinned[1]:.2e}), so the flat step took the sharded "
                    "step's choices there")
        del calls, s_route
        check(rec["loss_err"] <= 1e-5,
              f"phase 18 (i) {shape}: loss {rec['loss']:.7f} is {rec['loss_err']:.3e} from flat")
        check(rec["grad_err"] <= 1e-4,
              f"phase 18 (i) {shape}: gradient {rec['grad_worst']} is {rec['grad_err']:.3e} of its "
              "largest magnitude from flat")
        free()
        with moe_routing() as s_iroute, moe_drops() as s_drops:
            got, secs, sums = tp_moe_infer(cfg, params, mesh, toks, feeds, digests=keep)
        want = f_out
        if any(not torch.equal(a, b) for a, b in zip(s_iroute.calls[::n], f_iroute.calls)):
            with moe_routing(pin=s_iroute.calls[::n]) as pinned:
                want = tp_moe_flat_infer(cfg, params, toks, steps, feeds)[0]
            check(pinned.pinned > 0 and pinned.gap < 1e-5,
                  f"phase 18 (i) {shape}: prefill/decode: {pinned.pinned} token(s) pinned, the "
                  f"largest margin {pinned.gap:.3e}")
            ties += (f"; prefill/decode: {pinned.pinned} token routing(s) at near-ties pinned "
                     f"(margin <= {pinned.gap:.2e})")
        else:
            # every rank drops what flat drops, layer by layer, step by step
            check(s_drops.counts[::n] == f_drops.counts and all(
                s_drops.counts[i] == s_drops.counts[i - i % n] for i in range(len(s_drops.counts))),
                f"phase 18 (i) {shape}: the ranks' drops differ from flat's")
        p_err = float((got[0] - want[0]).abs().max())
        d_err = max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:]))
        check(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5),
              f"phase 18 (i) {shape}: prefill logits {p_err:.3e} from flat, over 1e-5")
        check(all(torch.allclose(g, w, rtol=2e-5, atol=2e-5) for g, w in zip(got[1:], want[1:])),
              f"phase 18 (i) {shape}: decode logits {d_err:.3e} from flat, over 2e-5")
        r_dropped = sum(d for d, _ in s_drops.counts[:n * cfg.n_layers:n])
        if keep:
            out["digests"] = {r: dict(rec["digests"][r], **sums[r]) for r in rec["digests"]}
        log(f"  (i) {shape}, {n} ranks stacked: loss {rec['loss']:.6f} ({rec['loss_err']:.2e} "
            f"from flat; every gradient leaf within {rec['grad_err']:.2e} of its max, worst "
            f"{rec['grad_worst']}); train step {rec['ms']:.0f} ms against {f_s * 1e3:.0f} flat "
            f"({rec['ms'] / (f_s * 1e3):.2f}x), peak {s_peak:.2f} GiB for the {n} ranks "
            f"(flat {f_peak:.2f}); prefill logits within {p_err:.2e} of flat (limit 1e-5), "
            f"{secs[0] * 1e3:.1f} ms against {f_secs[0] * 1e3:.1f}; decode logits within "
            f"{d_err:.2e} (limit 2e-5) at each of {steps} steps, {med(secs[1:]):.3f} ms a step "
            f"(median) against {med(f_secs[1:]):.3f} flat; each rank's prefill dropped "
            f"{r_dropped} of {assigned} assignments (flat {dropped}){ties}; "
            f"{time.perf_counter() - tm:.1f} s")
        out["peak_gib"] = max(out["peak_gib"], s_peak)
        del got, want, secs
    del flat, params, f_out
    free()
    log(f"  (i) {time.perf_counter() - t0:.1f} s, peak {peak():.2f} GiB; {card}")
    return out


def words_checksum(t) -> str:
    """A checksum of a float32 or int32 tensor's bits, computed where the
    tensor lies: the plain int64 sum of its 32-bit words and their sum
    weighted by a pseudo-random odd int64 a position (both wrapping), so
    any one changed word changes it.  Phase 18 compares blocks of tens of
    GB by it: a SHA-256 of them on the host took most of the phase."""
    import torch

    words = t.detach().contiguous().reshape(-1).view(torch.int32)
    plain = weighted = 0
    step = 1 << 26
    for i in range(0, words.numel(), step):
        w = words[i:i + step].long()
        pos = torch.arange(i, i + w.numel(), device=w.device, dtype=torch.int64)
        mult = (pos * -7046029254386353131 + 1442695040888963407) | 1
        plain += int(w.sum())
        weighted += int((w * mult).sum())
    return f"{plain}:{weighted & (2**64 - 1)}"


def int8_check(compressed, grads, flat_grads, specs, mesh) -> dict:
    """The sharded step's int8-compressed gradients against the flat
    gradients' compression (``dist.compression.int8_roundtrip``), leaf by
    leaf: every element within one quantization step of the flat leaf
    (``max |g| / 127``) plus the difference of the two leaves' maxima (a
    value of ``q`` steps moves by ``q / 127`` of it with the scale) and
    the float32 rounding of the two dequantized values (``max * 2**-23``),
    and equal where the gradients before compression are equal and so are
    the maxima.  Returns the worst share of that bound, where, and the
    elements that differ where they had to be equal (must be 0)."""
    from repro_torch.dist.compression import int8_roundtrip
    from repro_torch.dist.sharding import gather_placed
    from repro_torch.models import lm

    worst, where, unequal = 0.0, "", 0
    cl, gl, sl = lm.leaves(compressed), lm.leaves(grads), lm.leaves(specs)
    for path, want in lm.leaves(flat_grads).items():
        got_c = gather_placed(cl[path], mesh, sl[path])
        got = gather_placed(gl[path], mesh, sl[path])
        want_c = int8_roundtrip({"x": want})["x"]
        m_got, m_want = float(got.abs().max()), float(want.abs().max())
        bound = m_want / 127.0 + abs(m_got - m_want) + m_want * 2.0**-23
        share = float((got_c - want_c).abs().max()) / max(bound, 1e-30)
        if share > worst:
            worst, where = share, path
        if m_got == m_want:
            same = got == want
            unequal += int((got_c[same] != want_c[same]).sum())
        del got_c, got, want_c
    return {"worst": worst, "where": where, "unequal": unequal}


def tp_checksums(state, specs=None, mesh=None) -> dict:
    """Per leaf of a train state (placed by ``specs`` on ``mesh``, or
    whole), :func:`words_checksum` of its gathered global tensor, so that a
    restored state is held bitwise against the saved one without a second
    copy of either (a collective on a process mesh)."""
    from repro_torch.dist.sharding import gather_placed
    from repro_torch.train.optimizer import paths

    out = {}
    for path, x in paths(state):
        if specs is not None:
            spec = specs
            for k in path:
                spec = spec[k]
            x = gather_placed(x, mesh, spec)
        out[".".join(path)] = words_checksum(x)
        del x
    return out


def tp_timed(dev, times, profile_step=None, profiles=None):
    """A wrapper of a train step that starts every call from a barrier (on
    a process mesh) and records its seconds on this process once the card
    has finished it; the call ``profile_step`` (1-based) runs under the
    profiler, whose device time by kernel goes to ``profiles``."""
    import torch

    def wrap(step):
        def run(state, batch):
            from repro_torch.dist import processes

            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if processes.initialized():
                processes.barrier()
            t0 = time.perf_counter()
            if profile_step is not None and len(times) + 1 == profile_step:
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if dev.type == "cuda" else [])
                with profile(activities=acts) as prof:
                    out = step(state, batch)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                us = [(e.key, getattr(e, "self_device_time_total", 0)
                       or getattr(e, "self_cuda_time_total", 0)) for e in rows]
                profiles.append({"busy_us": sum(u for _, u in us),
                                 "nccl_us": sum(u for k, u in us if "nccl" in k.lower())})
            else:
                out = step(state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            return out

        return run

    return wrap


# Phase 18 (f)'s limit on step 1's bfloat16 loss against the flat bfloat16
# forward at qwen2-7b's full depth.  On four H100s the sound sharded step
# read 1.802e-04 from it (2.623e-04 with its bf16 partials summed in
# float32: rounding noise of ~1e-4 either way), and the same forward with
# one SwiGLU psum dropped 1.423e-03; 6e-4 lies between (about their
# geometric mean), and the planted fault must read over it in every run.
TP_BF16_LOSS_TOL = 6e-4


def psum_variant(*, drop_layer=None, float32=False):
    """Phase 18 (f)'s variants of the tensor-parallel forward's psums
    (``models.tp.psum``), inside the ``with``: ``drop_layer`` plants a
    fault (the SwiGLU of that layer, 0-based, returns its ranks' partial
    sums unreduced; a forward runs one SwiGLU a layer, in order, so use a
    fresh ``with`` for each forward); ``float32`` sums bfloat16 partials
    in float32 and rounds the sum once, as a flat product does."""
    import contextlib

    import torch

    from repro_torch.models import tp

    swiglu, psum, calls = tp.swiglu, tp.psum, [0]

    def psum32(y, axes, mesh):
        if y.dtype != torch.bfloat16:
            return psum(y, axes, mesh)
        return psum(y.float(), axes, mesh).to(y.dtype)

    def faulty(*args):
        calls[0] += 1
        if calls[0] - 1 != drop_layer:
            return swiglu(*args)
        tp.psum = lambda y, axes, mesh: y
        try:
            return swiglu(*args)
        finally:
            tp.psum = psum

    @contextlib.contextmanager
    def patched():
        tp.swiglu, tp.psum = (faulty if drop_layer is not None else swiglu,
                              psum32 if float32 else psum)
        try:
            yield
        finally:
            tp.swiglu, tp.psum = swiglu, psum

    return patched()


def tp_child(rank, world, tmp, spec):
    """One process of phase 18's four-card part (d)-(f) and (h), on ``cuda:rank``
    over NCCL (gloo on the CPU for a rehearsal); it rewrites
    ``<tmp>/rank<r>.json`` after every part and logs its progress to
    ``<tmp>/rank<r>.log``."""
    import faulthandler
    import gc

    sys.path.insert(0, spec["src"])
    import torch

    from repro_torch.configs.base import reduced_config
    from repro_torch.dist import processes
    from repro_torch.dist.sharding import block_bytes

    progress = open(os.path.join(tmp, f"rank{rank}.log"), "w", buffering=1)
    faulthandler.dump_traceback_later(spec["dump_s"], file=progress)
    t0 = time.perf_counter()

    def note(msg):
        progress.write(f"{time.perf_counter() - t0:7.1f} s  {msg}\n")

    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    cut = reduced_config if spec["reduced"] else None
    w = processes.init(device=spec["device"], rank=rank, world_size=world, local_rank=rank,
                       init_method=f"file://{os.path.abspath(os.path.join(tmp, 'store'))}",
                       timeout_s=180)
    dev = w.device
    on_card = dev.type == "cuda"
    out = {"rank": rank}

    def save():
        path = os.path.join(tmp, f"rank{rank}.json")
        with open(path + ".part", "w") as f:
            json.dump(out, f)
        os.replace(path + ".part", path)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    try:
        # (d) the grads cases on process meshes
        out["d"] = {}
        for name, arch, layers, shape, capacity in spec["cases"]:
            cfg = tp_config(arch, layers, cut, capacity=capacity)
            mesh = processes.process_mesh(shape, ("data", "model"))
            B, S = spec["tokens"]
            rec = tp_grads_case(dev, cfg, mesh, tp_tokens(cfg, B, S, dev, SEED + 181), SEED + 180,
                                digests=True)
            rec["digests"] = rec["digests"][rank]
            out["d"][name] = rec
            save()
            note(f"(d) {name}")
            free()
        # (e) saved on (1, 4) processes, resumed on (2, 2) processes
        cfg = tp_config(TP_DENSE, spec["trainer_layers"], cut)
        B, S = spec["tokens"]
        ck = os.path.join(tmp, "ckpt")
        m14 = processes.process_mesh((1, world), ("data", "model"))
        trainer, step = tp_trainer(dev, cfg, m14, ck, 2, B, S, SEED + 182)
        trainer.run()
        out["e"] = {"saved": tp_checksums(trainer.state, step.state_specs, m14)}
        del trainer, step
        free()
        note("(e) written")
        m22 = processes.process_mesh((2, world // 2), ("data", "model"))
        trainer, step = tp_trainer(dev, cfg, m22, ck, 3, B, S, SEED + 182)
        out["e"]["start"] = trainer.start_step
        out["e"]["restored"] = tp_checksums(trainer.state, step.state_specs, m22)
        out["e"]["loss3"] = trainer.run()["metrics"][-1]["loss"]
        del trainer, step
        free()
        save()
        note("(e) resumed")
        # (f) qwen2-7b at full depth, bf16 compute, float32 state, on (1, 4)
        cfg = tp_config(TP_DENSE, spec["full_layers"], cut, dtype="bfloat16")
        B, S = spec["full_tokens"]
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        times, profiles = [], []
        trainer, step = tp_trainer(dev, cfg, m14, None, 3, B, S, SEED + 183,
                                   timed=tp_timed(dev, times, profile_step=3,
                                                  profiles=profiles))
        import dataclasses

        from repro_torch.data.pipeline import make_source
        from repro_torch.train import optimizer as opt
        from repro_torch.train.train_step import ShardedTrainStep, TrainOptions, init_train_state

        # the forward alone of the initial parameters on step 1's batch: in
        # float32, and in float32 and bfloat16 with one psum dropped
        params = trainer.state["params"]
        batch = step.place_batch(make_source(trainer.data_cfg).batch_at(0))
        s32 = ShardedTrainStep(dataclasses.replace(cfg, dtype="float32"), opt.OptimizerConfig(),
                               TrainOptions(q_chunk=min(1024, S)), m14, B)
        forward = {"float32": float(s32.loss(params, batch)[0])}
        for name, st in (("float32", s32), ("bfloat16", step)):
            with psum_variant(drop_layer=spec["full_layers"] // 2):
                forward[name + " fault"] = float(st.loss(params, batch)[0])
        with psum_variant(float32=True):
            forward["bfloat16 float32-psums"] = float(step.loss(params, batch)[0])
        del params, batch, s32
        free()
        note("(f) forwards")
        shapes = init_train_state(None, cfg, device="meta")
        run = trainer.run()
        out["f"] = {
            "forward": forward,
            "losses": [m["loss"] for m in run["metrics"] if "loss" in m],
            "s": times, "profile": profiles,
            "state_bytes": block_bytes(shapes["params"], step.state_specs["params"], m14) * 4,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0,
        }
        del trainer, step
        free()
        save()
        note("(f)")
        # (h) (g)'s per-row decode on process meshes, checksums of every block
        import statistics

        from repro_torch.models import lm

        d = spec["decode"]
        cfg = tp_config(TP_DENSE, d["layers"], cut)
        params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 184),
                                device=dev)
        B, T, _ = d["shape"]
        cache0, pos0, _ = tp_decode_rows(dev, cfg, params, B, T, d["prompt_lens"], SEED + 185)
        feeds = [torch.tensor(f, device=dev) for f in d["feeds"]]
        out["h"] = {}
        for shape in TP_DECODE_PROCESS_MESHES:
            mesh = processes.process_mesh(shape, ("data", "model"))
            rec = tp_decode_case(dev, cfg, params, mesh, cache0, pos0, feeds, digests=True)
            out["h"][str(list(shape))] = {"digests": rec["digests"][rank], "layout": rec["layout"],
                                          "ms": statistics.median(rec["s"]) * 1e3}
            del rec
            free()
            save()
            note(f"(h) {shape}")
        del params, cache0
        free()
        # (j) (i)'s (4, 1) on processes, checksums of every block
        m = spec["moe"]
        cfg = tp_config(TP_MOE, m["layers"], cut, capacity=m["capacity"])
        B, S = m["tokens"]
        mesh = processes.process_mesh(TP_MOE_PROCESS_MESH, ("data", "model"))
        toks = tp_tokens(cfg, B, S, dev, SEED + 187)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        rec = tp_grads_case(dev, cfg, mesh, toks, SEED + 186, digests=True)
        free()
        params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 186),
                                device=dev)
        _, secs, sums = tp_moe_infer(cfg, params, mesh, toks,
                                     [torch.tensor(f, device=dev) for f in m["feeds"]],
                                     digests=True)
        out["j"] = {"digests": dict(rec["digests"][rank], **sums[rank]), "loss": rec["loss"],
                    "ms": rec["ms"], "prefill_ms": secs[0] * 1e3,
                    "decode_ms": statistics.median(secs[1:]) * 1e3,
                    "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0}
        del rec, params, toks
        free()
        save()
        note("(j)")
        out["done"] = True
        save()
        processes.barrier()
    except BaseException:
        import traceback

        note("failed:\n" + traceback.format_exc())
        progress.close()
        os._exit(1)
    faulthandler.cancel_dump_traceback_later()
    processes.shutdown()
    progress.close()


def tp_phase(dev, *, card="", cut=None, dense_layers=4, moe_layers=8, trainer_layers=1,
             tokens=(2, 2048), full_layers=28, full_tokens=(4, 4096), decode_layers=4,
             decode=(8, 512, 16), prompt_lens=(16, 250), decode_meshes=None,
             moe_tokens=(8, 2048), moe_capacity=None, moe_meshes=TP_MOE_MESHES, moe_steps=8,
             processes=None) -> None:
    """Phase 18: tensor and data parallelism of the language models
    (``train_step.ShardedTrainStep``, ``Trainer(state_shardings=...)``).

    On this card, the ranks stacked: (a) qwen2-7b at published width,
    ``dense_layers`` of its 28 layers, float32, ``tokens`` (B, S), on
    (data=1, model=4) and (2, 2): the loss within 1e-5 of the flat port,
    every gradient leaf within 1e-4 of its largest magnitude, one rank's
    state bytes against flat; (b) granite-moe-1b-a400m, ``moe_layers``
    layers, capacity factor 4.0, on (2, 2) (tensor-parallel attention,
    expert-parallel experts, data parallelism), the same checks against
    the flat port under the same mesh (its expert-parallel branch); (c) a
    ``Trainer(state_shardings=...)`` of (a)'s config (``trainer_layers``
    deep) on (1, 4), 3 steps with a snapshot at step 2, resumed on (2, 2)
    and on one device (the flat trainer): each restored state bitwise the
    snapshot, step 3's loss within 1e-5 of the uninterrupted run's; (g)
    the tensor-parallel decode, one position a row (:func:`tp_decode_part`):
    qwen2-7b, ``decode_layers`` layers, float32, ``decode`` = (B, T,
    steps): B prompts of distinct seeded lengths in ``prompt_lens``
    prefilled flat one at a time, grown to T and stacked, ``steps`` steps
    of ``ShardedDecode`` at ``[B]`` positions fed the flat run's greedy
    tokens on each mesh of ``decode_meshes`` (mesh shape: the cache layout
    it must give; default :data:`TP_DECODE_MESHES`): logits within 2e-5
    and the cache within 2e-5 / 1e-4 of the flat ``lm.decode_step`` at
    every step, ms a step against flat, one rank's cache bytes against
    flat; on the first mesh a ``[B]`` of equal positions bitwise the
    scalar position; (i) MoE on the reference's single-rank route
    (:func:`tp_moe_part`): granite-moe-1b-a400m, ``moe_layers`` layers,
    capacity factor ``moe_capacity`` (default the published 1.25: tokens
    drop), float32, ``moe_tokens`` (B, S) on each mesh of ``moe_meshes``
    (default (4, 1) and (1, 3): no model axis of more than one rank holds
    the 32 experts), against the flat port without a mesh: the train
    step's loss within 1e-5 and every gradient leaf within 1e-4 of its
    largest magnitude, the prefill's logits within 1e-5, ``moe_steps``
    decode steps from the prefill's own cache, fed the flat run's greedy
    tokens, within 2e-5; every rank routes every token alike and drops
    what flat drops (a top-k near-tie pins flat to the sharded run's
    choices, :class:`moe_routing`); ms against flat, dropped assignments,
    the card's peak.

    With ``processes`` (four cards: ``python3 chip_smoke.py --phase 18``;
    or gloo processes on the CPU for a rehearsal) four processes then run
    (d) (a) and (b) on process meshes, the loss and every block of the
    gradients and the updated state bitwise the stacked ranks (a checksum
    of each block's words, computed on its card: :func:`words_checksum`);
    (e) (c) saved on (1, 4) processes and resumed on (2, 2) processes; (f)
    qwen2-7b at published width and ``full_layers`` depth, bfloat16
    compute, float32 state, ``TrainOptions(remat=True, q_chunk=1024)``,
    ``full_tokens`` synthetic tokens on (1, 4), 3 ``Trainer`` steps: ms a
    step and tokens/s from a barrier (the slowest process), peak memory,
    state bytes and the share of device time in NCCL (step 3, profiled);
    its losses finite; the sharded forward of the initial parameters on
    step 1's batch in float32 within 1e-5 of the flat port's float32
    forward on one card (``no_grad``), where the same forward with one
    row-parallel psum dropped (:func:`psum_variant`) must read more than
    1e-5 from it; step 1's bfloat16 loss within ``TP_BF16_LOSS_TOL`` of the
    flat bfloat16 forward, where the bfloat16 forward with that psum
    dropped must read more than it; (h) (g) on the process meshes of
    ``TP_DECODE_PROCESS_MESHES``, every step's logits block and the last
    cache blocks of each rank bitwise (g)'s stacked ranks (the stacked
    side runs the meshes (g) lacks too); (j) (i) on a (4, 1) process mesh
    (:data:`TP_MOE_PROCESS_MESH`): the loss and every block of the
    gradients and the updated state, the prefill's and every decode
    step's logits blocks bitwise (i)'s stacked ranks, a process's peak.

    The phase must take under 150 s and 70 GiB on one card, 300 s and 75
    GiB a card with its processes."""
    import gc

    import torch

    on_card = dev.type == "cuda"
    gib = 2**30
    max_s = 300.0 if processes else 150.0
    max_gib = 75.0 if processes else 70.0
    t18 = time.perf_counter()
    seed = SEED + 180

    def free():
        gc.collect()
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    def peak() -> float:
        return torch.cuda.max_memory_allocated(dev) / gib if on_card else 0.0

    free()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"phase 18: language models tensor- and data-parallel (ShardedTrainStep, "
        f"Trainer(state_shardings=...)), the ranks stacked on this card; {card}")
    B, S = tokens
    cases = [("(a) qwen2-7b (1, 4)", TP_DENSE, dense_layers, (1, 4), None),
             ("(a) qwen2-7b (2, 2)", TP_DENSE, dense_layers, (2, 2), None),
             ("(b) granite-moe-1b-a400m (2, 2)", TP_MOE, moe_layers, (2, 2), 4.0)]
    stacked = {}
    reports = {}
    flat_cache = {}
    for name, arch, layers, shape, capacity in cases:
        t0 = time.perf_counter()
        cfg = tp_config(arch, layers, cut, capacity=capacity)
        mesh = tp_meshes(dev, shape)
        toks = tp_tokens(cfg, B, S, dev, SEED + 181)
        key = (arch, capacity if cfg.moe is None else shape)
        if key not in flat_cache:
            flat_cache.clear()
            free()
            tf = time.perf_counter()
            flat_cache[key] = tp_flat(dev, cfg, toks, seed, mesh) + (time.perf_counter() - tf,)
        f_loss, f_metrics, f_grads, f_s = flat_cache[key]
        rec = tp_grads_case(dev, cfg, mesh, toks, seed, flat=(f_loss, f_metrics, f_grads),
                            digests=bool(processes))
        stacked[name] = rec
        check(rec["loss_err"] <= 1e-5,
              f"phase 18 {name}: loss {rec['loss']:.7f} is {rec['loss_err']:.3e} from the flat "
              f"port's {f_loss:.7f}")
        check(rec["grad_err"] <= 1e-4,
              f"phase 18 {name}: gradient {rec['grad_worst']} is {rec['grad_err']:.3e} of its "
              "largest magnitude from the flat port's")
        log(f"  {name}: {layers} layers, {B}x{S} tokens, float32: loss {rec['loss']:.6f} "
            f"({rec['loss_err']:.2e} from flat), every gradient leaf within {rec['grad_err']:.2e} "
            f"of its max (worst {rec['grad_worst']}); one rank's state (params, m, v) "
            f"{rec['state_bytes'] / 1e9:.3f} GB against {rec['flat_state_bytes'] / 1e9:.3f} GB "
            f"flat ({rec['state_bytes'] / rec['flat_state_bytes']:.3f}); loss and gradients "
            f"{rec['ms']:.0f} ms stacked, {f_s * 1e3:.0f} ms flat; "
            f"{time.perf_counter() - t0:.1f} s, peak {peak():.2f} GiB")
    flat_cache.clear()
    free()

    # (c) a Trainer on (1, 4), its snapshot resumed on (2, 2) and on one device
    t0 = time.perf_counter()
    cfg = tp_config(TP_DENSE, trainer_layers, cut)
    tmp = tempfile.mkdtemp(prefix="phase18-")
    try:
        ck = os.path.join(tmp, "ckpt")
        trainer, step = tp_trainer(dev, cfg, tp_meshes(dev, (1, 4)), ck, 2, B, S, SEED + 182)
        trainer.run()
        save_s = dict(trainer.ckpt.last_save)
        saved = tp_checksums(trainer.state, step.state_specs, step.mesh)
        del trainer, step
        free()
        trainer, step = tp_trainer(dev, cfg, tp_meshes(dev, (2, 2)), ck, 3, B, S, SEED + 182)
        check(trainer.start_step == 2, f"phase 18 (c): resumed at step {trainer.start_step}")
        check(tp_checksums(trainer.state, step.state_specs, step.mesh) == saved,
              "phase 18 (c): the state restored on (2, 2) differs from the saved state")
        l22 = trainer.run()["metrics"][-1]["loss"]
        del trainer, step
        free()
        flat = tp_flat_trainer(dev, cfg, ck, B, S)
        check(flat.start_step == 2, f"phase 18 (c): one device resumed at step {flat.start_step}")
        check(tp_checksums(flat.state) == saved,
              "phase 18 (c): the state restored on one device differs from the saved state")
        l1 = flat.run()["metrics"][-1]["loss"]
        del flat
        free()
        check(abs(l22 - l1) <= 1e-5, f"phase 18 (c): step 3 resumed on (2, 2), loss {l22:.7f}, "
                                     f"is {abs(l22 - l1):.3e} from one device's {l1:.7f}")
        log(f"  (c) Trainer(state_shardings) of qwen2-7b, {trainer_layers} layer(s), on (1, 4): "
            f"2 steps and the step-2 snapshot (to host {save_s.get('to_host_s', 0):.1f} s, write "
            f"{save_s.get('write_s', 0):.1f} s), resumed on (2, 2) and on one device, each "
            f"restored state bitwise the saved one (checksums of every gathered leaf); step 3 "
            f"loss {l22:.6f} on (2, 2), {l1:.6f} on one device; "
            f"{time.perf_counter() - t0:.1f} s, peak {peak():.2f} GiB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reports["c"] = saved

    # (g) the tensor-parallel decode, one position a row, on each cache layout
    decoded = tp_decode_part(dev, cut=cut, card=card, layers=decode_layers, decode=decode,
                             prompt_lens=prompt_lens, meshes=decode_meshes or TP_DECODE_MESHES,
                             digests=bool(processes), peak=peak, free=free)
    check(peak() < max_gib, f"phase 18: peaked at {peak():.2f} GiB, over {max_gib}")
    # (i) MoE on the reference's single-rank route
    moe = tp_moe_part(dev, cut=cut, card=card, layers=moe_layers, tokens=moe_tokens,
                      capacity=moe_capacity, meshes=moe_meshes, steps=moe_steps,
                      digests=bool(processes), peak=peak, free=free)
    check(moe["peak_gib"] < max_gib, f"phase 18 (i): peaked at {moe['peak_gib']:.2f} GiB, over "
                                     f"{max_gib}")
    if processes:
        tp_processes_part(dev, processes, stacked, cases, cut=cut, card=card, tokens=tokens,
                          trainer_layers=trainer_layers, full_layers=full_layers,
                          full_tokens=full_tokens, decoded=decoded,
                          decode=dict(layers=decode_layers, shape=list(decode),
                                      prompt_lens=list(prompt_lens)),
                          moe=dict(layers=moe_layers, tokens=list(moe_tokens),
                                   capacity=moe_capacity, steps=moe_steps, feeds=moe["feeds"],
                                   digests=moe["digests"]),
                          max_s=max_s - (time.perf_counter() - t18))
    sec = time.perf_counter() - t18
    log(f"phase 18: {sec:.1f} s; {card}")
    check(sec < max_s, f"phase 18 took {sec:.1f} s, more than {max_s} s")


def tp_processes_part(dev, world, stacked, cases, *, cut, card, tokens, trainer_layers,
                      full_layers, full_tokens, decoded, decode, moe, max_s) -> None:
    """Phase 18 (d)-(f), (h) and (j) over ``world`` processes (see
    :func:`tp_phase`), in the ``max_s`` seconds left of the phase;
    ``decoded`` is what (g) returned, ``decode`` (g)'s sizes, ``moe``
    (i)'s sizes, feeds and stacked checksums."""
    import dataclasses
    import gc
    import math
    import multiprocessing

    import torch

    on_card = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="phase18p-")
    spec = {"src": str(Path(__file__).resolve().parent / "src"),
            "device": "cuda" if on_card else "cpu", "reduced": cut is not None,
            "cases": [list(c) for c in cases], "tokens": list(tokens),
            "trainer_layers": trainer_layers, "full_layers": full_layers,
            "full_tokens": list(full_tokens), "dump_s": max(max_s - 20, 30.0),
            "decode": dict(decode, feeds=decoded["feeds"]),
            "moe": {k: v for k, v in moe.items() if k != "digests"}}
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    log(f"phase 18 (d)-(f), (h), (j): {world} processes over {'NCCL' if on_card else 'gloo'}; {card}")
    try:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=tp_child, args=(r, world, tmp, spec)) for r in range(world)]
        t_spawn = time.perf_counter()
        for p in procs:
            p.start()
        try:
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode not in (None, 0) for p in procs)
                   and time.perf_counter() - t_spawn < max_s):
                time.sleep(0.2)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.terminate()
            for p in procs:
                p.join(10)
        wait_s = time.perf_counter() - t_spawn
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * world:
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.log")
                if os.path.exists(path):
                    with open(path) as f:
                        log(f"  rank {r}'s progress:\n" + f.read()[-6000:])
        results = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            results.append(json.load(open(path)) if os.path.exists(path) else {})
        log(f"  {world} process(es) ran in {wait_s:.1f} s, exit codes {codes}")
        failed = []

        def verify(ok, msg):
            if not ok:
                failed.append(msg)
                log(f"  FAILED: {msg}")

        # (d) every block bitwise the stacked ranks
        for name, *_ in cases:
            if not all(name in res.get("d", {}) for res in results):
                verify(False, f"phase 18 (d) {name}: did not end on every process")
                continue
            want = stacked[name]["digests"]
            bad = [(r, k) for r, res in enumerate(results)
                   for k, v in res["d"][name]["digests"].items()
                   if want[r].get(k) != v]
            verify(not bad, f"phase 18 (d) {name}: {len(bad)} block(s) differ from the stacked "
                            f"ranks, first {bad[:3]}")
            ms = [res["d"][name]["ms"] for res in results]
            log(f"  (d) {name} over {world} processes: loss "
                f"{results[0]['d'][name]['loss']:.6f}, the loss, {len(want[0]) - 1} gradient and "
                f"updated-state blocks a rank bitwise the stacked ranks' (checksums); loss and "
                f"gradients {max(ms):.0f} ms (slowest process) against {stacked[name]['ms']:.0f} "
                "ms stacked on one card")
        # (e) saved on (1, 4) processes, resumed on (2, 2) processes and on one card
        if all("e" in res and "loss3" in res["e"] for res in results):
            e = results[0]["e"]
            verify(all(res["e"]["start"] == 2 for res in results),
                   "phase 18 (e): a process did not resume at step 2")
            verify(all(res["e"]["restored"] == e["saved"] and res["e"]["saved"] == e["saved"]
                       for res in results),
                   "phase 18 (e): a process's restored state differs from the saved one")
            cfg = tp_config(TP_DENSE, trainer_layers, cut)
            flat = tp_flat_trainer(dev, cfg, os.path.join(tmp, "ckpt"), *tokens)
            verify(flat.start_step == 2 and tp_checksums(flat.state) == e["saved"],
                   "phase 18 (e): the processes' snapshot restored on one card differs from the "
                   "saved state")
            l1 = flat.run()["metrics"][-1]["loss"]
            del flat
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            verify(abs(e["loss3"] - l1) <= 1e-5,
                   f"phase 18 (e): step 3 resumed on (2, 2) processes, {e['loss3']:.7f}, against "
                   f"{l1:.7f} on one card")
            log(f"  (e) Trainer(state_shardings) on (1, 4) processes, its step-2 snapshot resumed "
                f"on (2, 2) processes and on one card, each restored state bitwise the saved one; "
                f"step 3 loss {e['loss3']:.6f} on (2, 2) processes, {l1:.6f} on one card")
        else:
            verify(False, "phase 18 (e): did not end on every process")
        # (f) full depth: the pace, the memory, the share in NCCL; the loss
        # against the flat forward on one card
        if all("f" in res for res in results):
            fs = [res["f"] for res in results]
            B, S = full_tokens
            pace = max(f["s"][1] for f in fs)
            prof = [f["profile"][0] for f in fs if f["profile"]]
            share = [p["nccl_us"] / p["busy_us"] for p in prof if p["busy_us"]]
            loss1 = fs[0]["losses"][0]
            verify(all(math.isfinite(l) for f in fs for l in f["losses"]),
                   "phase 18 (f): a loss is not finite")
            cfg = tp_config(TP_DENSE, full_layers, cut, dtype="bfloat16")
            from repro_torch.data.pipeline import DataConfig, make_source
            from repro_torch.models import lm
            from repro_torch.train.train_step import cross_entropy_loss

            src = make_source(DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size,
                                         seed=SEED + 183))
            batch = src.batch_at(0)
            toks = torch.from_numpy(batch["tokens"]).to(dev, dtype=torch.int64)
            params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(
                SEED + 183), device=dev)
            losses = {}
            for c in (cfg, dataclasses.replace(cfg, dtype="float32")):
                with torch.no_grad():
                    logits, _ = lm.forward_train(params, c, toks, remat=False,
                                                 q_chunk=min(1024, S))
                    ce, zl = cross_entropy_loss(c, logits, toks)
                    losses[c.dtype] = float(ce + zl)
                del logits
            # the spread of bf16's rounding: the flat forward in bf16 against float32
            flat_loss, spread = losses["bfloat16"], abs(losses["bfloat16"] - losses["float32"])
            del params
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            # every process computes the global loss: process 0's stands for all
            fwd = fs[0]["forward"]
            gap = {k: abs(v - losses[k.split()[0]]) for k, v in fwd.items()}
            verify(gap["float32"] <= 1e-5,
                   f"phase 18 (f): the sharded float32 forward's loss {fwd['float32']:.7f} is "
                   f"{gap['float32']:.3e} from the flat float32 forward's "
                   f"{losses['float32']:.7f}, over 1e-5")
            verify(gap["float32 fault"] > 1e-5,
                   f"phase 18 (f): with a psum dropped the float32 forward reads only "
                   f"{gap['float32 fault']:.3e} from flat, so 1e-5 would not see the fault")
            verify(abs(loss1 - flat_loss) <= TP_BF16_LOSS_TOL,
                   f"phase 18 (f): step 1's loss {loss1:.6f} is {abs(loss1 - flat_loss):.3e} "
                   f"from the flat bfloat16 forward's {flat_loss:.6f}, over {TP_BF16_LOSS_TOL}")
            verify(gap["bfloat16 fault"] > TP_BF16_LOSS_TOL,
                   f"phase 18 (f): with a psum dropped the bfloat16 forward reads only "
                   f"{gap['bfloat16 fault']:.3e} from flat, so {TP_BF16_LOSS_TOL} would not see "
                   "the fault")
            gb = [f["state_bytes"] / 1e9 for f in fs]
            log(f"  (f) qwen2-7b at published width, {full_layers} layers, bfloat16 compute, "
                f"float32 state, remat, {B}x{S} tokens on (1, {world}) processes, 3 Trainer steps: "
                f"losses {[round(l, 6) for l in fs[0]['losses']]}; step 2 {pace * 1e3:.1f} ms "
                f"(the slowest process, from a barrier; per process "
                f"{', '.join('%.1f' % (f['s'][1] * 1e3) for f in fs)}), "
                f"{B * S / pace:.0f} tokens/s; step 1 {max(f['s'][0] for f in fs) * 1e3:.1f} ms; "
                f"step 1's loss {loss1:.6f} against the flat bf16 forward's {flat_loss:.6f} on one "
                f"card (|diff| {abs(loss1 - flat_loss):.3e}, limit {TP_BF16_LOSS_TOL}; with "
                f"layer {full_layers // 2}'s SwiGLU psum dropped {gap['bfloat16 fault']:.3e}; with every psum of bf16 partials "
                f"summed in float32 {gap['bfloat16 float32-psums']:.3e}; bf16's spread against "
                f"float32 {spread:.3e}); the sharded float32 forward {fwd['float32']:.7f} against flat "
                f"{losses['float32']:.7f} (|diff| {gap['float32']:.3e}, limit 1e-5; with the psum "
                f"dropped {gap['float32 fault']:.3e}); state + gradients "
                f"{max(gb):.2f} GB a process; peak "
                f"{', '.join('%.2f' % f['peak_gib'] for f in fs)} GiB; NCCL "
                f"{', '.join('%.3f' % x for x in share)} of device time in step 3 (profiled)")
            if on_card:
                verify(max(f["peak_gib"] for f in fs) < 75.0,
                       "phase 18 (f): a process peaked over 75 GiB")
        else:
            verify(False, "phase 18 (f): did not end on every process")
        # (h) the per-row decode over processes, every block bitwise the stacked ranks
        for shape in TP_DECODE_PROCESS_MESHES:
            key = str(list(shape))
            if not all(key in res.get("h", {}) for res in results):
                verify(False, f"phase 18 (h) {shape}: did not end on every process")
                continue
            want = decoded["digests"][shape]
            bad = [(r, k) for r, res in enumerate(results)
                   for k, v in res["h"][key]["digests"].items() if want[r].get(k) != v]
            verify(not bad and all(len(res["h"][key]["digests"]) == len(want[r])
                                   for r, res in enumerate(results)),
                   f"phase 18 (h) {shape}: {len(bad)} block(s) differ from the stacked ranks, "
                   f"first {bad[:3]}")
            ms = [res["h"][key]["ms"] for res in results]
            log(f"  (h) (g)'s decode on {shape} {results[0]['h'][key]['layout']} over {world} "
                f"processes: every step's logits block and the last cache blocks of each rank "
                f"bitwise the stacked ranks' ({len(want[0])} checksums a rank); "
                f"{max(ms):.3f} ms a step (median, the slowest process) against "
                f"{decoded['ms'][shape]:.3f} stacked on one card")
        # (j) (i)'s (4, 1) over processes, every block bitwise the stacked ranks
        if all("j" in res for res in results):
            want = moe["digests"]
            bad = [(r, k) for r, res in enumerate(results)
                   for k, v in res["j"]["digests"].items() if want[r].get(k) != v]
            verify(not bad and all(len(res["j"]["digests"]) == len(want[r])
                                   for r, res in enumerate(results)),
                   f"phase 18 (j): {len(bad)} block(s) differ from the stacked ranks, first "
                   f"{bad[:3]}")
            js = [res["j"] for res in results]
            log(f"  (j) (i)'s granite on {TP_MOE_PROCESS_MESH} over {world} processes: loss "
                f"{js[0]['loss']:.6f}; the loss, every gradient and updated-state block, the "
                f"prefill's and each decode step's logits blocks of each rank bitwise (i)'s "
                f"stacked ranks ({len(want[0])} checksums a rank); train step "
                f"{max(j['ms'] for j in js):.0f} ms, prefill {max(j['prefill_ms'] for j in js):.1f} "
                f"ms, decode {max(j['decode_ms'] for j in js):.3f} ms a step (median; the slowest "
                f"process each); a process's peak "
                f"{', '.join('%.2f' % j['peak_gib'] for j in js)} GiB")
        else:
            verify(False, "phase 18 (j): did not end on every process")
        check(codes == [0] * world, f"phase 18: the processes exited with {codes} "
                                    f"({len(hung)} still running after {wait_s:.1f} s were stopped)")
        check(not failed, f"phase 18: {len(failed)} check(s) failed: {failed}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 19: slot axis, context parallelism and microbatches over processes
# --------------------------------------------------------------------------

# per bucket, (n_steps, frame_every) of each request: H is heat so4 fused
# k=4 (K2), K heat so2 k=1 (K1), a program of its own so that it migrates
# alone
P19_REQUESTS = {"H": [(16, 0), (32, 16), (48, 0), (16, 0), (32, 0), (48, 0)],
                "K": [(16, 0), (16, 0), (16, 0), (16, 0)]}
P19_OPTIONS = {"microbatches": 2, "grad_compression": "int8"}


def p19_programs(n2):
    return {"H": oec_heat((n2, n2)), "K": oec_heat((n2, n2), so=2)}


def p19_kw(label):
    return ({"backend": "cuda", "exchange_every": 4, "fused_epoch": True} if label == "H"
            else {"backend": "cuda"})


def p19_layouts(world):
    """``(name, spatial mesh shape, its axes)``: the bucket's spatial mesh,
    a block of the world; the engine factors the slot axis out of the
    rest of it."""
    if world == 1:
        return [("slot=1 x=1", (1,), ("x",))]
    return [("slot=2 x=2", (world // 2,), ("x",)), ("slot=1 2x2", (2, world // 2), ("x", "y"))]


def p19_strategy(shape):
    from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d

    return make_strategy_1d(shape[0]) if len(shape) == 1 else make_strategy_2d(tuple(shape))


def p19_state(prog, dev, seed):
    """Request ``seed``'s initial state, drawn on ``dev`` (the same draws on
    every card)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1900 + seed)
    return tuple(torch.randn(f.type.bounds.shape, device=dev, generator=g)
                 for f in prog.input_fields)


def p19_engine(w, layout, shape, names, spec, note, *, migrate):
    """Phase 19 (a)/(d) on this process: one ``StencilEngine`` with the
    buckets H (pool of 4, 6 requests, one with frames) and K (pool of 4,
    4 requests) whose targets run over the spatial process mesh ``shape``
    (``jit=True``); the engine factors the slot axis out of the world.
    With ``migrate``, H is resized to 8 slots after the first engine step
    (the ``PoolSizer``'s path) and K is evacuated after the second and
    admitted onto this card alone by a second engine.  Every final state
    and frame must equal its solo ``time_loop`` on this card (raises
    otherwise).  Returns what was measured."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.dist import processes
    from repro_torch.kernels import dispatch_stats, reset_dispatch_stats
    from repro_torch.serve.stencil import StencilEngine, StencilEngineConfig

    dev = w.device
    on_card = dev.type == "cuda"
    progs = p19_programs(spec["n2"])
    mesh = processes.process_mesh(shape, names)
    targets = {k: api.Target(mesh=mesh, strategy=p19_strategy(shape), jit=True, **p19_kw(k))
               for k in progs}
    engine = StencilEngine(StencilEngineConfig(slots_per_group=4, bucket_idle_steps=0))
    frames: dict = {}
    handles = {}
    for label, reqs in P19_REQUESTS.items():
        for i, (n, every) in enumerate(reqs):
            key = f"{label}{i}"
            handles[key] = engine.submit(
                progs[label], p19_state(progs[label], dev, len(handles)), n, targets[label],
                frame_every=every, on_frame=lambda f, k=key: frames.setdefault(k, []).append(f))
    rec = {"layout": layout, "world": w.size}
    # every timed dispatch with its bucket's live rows and whether it
    # captured a graph (a capture runs the phase eagerly first)
    dispatches: dict = {}
    plain_record = engine.metrics.record_dispatch

    def record(key, seconds):
        g = next(g for g in engine.scheduler.groups.values() if f"{g.key[0]}/{g.key[1]}" == key)
        captures = api.graph_stats().captures
        seen = dispatches.setdefault(key, {"captures": captures, "runs": []})
        seen["runs"].append((seconds, len(g.active), captures > seen["captures"]))
        seen["captures"] = captures
        plain_record(key, seconds)

    engine.metrics.record_dispatch = record
    if on_card:
        torch.cuda.synchronize(dev)
    processes.barrier()
    reset_dispatch_stats()
    t0 = time.perf_counter()
    engine.step()
    groups = {label: next(g for g in engine.scheduler.groups.values()
                          if g.key[0] == progs[label].fingerprint) for label in progs}
    for label, g in groups.items():
        exe = g.executable
        check(exe is not None and exe.target.slot_axis == "slot" and exe.target.mesh.processes,
              f"phase 19 {layout} {label}: the bucket did not dispatch over its slot-axis sibling")
        local = sum(t.numel() * 4 for x in g.state for t in x.shards)
        whole = sum(int(np.prod(x.shape)) * 4 for x in g.state)
        rec[f"{label} pool"] = {"local": local, "whole": whole,
                                "slots": int(exe.target.mesh.shape["slot"])}
    migrated = {}
    second = None
    if migrate:
        engine.resize_bucket(groups["H"], 8)
        engine.step()
        evac = processes.broadcast_object(tempfile.mkdtemp(prefix="phase19-evac-"))
        moved = engine.evacuate(progs["K"].fingerprint, evac)
        second = StencilEngine(StencilEngineConfig(slots_per_group=4, bucket_idle_steps=0))
        one = api.Target(device=w.device.type, jit=True, **p19_kw("K"))
        for req, h in zip(moved, second.admit_evacuated(evac, progs["K"], target=one)):
            migrated[f"K{req.rid - len(P19_REQUESTS['H'])}"] = h
        check(len(migrated) == len(P19_REQUESTS["K"]),
              f"phase 19 {layout}: {len(migrated)} requests of K evacuated")
    engine.run()
    if second is not None:
        second.run()
        processes.barrier()  # every process has read its requests back
        if w.rank == 0:
            shutil.rmtree(evac, ignore_errors=True)
    if on_card:
        torch.cuda.synchronize(dev)
    processes.barrier()
    rec["engine_s"] = time.perf_counter() - t0
    st = dispatch_stats()
    rec["launches"] = {"K1": st.apply_launches, "K2": st.fused_epoch_launches}
    for label, g in groups.items():
        runs = dispatches[f"{g.key[0]}/{g.key[1]}"]["runs"]
        # the replays (no capture in them): their seconds and points a second
        k = g.exchange_every
        replays = sorted(t for t, _, cap in runs if not cap)
        rates = sorted(live * spec["n2"] ** 2 * k / t for t, live, cap in runs if not cap)
        rec[f"{label} dispatch"] = {
            "count": len(runs), "replays": len(replays),
            "p50_s": replays[len(replays) // 2] if replays else None,
            "p99_s": replays[min(len(replays) - 1, int(0.99 * len(replays)))] if replays else None,
            "gpts": rates[len(rates) // 2] / 1e9 if rates else None}
        ring = g.executable._ring if g.executable is not None else None
        if ring is not None and ring.graphs:
            nodes = [n for _, n, _ in ring.graphs.values()]
            rec[f"{label} graph"] = {"K1": nodes[0].k1, "K2": nodes[0].k2,
                                     "nccl": nodes[0].nccl}
    note(f"{layout}: the engine ran in {rec['engine_s']:.1f} s")
    # every result and frame against its solo run on this card
    solo_t = {k: api.Target(device=w.device.type, jit=True, **p19_kw(k)) for k in progs}
    seed = 0
    for label, reqs in P19_REQUESTS.items():
        solo = api.compile(progs[label], solo_t[label])
        for i, (n, every) in enumerate(reqs):
            key = f"{label}{i}"
            h = migrated.get(key, handles[key])
            state, done = p19_state(progs[label], dev, seed), 0
            seed += 1
            for f in frames.get(key, []):
                state = solo.time_loop(state, f.step - done)
                done = f.step
                check(all(np.array_equal(a, x.cpu().numpy()) for a, x in zip(f.arrays, state)),
                      f"phase 19 {layout} {key}: the frame at step {f.step} differs from solo")
            want = solo.time_loop(state, n - done)
            got = h.result()
            diff = max(float((g_.to(dev) - w_).abs().max()) for g_, w_ in zip(got, want))
            check(all(torch.equal(g_.to(dev), w_) for g_, w_ in zip(got, want)),
                  f"phase 19 {layout} {key}: differs from its solo time_loop (max |diff| {diff})")
            h._req.result = None
            del got, want, state
        solo.release_graphs()
        api.forget(progs[label], solo_t[label])
    rec["frames"] = sum(len(v) for v in frames.values())
    for g in groups.values():
        g.release()
    del engine, second
    return rec


def p19_sibling_check(dev, spec):
    """Phase 19 (a): the single-controller slot-axis sibling on this card
    (``pooled_target`` of a one-rank mesh, ``jit=True``) on a pool of the
    first 4 requests of each bucket, 16 steps: each row bitwise the
    request's solo run."""
    import torch

    from repro_torch import api
    from repro_torch.dist import Mesh

    progs = p19_programs(spec["n2"])
    seed = 0
    for label, reqs in P19_REQUESTS.items():
        spatial = api.Target(mesh=Mesh([dev], ("x",)), strategy=p19_strategy((1,)), jit=True,
                             **p19_kw(label))
        sib = api.pooled_target(spatial, slots=1, devices=[dev])
        states = [p19_state(progs[label], dev, seed + i) for i in range(4)]
        pool = [torch.stack([s[j] for s in states]) for j in range(len(states[0]))]
        got = api.compile(progs[label], sib).time_loop(pool, 16)
        solo = api.compile(progs[label], api.Target(device=dev.type, jit=True, **p19_kw(label)))
        for i, s in enumerate(states):
            want = solo.time_loop(s, 16)
            check(all(torch.equal(g[i], w_) for g, w_ in zip(got, want)),
                  f"phase 19 (a) {label}: row {i} of the single-controller slot-axis sibling "
                  "differs from its solo run")
        for t in (sib, solo.target):
            api.forget(progs[label], t)
        seed += len(reqs)
        del got, pool, states


def p19_cp(w, spec, note):
    """Phase 19 (b)/(e): ``causal_conv_cp`` (d_inner ``spec["conv"]``,
    width 4) and ``sliding_window_attention_cp`` (window ``spec["window"]``,
    4096 on the card, head_dim 128, one head) over this world's processes on (seq=world): bitwise the
    stacked ranks on this card (the single controller's 4 ranks) and, in a
    world of one, the flat call; ms per call of each (CUDA events, best of
    3).  Over more than one process, a window deeper than a shard must
    raise ``ValueError`` on every process before any message."""
    import torch

    from repro_torch.dist import Mesh, processes
    from repro_torch.dist.context_parallel import causal_conv_cp, sliding_window_attention_cp
    from repro_torch.models.mamba import _causal_conv

    dev = w.device
    n = w.size
    pmesh = processes.process_mesh((n,), ("seq",))
    stacked = Mesh([dev] * max(n, 1), ("seq",))
    g = torch.Generator(device=dev).manual_seed(SEED + 1950)
    rec = {}

    def timed(fn):
        best = float("inf")
        out = fn()
        for _ in range(3):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            processes.barrier()
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return out, best * 1e3

    C, S = spec["conv"], spec["conv_S"]
    x = torch.randn(1, S, C, device=dev, generator=g)
    wt, b = torch.randn(4, C, device=dev, generator=g), torch.randn(C, device=dev, generator=g)
    got, rec["conv ms"] = timed(lambda: causal_conv_cp(x, wt, b, pmesh, "seq"))
    want, rec["conv stacked ms"] = timed(lambda: causal_conv_cp(x, wt, b, stacked, "seq"))
    flat, rec["conv flat ms"] = timed(lambda: _causal_conv(x, wt, b)[0])
    check(torch.equal(got, want), "phase 19 causal_conv_cp: the processes differ from the "
                                  "stacked ranks")
    if n == 1:
        check(torch.equal(got, flat), "phase 19 causal_conv_cp: differs from the flat call")
    del x, got, want, flat
    W, Sa = spec["window"], spec["attn_S"]
    q, k, v = (torch.randn(1, Sa, 1, 128, device=dev, generator=g) for _ in range(3))
    got, rec["attn ms"] = timed(lambda: sliding_window_attention_cp(q, k, v, W, pmesh, "seq"))
    want, rec["attn stacked ms"] = timed(
        lambda: sliding_window_attention_cp(q, k, v, W, stacked, "seq"))
    check(torch.equal(got, want), "phase 19 sliding_window_attention_cp: the processes differ "
                                  "from the stacked ranks")
    if n == 1:
        one = Mesh([dev], ("x",))
        flat = sliding_window_attention_cp(q, k, v, W, one, "x")
        check(torch.equal(got, flat), "phase 19 sliding_window_attention_cp: differs from the "
                                      "flat call")
        del flat
    del q, k, v, got, want
    rec["conv"], rec["attn"] = [1, S, C], [1, Sa, 1, 128]
    if n > 1:
        # F2: S 8192 at window 4096 over n processes: a shard of 8192 / n
        # is shallower than the halo, on every process, before any message
        q = torch.zeros(1, 2 * W, 1, 128, device=dev)
        processes.barrier()
        t0 = time.perf_counter()
        try:
            sliding_window_attention_cp(q, q, q, W, pmesh, "seq")
        except ValueError as e:
            rec["F2"] = str(e)
        processes.barrier()
        rec["F2 s"] = time.perf_counter() - t0
        check("F2" in rec and rec["F2 s"] < 10, f"phase 19 (e): F2 did not raise on every "
                                                f"process within 10 s: {rec}")
    note("context parallelism")
    return rec


def p19_child(rank, world, tmp, spec):
    """One process of phase 19, on ``cuda:rank`` over NCCL (gloo on the CPU
    for a rehearsal): (a)/(d) the engine over each layout, (b)/(e) context
    parallelism, and over more than one process (f) the sharded train step
    with microbatches and int8 on (2, 2) (checksums of its blocks) and
    qwen2-7b at full depth with them on (1, 4), 3 ``Trainer`` steps.
    Rewrites ``<tmp>/rank<r>.json`` after every part; logs to
    ``<tmp>/rank<r>.log``."""
    import faulthandler
    import gc

    sys.path.insert(0, spec["src"])
    import torch

    from repro_torch.dist import processes

    progress = open(os.path.join(tmp, f"rank{rank}.log"), "w", buffering=1)
    faulthandler.dump_traceback_later(spec["dump_s"], file=progress)
    t0 = time.perf_counter()

    def note(msg):
        progress.write(f"{time.perf_counter() - t0:7.1f} s  {msg}\n")

    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    w = processes.init(device=spec["device"], rank=rank, world_size=world, local_rank=rank,
                       init_method=f"file://{os.path.abspath(os.path.join(tmp, 'store'))}",
                       timeout_s=180)
    dev = w.device
    on_card = dev.type == "cuda"
    out = {"rank": rank, "engine": {}}

    def save():
        path = os.path.join(tmp, f"rank{rank}.json")
        with open(path + ".part", "w") as f:
            json.dump(out, f)
        os.replace(path + ".part", path)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        for layout, shape, names in p19_layouts(world):
            out["engine"][layout] = p19_engine(w, layout, shape, names, spec, note,
                                               migrate=world > 1)
            free()
            save()
        if world == 1:
            p19_sibling_check(dev, spec)
            out["sibling"] = True
            free()
            save()
        out["cp"] = p19_cp(w, spec, note)
        free()
        save()
        if spec.get("train"):
            from repro_torch.train.train_step import TrainOptions

            opts = dict(P19_OPTIONS, q_chunk=min(1024, spec["tokens"][1]))
            out["f"] = {}
            for name, arch, layers, shape, capacity in spec["cases"]:
                cfg = tp_config(arch, layers, _p19_cut(spec), capacity=capacity)
                mesh = processes.process_mesh(shape, ("data", "model"))
                B, S = spec["tokens"]
                rec = tp_grads_case(dev, cfg, mesh, tp_tokens(cfg, B, S, dev, SEED + 191),
                                    SEED + 190, digests=True, options=TrainOptions(**opts))
                rec["digests"] = rec["digests"][rank]
                out["f"][name] = rec
                free()
                save()
                note(f"(f) {name}")
            cfg = tp_config(TP_DENSE, spec["full_layers"], _p19_cut(spec), dtype="bfloat16")
            B, S = spec["full_tokens"]
            m14 = processes.process_mesh((1, world), ("data", "model"))
            times = []
            trainer, step = tp_trainer(dev, cfg, m14, None, 3, B, S, SEED + 193,
                                       timed=tp_timed(dev, times),
                                       options=TrainOptions(**dict(P19_OPTIONS,
                                                                   q_chunk=min(1024, S))))
            run = trainer.run()
            out["full"] = {"losses": [m["loss"] for m in run["metrics"] if "loss" in m],
                           "s": times,
                           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30
                           if on_card else 0.0}
            del trainer, step
            free()
            save()
            note("(f) full depth")
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0
        out["done"] = True
        save()
        processes.barrier()
    except BaseException:
        import traceback

        note("failed:\n" + traceback.format_exc())
        progress.close()
        os._exit(1)
    faulthandler.cancel_dump_traceback_later()
    processes.shutdown()
    progress.close()


def _p19_cut(spec):
    if not spec["reduced"]:
        return None
    from repro_torch.configs.base import reduced_config

    return reduced_config


def p19_spawn(world, tmp, spec, max_s):
    """Start ``world`` processes of :func:`p19_child` (spawn) and wait until
    every one has ended, one has failed or ``max_s`` seconds are up (the
    rest are then stopped); returns ``(exit codes, each process's record,
    seconds)``, printing the progress of any that failed."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=p19_child, args=(r, world, tmp, spec)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while (any(p.is_alive() for p in procs)
               and not any(p.exitcode not in (None, 0) for p in procs)
               and time.perf_counter() - t0 < max_s):
            time.sleep(0.2)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
        for p in procs:
            p.join(10)
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * world:
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    log(f"  rank {r}'s progress:\n" + f.read()[-6000:])
    results = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path) else {})
    return codes, results, time.perf_counter() - t0


def p19_engine_log(layout, recs, baseline=None):
    """Log one layout's engine records (one a process); returns its
    summary: the K1/K2 launches of every process summed and, per bucket,
    the slowest process's p50/p99 over the dispatches that replayed a
    captured graph (the first dispatch of each rotation phase and pool
    width captures it) and its median GPts/s over them (live rows x
    points x epoch depth / seconds)."""
    out = {"K1": sum(r["launches"]["K1"] for r in recs),
           "K2": sum(r["launches"]["K2"] for r in recs)}
    for label in P19_REQUESTS:
        pool = recs[0][f"{label} pool"]
        d = [r[f"{label} dispatch"] for r in recs]
        graph = recs[0].get(f"{label} graph", {})
        if d[0]["replays"]:
            p50 = max(x["p50_s"] for x in d)
            p99 = max(x["p99_s"] for x in d)
            gpts = min(x["gpts"] for x in d)
            out[label] = {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "gpts": gpts}
            timing = (f"over its {d[0]['replays']} replays of {d[0]['count']} dispatches: p50 "
                      f"{p50 * 1e3:.4f} ms, p99 {p99 * 1e3:.4f} ms, {gpts:.2f} GPts/s "
                      "(the slowest process)")
            if baseline is not None and label in baseline:
                b = baseline[label]
                timing += (f" (one card: p50 {b['p50_ms']:.4f} ms, {b['gpts']:.2f} GPts/s; "
                           f"{gpts / b['gpts']:.2f}x)")
        else:
            timing = f"its {d[0]['count']} dispatches each captured a graph"
        log(f"  {layout} {label}: slot axis of {pool['slots']}, a process's pool "
            f"{pool['local'] / 2**30:.3f} GiB of {pool['whole'] / 2**30:.3f} "
            f"({pool['local'] / pool['whole']:.3f}); {timing}; a replayed graph holds K1 "
            f"{graph.get('K1')}, K2 {graph.get('K2')}, NCCL {graph.get('nccl')} kernel nodes")
    log(f"  {layout}: K1 {out['K1']}, K2 {out['K2']} launches over every process; engine "
        f"{max(r['engine_s'] for r in recs):.1f} s; frames {recs[0]['frames']}")
    return out


class moe_routing:
    """Inside the ``with``, every MoE routing call (``models.moe._route``),
    in call order: with ``pin=None`` each call's expert choices are
    recorded (``.calls``); with ``pin`` (another run's ``.calls``, call for
    call) the choices are that run's wherever they differ (the gates, the
    density and the aux losses follow them), and ``.pinned`` counts the
    tokens so routed and ``.gap`` the largest margin, in this run's own
    router probabilities, by which a pinned expert lost to the one it
    replaced: a near-tie if it is a rounding's size.

    Phase 19 (c) holds granite's sharded step against the flat port so: at
    4 x 2048 tokens a top-k near-tie (a margin of ~1e-8) routes a token to
    another expert in the two runs (the tensor-parallel partial sums round
    the router's inputs otherwise), which moves the gradient rows that
    token touches by percents; with the flat run pinned to the sharded
    run's choices at such ties every leaf agrees within 1e-4."""

    def __init__(self, pin=None):
        self.pin, self.calls, self.pinned, self.gap = pin, [], 0, 0.0

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.plain = plain = moe._route

        def route(p, xt, cfg, dtype):
            gate_vals, gate_idx, aux = plain(p, xt, cfg, dtype)
            if self.pin is None:
                self.calls.append(gate_idx.detach().clone())
                return gate_vals, gate_idx, aux
            # every call takes the pinned route (the same ops whether or not
            # a choice moves: a remat's recomputation saves what its forward
            # saved); where nothing moves its values are the plain route's
            want = self.pin[len(self.calls)]
            self.calls.append(want)
            differ = (gate_idx.sort(-1).values != want.sort(-1).values).any(-1)
            self.pinned += int(differ.sum())
            mcfg = cfg.moe
            logits = moe.router_logits(xt, p["router"], dtype)
            probs = torch.softmax(logits, dim=-1)
            own = probs.gather(-1, gate_idx).detach()
            theirs = probs.gather(-1, want).detach()
            if differ.any():
                self.gap = max(self.gap, float((own.sum(-1) - theirs.sum(-1))[differ].max()))
            gate_vals = probs.gather(-1, want)
            gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
            experts = torch.arange(mcfg.num_experts, device=xt.device)[:, None]
            assigned = want.flatten(-2)
            density = (assigned[..., None, :] == experts).sum(-1).to(torch.float32)
            density = density / assigned.shape[-1]
            lb = mcfg.num_experts * torch.sum(density * probs.mean(-2), dim=-1)
            return gate_vals, want, {"moe_lb_loss": lb, "moe_z_loss": aux["moe_z_loss"]}

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self.plain
        return False


def p19_phase(dev, *, card="", cut=None, n2=16384, conv=(8192, 32768), attn_S=4096, window=4096,
              dense_layers=4, moe_layers=8, tokens=(4, 2048), full_layers=28,
              full_tokens=(4, 4096), processes=None, max_s=90.0) -> dict:
    """Phase 19: the serving engine's slot axis, context parallelism and
    the sharded train step's microbatches and int8 compression over one
    process a card.

    One card: (a) a world of one process (NCCL), a ``StencilEngine`` whose
    buckets run over a process mesh of it: H (heat ``n2``² so4 fused k=4,
    K2; a pool of 4, 6 requests of 16-48 steps, one with frames) and K
    (heat so2 k=1, K1; a pool of 4, 4 x 16 steps), the slot axis factored
    out of the world (``(slot=1, x=1)``): every result and frame bitwise
    its solo ``time_loop``, and the single-controller slot-axis sibling
    on this card bitwise the solo runs; (b) ``causal_conv_cp`` (d_inner
    ``conv[0]``, width 4, S ``conv[1]``) and ``sliding_window_attention_cp``
    (window 4096, head_dim 128, S ``attn_S``: the one rank's windows of
    S 32768 would be 137 GB) over that world, bitwise the stacked ranks and
    the flat call; (c) ``ShardedTrainStep`` with 2 microbatches and int8
    on stacked (2, 2) ranks: qwen2-7b at published width, ``dense_layers``
    of 28 layers, float32, ``tokens``, and granite-moe-1b-a400m,
    ``moe_layers`` of 24, capacity 4.0, each against the flat port's step
    with the same options: the loss within 1e-5, every gradient leaf
    before compression within 1e-4 of its largest magnitude, the
    compressed gradients within one quantization step (:func:`int8_check`).

    With ``processes`` (four cards: ``python3 chip_smoke.py --phase 19``;
    gloo processes on the CPU for a rehearsal) four processes then run
    (d) (a) over ``(slot=2, x=2)`` and ``(slot=1, 2x2)`` process meshes,
    with a resize of H to 8 slots and K evacuated and admitted onto one
    card, every result and frame bitwise its solo run on each process's
    card; a process's pool bytes, dispatch p50/p99 and GPts/s against
    (a)'s, the K1/K2/NCCL nodes of a replayed graph; (e) (b) over 4
    processes (the window at S 32768), bitwise the stacked ranks, ms
    against stacked and flat, F2 (S 8192, window 4096) raised on every
    process within 10 s; (f) (c) over (2, 2) processes, every block
    bitwise the stacked ranks (checksums), and qwen2-7b at full depth,
    bf16 compute, float32 state, remat, 2 microbatches, int8, ``full_tokens``
    on (1, 4), 3 ``Trainer`` steps from a barrier (the slowest process),
    finite losses, step 1's within ``TP_BF16_LOSS_TOL`` of the flat bf16
    forward on one card.

    Under ``max_s`` (90 s) and 70 GiB on one card; 300 s and 75 GiB a card
    with the processes.  Returns ``{"a": launches, ...}`` for the kernels
    line."""
    import gc
    import math

    import torch

    on_card = dev.type == "cuda"
    t19 = time.perf_counter()
    if processes:
        max_s = 300.0
    max_gib = 75.0 if processes else 70.0
    gib = 2**30

    def free():
        gc.collect()
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    def peak() -> float:
        return torch.cuda.max_memory_allocated(dev) / gib if on_card else 0.0

    log(f"phase 19: the serving engine's slot axis, context parallelism and the sharded train "
        f"step's microbatches and int8 compression over processes; {card}")
    free()
    if on_card:
        import numpy as np

        from repro_torch import api
        from repro_torch.dist import Mesh
        from repro_torch.kernels import stencil_apply as k1

        # every K1/K2 source the processes launch (a rank's program of each
        # layout's spatial mesh: the slot count is a launch argument), built
        # here in parallel
        progs = p19_programs(n2)
        sources = []
        for _, shape, names in p19_layouts(1) + (p19_layouts(processes) if processes else []):
            cpus = np.empty(int(np.prod(shape)), dtype=object)
            cpus[:] = [torch.device("cpu")] * cpus.size
            for label, prog in progs.items():
                t = api.Target(mesh=Mesh(cpus.reshape(shape), names),
                               strategy=p19_strategy(shape), jit=False, **p19_kw(label))
                sources += api.compile(prog, t).kernel_sources()
                api.forget(prog, t)
        k1.build(list(dict.fromkeys(sources)))
        free()
    spec = {"src": str(Path(__file__).resolve().parent / "src"),
            "device": "cuda" if on_card else "cpu", "n2": n2, "conv": conv[0],
            "conv_S": conv[1], "attn_S": attn_S, "window": window, "reduced": cut is not None,
            "dump_s": max(max_s - 15, 20.0)}
    out = {}
    failed = []

    def verify(ok, msg):
        if not ok:
            failed.append(msg)
            log(f"  FAILED: {msg}")

    # (a) and (b): a world of one
    tmp = tempfile.mkdtemp(prefix="phase19-")
    try:
        codes, results, s = p19_spawn(1, tmp, spec, max_s)
        res = results[0]
        log(f"  (a)-(b): a world of one process ran in {s:.1f} s, exit code {codes[0]}")
        if res.get("engine"):
            (layout, rec), = res["engine"].items()
            out["a"] = p19_engine_log(f"(a) {layout}", [rec])
            log(f"  (a): every result and frame bitwise its solo time_loop"
                + ("; the single-controller slot-axis sibling bitwise the solo runs"
                   if res.get("sibling") else ""))
        verify(bool(res.get("sibling")), "phase 19 (a): did not end")
        if "cp" in res:
            cp = res["cp"]
            log(f"  (b) over a world of one: causal_conv_cp {cp['conv']} {cp['conv ms']:.3f} ms "
                f"(stacked {cp['conv stacked ms']:.3f}, flat {cp['conv flat ms']:.3f}), "
                f"sliding_window_attention_cp {cp['attn']} {cp['attn ms']:.3f} ms (stacked "
                f"{cp['attn stacked ms']:.3f}): bitwise the stacked ranks and the flat call")
        verify("cp" in res, "phase 19 (b): did not end")
        verify(codes == [0], f"phase 19 (a)-(b): the process exited with {codes}")
        if on_card:
            log(f"  (a)-(b): the process peaked at {res.get('peak_gib', 0):.2f} GiB")
            verify(res.get("peak_gib", 0) < max_gib, "phase 19 (a)-(b): over the memory limit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free()
    check(not failed, f"phase 19: {len(failed)} check(s) failed: {failed}")

    # (c) the sharded step with microbatches and int8, ranks stacked
    from repro_torch.train.train_step import TrainOptions

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    B, S = tokens
    opts = TrainOptions(**dict(P19_OPTIONS, q_chunk=min(1024, S)))
    cases = [("qwen2-7b (2, 2)", TP_DENSE, dense_layers, (2, 2), None),
             ("granite-moe-1b-a400m (2, 2)", TP_MOE, moe_layers, (2, 2), 4.0)]
    stacked = {}
    for name, arch, layers, shape, capacity in cases:
        t0 = time.perf_counter()
        cfg = tp_config(arch, layers, cut, capacity=capacity)
        mesh = tp_meshes(dev, shape)
        toks = tp_tokens(cfg, B, S, dev, SEED + 191)
        tf = time.perf_counter()
        with moe_routing() as f_route:
            flat = tp_flat(dev, cfg, toks, SEED + 190, mesh, options=opts)
        f_s = time.perf_counter() - tf
        with moe_routing() as s_route:
            rec = tp_grads_case(dev, cfg, mesh, toks, SEED + 190, flat=flat,
                                digests=bool(processes), options=opts)
        del flat
        free()
        ties = ""
        routed = f_route.calls
        if len(routed) != len(s_route.calls) or any(
                not torch.equal(a, b) for a, b in zip(routed, s_route.calls)):
            # a top-k near-tie routed otherwise: the flat run again with the
            # sharded run's choices there (see moe_routing)
            check(len(routed) == len(s_route.calls),
                  f"phase 19 (c) {name}: {len(routed)} routing calls flat, "
                  f"{len(s_route.calls)} sharded")
            unpinned = (rec["loss_err"], rec["grad_err"], rec["grad_worst"])
            with moe_routing(pin=s_route.calls) as pinned:
                flat = tp_flat(dev, cfg, toks, SEED + 190, mesh, options=opts)
            rec = tp_grads_case(dev, cfg, mesh, toks, SEED + 190, flat=flat,
                                digests=bool(processes), options=opts)
            del flat
            free()
            check(pinned.pinned > 0 and pinned.gap < 1e-5,
                  f"phase 19 (c) {name}: {pinned.pinned} token(s) pinned, the largest margin "
                  f"{pinned.gap:.3e} (a routing difference that is no near-tie)")
            ties = (f"; {pinned.pinned} token routing(s) differed from flat at top-k near-ties "
                    f"(margin <= {pinned.gap:.2e}; unpinned: loss {unpinned[0]:.2e}, gradient "
                    f"{unpinned[2]} {unpinned[1]:.2e}), so the flat run took the sharded run's "
                    "choices there")
        del routed, f_route, s_route
        stacked[name] = rec
        q = rec["int8"]
        check(rec["loss_err"] <= 1e-5, f"phase 19 (c) {name}: loss {rec['loss']:.7f} is "
                                       f"{rec['loss_err']:.3e} from the flat port's")
        check(rec["grad_err"] <= 1e-4, f"phase 19 (c) {name}: gradient {rec['grad_worst']} is "
                                       f"{rec['grad_err']:.3e} of its largest magnitude from flat")
        check(q["worst"] <= 1 and q["unequal"] == 0,
              f"phase 19 (c) {name}: the int8 gradients against flat: {q}")
        log(f"  (c) {name}: {layers} layers, {B}x{S} tokens in 2 microbatches, int8, float32: "
            f"loss {rec['loss']:.6f} ({rec['loss_err']:.2e} from flat), every gradient leaf "
            f"within {rec['grad_err']:.2e} of its max (worst {rec['grad_worst']}); int8 within "
            f"{q['worst']:.3f} of a quantization step (worst {q['where']}), none apart where "
            f"the gradients agree; loss and gradients {rec['ms']:.0f} ms stacked, "
            f"{f_s * 1e3:.0f} ms flat{ties}; {time.perf_counter() - t0:.1f} s, peak "
            f"{peak():.2f} GiB")
    check(peak() < max_gib, f"phase 19 (c): peaked at {peak():.2f} GiB, over {max_gib}")

    if processes:
        free()
        world = processes
        spec.update({"conv_S": conv[1], "attn_S": 32768 if on_card else attn_S * world,
                     "train": True, "cases": [list(c) for c in cases], "tokens": list(tokens),
                     "full_layers": full_layers, "full_tokens": list(full_tokens)})
        tmp = tempfile.mkdtemp(prefix="phase19p-")
        log(f"phase 19 (d)-(f): {world} processes over {'NCCL' if on_card else 'gloo'}; {card}")
        try:
            codes, results, s = p19_spawn(world, tmp, spec,
                                          max_s - (time.perf_counter() - t19))
            log(f"  {world} processes ran in {s:.1f} s, exit codes {codes}")
            for layout, _, _ in p19_layouts(world):
                recs = [r.get("engine", {}).get(layout) for r in results]
                if all(recs):
                    p19_engine_log(f"(d) {layout}", recs, baseline=out.get("a"))
                    verify(all(r["H pool"]["local"] * world == r["H pool"]["whole"]
                               for r in recs[:1]),
                           f"phase 19 (d) {layout}: a process holds more than its share of H")
                    log(f"  (d) {layout}: every result and frame bitwise its solo run on each "
                        "process's card, through a resize of H to 8 slots and K's evacuation "
                        "onto one card")
                else:
                    verify(False, f"phase 19 (d) {layout}: did not end on every process")
            if all("cp" in r for r in results):
                cps = [r["cp"] for r in results]
                log(f"  (e) over {world} processes: causal_conv_cp {cps[0]['conv']} "
                    f"{max(c['conv ms'] for c in cps):.3f} ms (stacked "
                    f"{cps[0]['conv stacked ms']:.3f}, flat {cps[0]['conv flat ms']:.3f}); "
                    f"sliding_window_attention_cp {cps[0]['attn']} "
                    f"{max(c['attn ms'] for c in cps):.3f} ms (stacked "
                    f"{cps[0]['attn stacked ms']:.3f}); bitwise the stacked ranks; F2 raised on "
                    f"every process in {max(c['F2 s'] for c in cps):.2f} s")
            else:
                verify(False, "phase 19 (e): did not end on every process")
            for name, *_ in cases:
                if not all(name in r.get("f", {}) for r in results):
                    verify(False, f"phase 19 (f) {name}: did not end on every process")
                    continue
                want = stacked[name]["digests"]
                bad = [(r, k) for r, res in enumerate(results)
                       for k, v in res["f"][name]["digests"].items() if want[r].get(k) != v]
                verify(not bad, f"phase 19 (f) {name}: {len(bad)} block(s) differ from the "
                                f"stacked ranks, first {bad[:3]}")
                log(f"  (f) {name} over {world} processes, 2 microbatches, int8: the loss, every "
                    f"block of the int8 gradients and of the updated state bitwise the stacked "
                    f"ranks' (checksums); {max(r['f'][name]['ms'] for r in results):.0f} ms "
                    f"(slowest) against {stacked[name]['ms']:.0f} ms stacked")
            if all("full" in r for r in results):
                fs = [r["full"] for r in results]
                Bf, Sf = full_tokens
                pace = max(f["s"][1] for f in fs)
                loss1 = fs[0]["losses"][0]
                verify(all(math.isfinite(x) for f in fs for x in f["losses"]),
                       "phase 19 (f): a loss is not finite")
                from repro_torch.data.pipeline import DataConfig, make_source
                from repro_torch.models import lm
                from repro_torch.train.train_step import cross_entropy_loss

                cfg = tp_config(TP_DENSE, full_layers, cut, dtype="bfloat16")
                batch = make_source(DataConfig(seq_len=Sf, global_batch=Bf,
                                               vocab_size=cfg.vocab_size,
                                               seed=SEED + 193)).batch_at(0)
                toks = torch.from_numpy(batch["tokens"]).to(dev, dtype=torch.int64)
                params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(
                    SEED + 193), device=dev)
                with torch.no_grad():
                    logits, _ = lm.forward_train(params, cfg, toks, remat=False,
                                                 q_chunk=min(1024, Sf))
                    ce, zl = cross_entropy_loss(cfg, logits, toks)
                flat_loss = float(ce + zl)
                del params, logits
                free()
                verify(abs(loss1 - flat_loss) <= TP_BF16_LOSS_TOL,
                       f"phase 19 (f): step 1's loss {loss1:.6f} is {abs(loss1 - flat_loss):.3e} "
                       f"from the flat bf16 forward's {flat_loss:.6f}, over {TP_BF16_LOSS_TOL}")
                log(f"  (f) qwen2-7b, {full_layers} layers, bf16 compute, float32 state, remat, "
                    f"2 microbatches, int8, {Bf}x{Sf} tokens on (1, {world}) processes, 3 Trainer "
                    f"steps: losses {[round(x, 6) for x in fs[0]['losses']]}; step 2 "
                    f"{pace * 1e3:.1f} ms (the slowest process, from a barrier; per process "
                    f"{', '.join('%.1f' % (f['s'][1] * 1e3) for f in fs)}), "
                    f"{Bf * Sf / pace:.0f} tokens/s; step 1's loss {loss1:.6f} against the flat "
                    f"bf16 forward's {flat_loss:.6f} on one card (|diff| "
                    f"{abs(loss1 - flat_loss):.3e}, limit {TP_BF16_LOSS_TOL}); peak "
                    f"{', '.join('%.2f' % f['peak_gib'] for f in fs)} GiB")
            else:
                verify(False, "phase 19 (f) full depth: did not end on every process")
            if on_card:
                peaks = [r.get("peak_gib", 0.0) for r in results]
                log(f"  (d)-(f): the processes peaked at {', '.join('%.2f' % p for p in peaks)} GiB")
                verify(max(peaks) < max_gib, f"phase 19 (d)-(f): a process peaked over {max_gib} GiB")
            verify(codes == [0] * world, f"phase 19 (d)-(f): the processes exited with {codes}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        check(not failed, f"phase 19: {len(failed)} check(s) failed: {failed}")
    sec = time.perf_counter() - t19
    log(f"phase 19: {sec:.1f} s; {card}")
    check(sec < max_s, f"phase 19 took {sec:.1f} s, more than {max_s} s")
    return out


# -- phase 20: deep 3-D fused epochs (K2's streaming and scratch plans) -------
# (kind, space order, k): the fig-7 3-D epochs no tile of shared memory can
# hold, or (heat so8 k=4) only as 2x2x2 tiles
DEEP_CASES = (("heat", 4, 8), ("heat", 8, 8), ("heat", 8, 4), ("wave", 4, 8), ("wave", 8, 4))
# K2's plan of each at 1024^3: streaming, but for heat so8 k=8 (no stream
# fits) and wave so8 k=4 (its stream ran slower than its scratch plan, so
# the cost model weighs a one-CTA-an-SM stream against scratch)
DEEP_PLAN = {("heat", 4, 8): "stream", ("heat", 8, 8): "scratch", ("heat", 8, 4): "stream",
             ("wave", 4, 8): "stream", ("wave", 8, 4): "scratch"}
# the other plan phase 20 times beside each, as run_epoch_cuda's keywords:
# the scratch plan the streaming ones replaced, heat so8 k=4's 2x2x2 tile
# (timed at the small size: at 1024^3 one epoch of it would take the
# model's ~8465 thread-points an owned point), wave so8 k=4's stream
DEEP_OTHER = {("heat", 4, 8): {"stream": False}, ("heat", 8, 8): None,
              ("heat", 8, 4): {"tile": (2, 2, 2)}, ("wave", 4, 8): {"stream": False},
              ("wave", 8, 4): {"stream": True}}


def fig7_op(kind, shape, so, boundary="zero"):
    """Fig 7's heat (``Eq(u.dt, 0.5 u.laplace)``) or wave (``Eq(u.dt2,
    u.laplace)``) through the devito-like frontend, spacing 1, dt 0.1: the
    main path's programs."""
    from repro_torch.frontends.devito_like import Eq, Grid, Operator, TimeFunction

    g = Grid(shape=shape, extent=tuple(float(n) for n in shape))
    if kind == "heat":
        u = TimeFunction(name="u", grid=g, space_order=so)
        return Operator(Eq(u.dt, 0.5 * u.laplace), dt=0.1, boundary=boundary)
    u = TimeFunction(name="u", grid=g, space_order=so, time_order=2)
    return Operator(Eq(u.dt2, 1.0 * u.laplace), dt=0.1, boundary=boundary)


def deep_mesh(dev):
    """Four ranks of a 2x2x1 mesh, all on ``dev``, and their strategy."""
    from repro_torch.core.passes.decompose import make_strategy_3d
    from repro_torch.dist import Mesh

    return {"mesh": Mesh([[[dev], [dev]], [[dev], [dev]]], ("x", "y", "z")),
            "strategy": make_strategy_3d((2, 2, 1))}


def deep_epoch(dev, op, k, **kw):
    """The fused epoch of ``op`` at depth ``k`` on ``dev`` (one rank's on a
    mesh given in ``kw``)."""
    from repro_torch import api
    from repro_torch.api import Target

    (e,) = api.compile(op.program, Target(device=str(dev), backend="cuda", jit=False,
                                          exchange_every=k, fused_epoch=True,
                                          **kw)).kernel_epochs()
    return e


def deep_targets(dev, n3=1024, small=256) -> list:
    """Phase 20's kernels: ``(label, fused op, run_epoch_cuda keywords,
    kind, tiled)`` of the kernel-level cases at ``small``³ (``kind``: the
    plan they must run, "stream", "scratch" or "tile"; ``tiled``: a plan
    forced on an epoch that a tile of shared memory holds, run beside K2
    on that tile), then ``(label, op,
    target kwargs, the other plan's keywords, kind)`` of the main-path
    cases at ``n3``³ (heat so4 k=8 also over a 2x2x1 mesh of ``dev``;
    ``kind`` the plan of ``DEEP_PLAN``)."""
    from repro_torch.kernels import epoch_kernel as k2

    ops = {(kind, so, k): deep_epoch(dev, fig7_op(kind, (small,) * 3, so), k)
           for kind, so, k in (("heat", 4, 8), ("heat", 8, 4), ("wave", 4, 8), ("wave", 8, 4),
                               ("heat", 4, 2))}
    heat2 = ops["heat", 4, 2]
    kernel_cases = [
        (f"{kind}3d_so{so} {small}^3 k={k}, streaming", ops[kind, so, k], {"stream": True},
         "stream", False)
        for kind, so, k in (("heat", 4, 8), ("heat", 8, 4), ("wave", 4, 8), ("wave", 8, 4))
    ] + [
        (f"heat3d_so4 {small}^3 k=8, scratch plan", ops["heat", 4, 8], {"stream": False},
         "scratch", False),
        (f"wave3d_so8 {small}^3 k=4, scratch plan", ops["wave", 8, 4], {"stream": False},
         "scratch", False),
        (f"heat3d_so8 {small}^3 k=4, 2x2x2 tiles", ops["heat", 8, 4], {"tile": (2, 2, 2)}, "tile",
         False),
        (f"heat3d_so4 {small}^3 k=2, scratch forced", heat2,
         {"tile": k2.plan_epoch(heat2, stream=False).tile, "scratch": True}, "scratch", True),
        (f"heat3d_so4 {small}^3 k=2, streaming forced", heat2, {"stream": True}, "stream", True),
    ]
    main_cases = [(f"{kind}3d_so{so} {n3}^3 k={k} fused", fig7_op(kind, (n3,) * 3, so),
                   {"exchange_every": k, "fused_epoch": True}, DEEP_OTHER[kind, so, k],
                   DEEP_PLAN[kind, so, k]) for kind, so, k in DEEP_CASES]
    # heat so4 k=8 over a 2x2x1 mesh, right after its single-device run
    main_cases.insert(1, (f"{main_cases[0][0]}, 2x2x1 ranks", main_cases[0][1],
                          {**main_cases[0][2], **deep_mesh(dev)}, None, "stream"))
    return kernel_cases, main_cases


def deep_sources(dev, n3=1024, small=256) -> list:
    """Every K1 and K2 source phase 20 launches (K2 at each case's plan,
    at the forced cases' tile in shared memory and at the main cases'
    other plans; the unfused route's K1)."""
    from repro_torch import api
    from repro_torch.api import Target
    from repro_torch.kernels import epoch_kernel as k2

    kernel_cases, main_cases = deep_targets(dev, n3, small)
    out = []
    for _, op, kw, _, tiled in kernel_cases:
        out.append(k2.emit_epoch_cuda(op, **kw))
        if tiled:  # beside K2 at its tile
            out.append(k2.emit_epoch_cuda(op, k2.plan_epoch(op, stream=False).tile))
    for _, op, kw, old, _ in main_cases:
        unfused = {k: v for k, v in kw.items() if k != "fused_epoch"}
        for k in (kw, unfused):
            out += api.compile(op.program, Target(device=str(dev), backend="cuda", jit=False,
                                                  **k)).kernel_sources()
        if old and "tile" not in old:
            out.append(k2.emit_epoch_cuda(deep_epoch(dev, op, kw["exchange_every"]), **old))
    return list(dict.fromkeys(out))


def kernel_resources(source, symbol="k2_epoch_occupancy") -> str:
    """Registers a thread and spill stores (``ptxas -v``), shared memory a
    CTA and resident CTAs an SM (through the source's occupancy query
    ``symbol``) of a built K1 or K2 source."""
    from repro_torch.kernels import stencil_apply as k1

    log_path = k1.library_path(source).with_suffix(".log")
    lines = log_path.read_text().splitlines()
    regs = [line.split("Used", 1)[1].split("registers")[0].strip()
            for line in lines if "Used" in line and "registers" in line]
    spills = [line.split("bytes spill stores")[0].rsplit(",", 1)[-1].strip()
              for line in lines if "bytes spill stores" in line]
    smem = int(source.split(" bytes of shared memory")[0].rsplit(" ", 1)[1])
    ctas = k1.ctas_per_sm(source, symbol)
    spill = f", {spills[0]} B spill stores" if spills else ""
    return f"{regs[0]} registers/thread{spill}, {smem} B shared/CTA, {ctas} CTAs/SM"


def deep_phase(dev, *, card="", n3=1024, small=256, steps=STEPS) -> list:
    """Phase 20: deep 3-D fused epochs, which K2 runs as streaming plans
    (a minor tile, the core walked plane by plane through rings of shared
    memory) or, where no stream fits (heat so8 k=8), as a scratch plan
    (buffers in device memory).  (a) at ``small``³: heat so4 k=8, heat so8
    k=4, wave so4 k=8 and wave so8 k=4 streaming, heat so4 k=8 and wave so8
    k=4 on their scratch plans, heat so8 k=4 on 2x2x2 tiles, heat so4 k=2
    with every buffer forced off chip and forced to stream, each K2 launch
    bitwise its plain version (the forced cases also K2 in shared memory
    at the same tile), and a pool of 2 slots in one launch against solo
    launches; (b) the main path at ``n3``³ for each of ``DEEP_CASES``:
    ``Operator.apply`` through ``Target(backend="cuda", exchange_every=k,
    fused_epoch=True)``, one K2 launch and no K1 launch an epoch, bitwise
    against the unfused route and the torch backend, then ``jit=True,
    donate=True`` bitwise against ``jit=False`` with one K2 node and no K1
    node in each captured graph; K2 timed beside its bound, its plain
    version, the other plan (``DEEP_OTHER``: the one it replaced, or for
    wave so8 k=4 the slower stream; bitwise) and the unfused route's ms an
    epoch, with its plan,
    registers, spills, shared memory, CTAs an SM and peak memory; (c) heat
    so4 k=8 over a 2x2x1 mesh of this card bitwise against one device,
    four K2 launches an epoch, its rank-local K2 at each corner's box
    against the plain version.  Returns the kernels line's records.  On
    the CPU (a rehearsal at small sizes) the wrappers run their plain
    versions, which launch nothing."""
    import torch

    from repro_torch import api
    from repro_torch.api import Target
    from repro_torch.kernels import dispatch_stats, reset_dispatch_stats
    from repro_torch.kernels import epoch_kernel as k2
    from repro_torch.kernels import stencil_apply as k1
    from repro_torch.launch import roofline

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    log(f"phase 20: deep 3-D fused epochs, K2's streaming and scratch plans ({card})")
    gen = torch.Generator(device=dev) if on_card else torch.Generator()
    kernel_cases, main_cases = deep_targets(dev, n3, small)
    if on_card:
        t0 = time.perf_counter()
        sources = deep_sources(dev, n3, small)
        k1.build(sources)
        log(f"  build: {len(sources)} sources ready in {time.perf_counter() - t0:.1f} s")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def ms_of(fn, reps):
        """ms a call: CUDA events after one warm-up call on the card, the
        host's clock elsewhere."""
        fn()
        sync()
        if not on_card:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) / reps * 1e3
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def randn(shape, seed=SEED):
        gen.manual_seed(seed)
        return torch.randn(shape, device=dev, generator=gen)

    def launches_of(what, want, counted=on_card):
        """The launches counted since the counts were zeroed, which must be
        ``want`` where they are counted: the card's wrappers, or the nodes
        of the graphs a compiled step replays (a plain version on the CPU
        launches nothing)."""
        got = dispatch_stats().fused_epoch_launches if what == "K2" else dispatch_stats().apply_launches
        want = want if counted else 0
        check(got == want, f"{what} launches {got}, expected {want}")
        return got

    def plain(fused_op, arrays, coords=None):
        return k2._emit_region(fused_op, arrays, k2.region_masks(fused_op, dev, coords),
                               lambda v: v.type.bounds)

    def equal(got, want, what):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{what} (max |err| {err})")
        return err

    def kind_of(plan):
        return "stream" if plan.stream else "scratch" if plan.ctas else "tile"

    def plan_line(fused_op, slots=1, **kw):
        """The plan ``kw`` gives ``fused_op`` and, on the card, its kernel's
        resources."""
        plan = k2.plan_epoch(fused_op, **kw)
        st = k2._storage(fused_op, plan)
        line = (f"{kind_of(plan)} plan, tile {plan.tile}, {plan.n_tiles} tiles a slot, "
                f"{st.smem_bytes} B shared, tile_cost {k2.tile_cost(fused_op, plan):.2f}")
        if plan.stream:
            line += (", rings " + " ".join(f"{st.depth[s]}x{st.plane[s]}" for s in sorted(st.depth))
                     + (", prefetch plane" if plan.prefetch else ""))
        if plan.ctas:
            line += (f", at most {plan.ctas} CTAs x {4 * st.scratch_floats} B of scratch "
                     f"({k2.scratch_bytes(fused_op, plan)} B planned)")
        if on_card:
            kernel = k2._kernel_for(fused_op, kw.get("tile"), 16, kw.get("scratch", False),
                                    kw.get("stream"))
            if plan.ctas:
                ctas = kernel.ctas(dev, slots * plan.n_tiles)
                line += f", launched on {ctas} CTAs: {4 * ctas * kernel.scratch_floats} B of scratch"
            line += f"; {kernel_resources(kernel.source)}"
        return line

    # -- (a) K2's plans at small^3 against the plain version ------------------
    for name, fused_op, kw, kind, tiled in kernel_cases:
        arrays = [randn(a.type.bounds.shape) for a in fused_op.body.args]
        reset_dispatch_stats()
        got = k2.run_epoch_cuda(fused_op, arrays, None, **kw)
        launches_of("K2", 1)
        err = equal(got, plain(fused_op, arrays), f"{name}: K2 differs from its plain version")
        check(kind_of(k2.plan_epoch(fused_op, **kw)) == kind, f"{name}: not a {kind} plan")
        extra = ""
        if tiled:
            tile = k2.plan_epoch(fused_op, stream=False).tile
            shared = k2.run_epoch_cuda(fused_op, arrays, None, tile=tile)
            equal(got, shared, f"{name}: K2 differs from K2 in shared memory at {tile}")
            ms_shared = ms_of(lambda: k2.run_epoch_cuda(fused_op, arrays, None, tile=tile), 3)
            extra = f"; bitwise K2 on the tile {tile} of shared memory ({ms_shared:.4f} ms)"
        ms = ms_of(lambda: k2.run_epoch_cuda(fused_op, arrays, None, **kw), 3)
        log(f"  {name}: K2 bitwise its plain version (max |err| {err}), {ms:.4f} ms/launch, "
            f"{plan_line(fused_op, **kw)}{extra}")
        del got, arrays
    # a pool of 2 slots in one launch against each slot alone
    name, fused_op, _, _, _ = kernel_cases[0]
    pooled = [torch.stack([randn(a.type.bounds.shape, SEED + b) for b in range(2)])
              for a in fused_op.body.args]
    reset_dispatch_stats()
    got = k2.run_epoch_cuda(fused_op, pooled, None)
    launches_of("K2", 1)
    equal(got, plain(fused_op, pooled), f"{name}, pool of 2: K2 differs from its plain version")
    for b in range(2):
        solo = k2.run_epoch_cuda(fused_op, [x[b].contiguous() for x in pooled], None)
        equal([g[b] for g in got], solo, f"{name}, pool of 2: slot {b} differs from its solo launch")
    ms_pool = ms_of(lambda: k2.run_epoch_cuda(fused_op, pooled, None), 5)
    solos = [[x[b].contiguous() for x in pooled] for b in range(2)]
    ms_solo = ms_of(lambda: [k2.run_epoch_cuda(fused_op, s, None) for s in solos], 5)
    log(f"  {name}, pool of 2: one launch bitwise the plain version and each slot's solo "
        f"launch, {ms_pool:.4f} ms (2 solo launches {ms_solo:.4f} ms), "
        f"{plan_line(fused_op, slots=2)}")
    del got, pooled, solos
    if on_card:
        torch.cuda.empty_cache()

    # -- (b) and (c): the main path at n3^3 -------------------------------------
    records = []
    one_device = {}  # heat so4 k=8's fused result, for the 2x2x1 mesh
    for name, op, kw, old, want_kind in main_cases:
        prog = op.program
        fused = api.compile(prog, Target(device=str(dev), backend="cuda", jit=False, **kw))
        ranks = fused.target.spatial_ranks if fused.target.distributed else 1
        epochs = fused.epochs(steps)
        (fused_op,) = fused.kernel_epochs()
        plan = k2.plan_epoch(fused_op)
        check(n3 != 1024 or kind_of(plan) == want_kind,
              f"{name}: K2's plan is {kind_of(plan)}, not {want_kind}")
        state = tuple(randn(f.type.bounds.shape, SEED + i) for i, f in enumerate(prog.input_fields))
        fused.advance(fused.shard_state(state))  # warm-up: loads the built kernels
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        reset_dispatch_stats()
        t = time.perf_counter()
        out = op.apply(state, timesteps=steps, target=fused.target)
        sync()
        sec = time.perf_counter() - t
        k2_launches = launches_of("K2", ranks * epochs)
        launches_of("K1", 0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else float("nan")
        for x in out:
            check(tuple(x.shape) == tuple(prog.field_args[0].type.bounds.shape)
                  and bool(torch.isfinite(x).all()), f"{name}: shape or non-finite values")
        log(f"  {name}: {steps} steps in {epochs} epochs, {sec / steps * 1e3:.3f} ms/step "
            f"(host clock, jit=False), {k2_launches} K2 and 0 K1 launches, peak "
            f"{peak:.2f} GiB")
        unfused_kw = {k: v for k, v in kw.items() if k != "fused_epoch"}
        unfused_target = Target(device=str(dev), backend="cuda", jit=False, **unfused_kw)
        if ranks > 1:
            equal(out, one_device.pop(name.split(",")[0]),
                  f"{name}: differs from the single-device fused run")
            log(f"  {name}: bitwise equal to one device")
        else:
            base = op.apply(state, timesteps=steps, target=unfused_target)
            equal(out, base, f"{name}: differs from the unfused route (K1)")
            del base
            torch_target = Target(device=str(dev), backend="torch", jit=False)
            other = api.compile(prog, torch_target).time_loop(state, steps)
            equal(out, other, f"{name}: differs from Target(backend='torch')")
            del other
            api.forget(prog, torch_target)
            log(f"  {name}: bitwise equal to the unfused exchange_every={kw['exchange_every']} "
                "route (K1) and to Target(backend='torch')")
        # the compiled step: one graph replay an epoch, one K2 node a rank
        graphed = api.compile(prog, dataclasses.replace(fused.target, jit=True, donate=True))
        graphed.time_loop(state, steps)  # captures every rotation phase
        sync()
        reset_dispatch_stats()
        api.reset_graph_stats()
        got = op.apply(state, timesteps=steps, target=graphed.target)
        sync()
        replays = api.graph_stats().replays
        captured = graphed._graphed()
        check(not captured or replays == epochs, f"{name}, jit: {replays} replays, expected {epochs}")
        launches_of("K2", ranks * epochs, captured)
        launches_of("K1", 0, captured)
        equal(got, out, f"{name}, jit: differs from jit=False")
        held = [nodes for _, nodes, _ in graphed._ring.graphs.values()] if graphed._ring else []
        check(not captured or (held and all((n.k1, n.k2) == (0, ranks) for n in held)),
              f"{name}, jit: graphs hold {[(n.k1, n.k2) for n in held]} (K1, K2) nodes, "
              f"expected (0, {ranks})")
        log(f"  {name}, jit=True, donate=True: bitwise jit=False, {replays} replays, each of "
            f"its {len(held)} graphs holds {ranks} K2 and 0 K1 nodes")
        del got
        graphed.release_graphs()
        if ranks == 1 and any(n.startswith(f"{name},") for n, _, _, _, _ in main_cases):
            one_device[name] = out
        del out
        # the route's ms an epoch: fused and unfused, CUDA events, in turns
        routes = {"fused": fused, "unfused": api.compile(prog, unfused_target)}
        sharded = fused.shard_state(state)
        per_epoch = {r: [] for r in routes}
        for r in ("fused", "unfused", "unfused", "fused"):
            per_epoch[r].append(ms_of(lambda r=r: routes[r].advance(sharded), 1))
        f_ms, u_ms = min(per_epoch["fused"]), min(per_epoch["unfused"])
        del sharded, state
        # K2 alone at the path's shapes (a rank's on the mesh, at each
        # corner's box), its plain version, its old plan and its bound
        coords = fused._coords if ranks > 1 else [None]
        arrays = [randn(a.type.bounds.shape, SEED + 7) for a in fused_op.body.args]
        err = 0.0
        for at in coords:
            got = k2.run_epoch_cuda(fused_op, arrays, None, coords=at)
            sync()
            t = time.perf_counter()
            want = plain(fused_op, arrays, at)
            sync()
            plain_ms = (time.perf_counter() - t) * 1e3  # the host's clock: the last box's
            err = max(err, equal(got, want, f"{name}: K2 at {at} differs from its plain version"))
            del want
            if old and "tile" not in old:
                before = k2.run_epoch_cuda(fused_op, arrays, None, coords=at, **old)
                equal(got, before, f"{name}: K2's plan differs from its other plan")
                del before
            del got
        ms = ms_of(lambda: k2.run_epoch_cuda(fused_op, arrays, None, coords=coords[-1]), 3)
        old_line = "no other plan (no streaming plan fits)" if ranks == 1 else "one device's plan"
        if old and "tile" not in old:
            old_ms = ms_of(lambda: k2.run_epoch_cuda(fused_op, arrays, None, coords=coords[-1],
                                                     **old), 1)
            old_line = f"other plan {old_ms:.4f} ms ({plan_line(fused_op, **old)})"
        elif old:
            old_line = f"other plan {old}: timed at {small}^3 in (a)"
        b_ms, b_by = least_ms(*roofline.epoch_counts(fused_op))
        log(f"  K2 {name}: {ms:.4f} ms/launch, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f} % of bound, plain {plain_ms:.3f} ms, max|err| {err}; "
            f"ms/epoch of the route (jit=False, best of 2): fused {f_ms:.4f}, unfused "
            f"(k={kw['exchange_every']} K1 launches) {u_ms:.4f}; {plan_line(fused_op)}; "
            f"{old_line}")
        records.append({
            "name": f"epoch_kernel[{name}, {kind_of(plan)}]", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": k2_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        del arrays, routes
        for t in (fused.target, unfused_target, graphed.target):
            api.forget(prog, t)
        if on_card:
            torch.cuda.empty_cache()
    check(not one_device, "phase 20: the 2x2x1 case found no single-device run to hold it to")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return records


def least_ms(n_ops, n_bytes):
    """The least time for ``n_bytes`` of device memory and ``n_ops`` float32
    operations on an H100, and which of the two bounds it."""
    from repro_torch.launch import roofline

    t_bytes, t_ops = n_bytes / roofline.HBM_BW, n_ops / roofline.PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase20_alone() -> int:
    """``python3 chip_smoke.py --phase 20``: the card and phase 20 alone."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    records = deep_phase(dev, card=card)
    log(f"phase 20 alone: {len(records)} kernel records")
    log(card_line())
    return 0


def phase19_alone() -> int:
    """``python3 chip_smoke.py --phase 19``: the card and phase 19 alone, on
    four cards with its process part (d)-(f)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    n = torch.cuda.device_count()
    log(f"phase 19 alone on {n} card(s)")
    p19_phase(dev, card=card, processes=4 if n >= 4 else None)
    log(card_line())
    return 0


def phase18_alone() -> int:
    """``python3 chip_smoke.py --phase 18``: the card and phase 18 alone, on
    four cards with its process part (d)-(f)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    n = torch.cuda.device_count()
    log(f"phase 18 alone on {n} card(s)")
    tp_phase(dev, card=card, processes=4 if n >= 4 else None)
    log(card_line())
    return 0


def one_card_ms(dev, n2, steps=STEPS) -> dict:
    """Phase 17's cases at ``n2``² on one card under ``jit`` (ms/step by
    CUDA events after a warm-up run, the best of 3): the baseline of the
    speed-ups and of the weak-scaling efficiency when phase 17 runs alone;
    the whole script takes phase 10's."""
    import torch

    from repro_torch import api

    fused = {"exchange_every": 4, "fused_epoch": True}
    got = []
    for kind, kw in (("heat", {}), ("heat", fused), ("wave", fused)):
        prog = process_program(kind, "zero", (n2, n2))
        target = api.Target(device=str(dev), backend="cuda", jit=True, donate=True, **kw)
        step = api.compile(prog, target)
        epochs = step.epochs(steps)
        state = _advance(step, step.shard_state(process_state(prog, dev)), epochs)
        best = float("inf")
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state = _advance(step, state, epochs)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / steps)
        got.append(best)
        del state
        api.forget(prog, target)
        torch.cuda.empty_cache()
    k1, heat4, wave4 = got
    log(f"  one card, {n2}x{n2} under jit: heat k=1 {k1:.4f}, heat k=4 fused {heat4:.4f}, wave "
        f"k=4 fused {wave4:.4f} ms/step")
    return {"heat k=1 zero": k1, "heat k=1 overlap": k1, "heat k=4 fused": heat4,
            "wave k=4 fused": wave4, "weak heat k=1": k1, "weak heat k=4 fused": heat4}


def phase17_alone() -> int:
    """``python3 chip_smoke.py --phase 17``: the card and phase 17 alone,
    against one card's times of its cases taken here (the whole script
    runs for minutes, which four cards pay four times over)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"phase 17 alone on {torch.cuda.device_count()} card(s)")
    process_phase(dev, card=card, one_card_ms=one_card_ms(dev, 16384))
    log(card_line())
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--phase", "17"]:
        return phase17_alone()
    if sys.argv[1:] == ["--phase", "18"]:
        return phase18_alone()
    if sys.argv[1:] == ["--phase", "19"]:
        return phase19_alone()
    if sys.argv[1:] == ["--phase", "20"]:
        return phase20_alone()
    t_start = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch import api
    from repro_torch.api import Target
    from repro_torch.core import ir
    from repro_torch.core.dialects import stencil
    from repro_torch.core.fd import laplacian_star, radius
    from repro_torch.core.lowering import eval_apply_body
    from repro_torch.core.passes.decompose import make_strategy_2d, make_strategy_3d
    from repro_torch.dist import Mesh
    from repro_torch.frontends.psyclone_like import recognize
    from repro_torch.kernels import dispatch_stats, ops, ref, reset_dispatch_stats
    from repro_torch.kernels import epoch_kernel as k2
    from repro_torch.kernels import stencil_apply as k1
    from repro_torch.kernels.graphs import GraphCensus
    from repro_torch.launch import roofline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    # -- phase 0: the card --------------------------------------------------
    card = card_line()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"python={sys.version.split()[0]} nvcc={k1.find_nvcc()}")

    # -- the programs and applies of every phase ------------------------------
    def heat_op(shape, so):
        return fig7_op("heat", shape, so)

    def wave_op(shape, so):
        return fig7_op("wave", shape, so)

    def heat_periodic_op(shape, so):
        return fig7_op("heat", shape, so, "periodic")

    def index_program(shape):
        """Two chained applies, the first reading stencil.index and
        select_ge_zero (+ - * / only, so bitwise); fuses at k=1."""
        from repro_torch.core.builder import Expr
        from repro_torch.frontends.oec_like import ProgramBuilder

        pb = ProgramBuilder("index_chain", shape)
        u, out = pb.input("u"), pb.output("out")

        def first(b, v):
            acc = v.at(0, 0) * 0.5
            for d in range(2):
                idx = Expr(b, b.insert(stencil.IndexOp(d)).results[0])
                acc = acc + idx * (0.25 / (d + 1)) - v.at(*((1, 0) if d == 0 else (0, 1))) / 3.0
            neg = Expr(b, b.const(0.0)) - acc
            return Expr(b, b.insert(ir.SelectGeZeroOp(acc.value, acc.value, neg.value)).results[0])

        def second(b, v):
            return v.at(0, 0) * 0.5 + (v.at(1, 0) + v.at(-1, 0) + v.at(0, 1) + v.at(0, -1)) * 0.125

        pb.store(pb.apply([pb.apply([pb.load(u)], first)], second), out)
        return pb.finish(boundary="zero")

    def spec_of(apply_op):
        return (
            apply_op,
            [tuple(o.type.bounds.shape) for o in apply_op.operands],
            [tuple(o.type.bounds.lb) for o in apply_op.operands],
            apply_op.result_bounds,
        )

    def star_spec(coeffs, core, halo):
        apply_op, _ = ops.star_apply_ir(coeffs, core, halo)
        return spec_of(apply_op)

    def heat_star(rank, so, alpha=0.05):
        star = {k: alpha * v for k, v in laplacian_star(rank, so).items()}
        star[(0,) * rank] = star.get((0,) * rank, 0.0) + 1.0
        return star

    n2, n3 = 16384, 1024
    n_pool = 1024  # phase 1's pooled K1 case and phase 13's small tenants
    rng = torch.Generator().manual_seed(SEED)
    rand_star = {(0, 0): 0.3}
    for d in range(2):
        for o in (-3, -2, -1, 1, 2, 3):
            off = tuple(o if k == d else 0 for k in range(2))
            rand_star[off] = float(torch.randn((), generator=rng))
    box = {(i, j, k): 1.0 / 27.0 for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)}

    main_cases = [  # (name, op, target kwargs)
        (f"heat2d_so{so} {n2}x{n2}", heat_op((n2, n2), so), {}) for so in (2, 4, 8)
    ] + [(f"heat3d_so4 {n3}x{n3}x{n3}", heat_op((n3,) * 3, 4), {})]
    epoch_case = (f"heat2d_so4 {n2}x{n2} exchange_every=4", main_cases[1][1], {"exchange_every": 4})
    wave_case = (f"wave2d_so4 {n2}x{n2}", wave_op((n2, n2), 4), {})
    small = [
        ("heat2d_so4 64x64", heat_op((64, 64), 4)),
        ("heat3d_so4 24x20x28", heat_op((24, 20, 28), 4)),
        ("wave2d_so4 64x48", wave_op((64, 48), 4)),
    ]

    def compiled(op, **kw):
        """The artifact of the cuda backend; run op by op (jit=False) unless
        ``kw`` asks for the compiled step."""
        prog = op if isinstance(op, api.Program) else op.program
        return api.compile(prog, Target(backend="cuda", **{"jit": False, **kw}))

    fused = {"exchange_every": 4, "fused_epoch": True}
    fused_cases = [  # the fused main path: (name, op, target kwargs)
        (f"heat2d_so4 {n2}x{n2} k=4 fused", main_cases[1][1], fused),
        (f"wave2d_so4 {n2}x{n2} k=4 fused", wave_case[1], fused),
    ]

    # phase 8: four ranks on this one card, a 2x2 mesh (2x2x1 in 3-D)
    on_2x2 = {"mesh": Mesh([[dev, dev], [dev, dev]], ("x", "y")),
              "strategy": make_strategy_2d((2, 2))}
    on_2x2x1 = {"mesh": Mesh([[[dev], [dev]], [[dev], [dev]]], ("x", "y", "z")),
                "strategy": make_strategy_3d((2, 2, 1))}
    heat_periodic = heat_periodic_op((n2, n2), 4)
    dist_cases = [  # (name, op, target kwargs, the mesh's kwargs)
        (f"heat2d_so4 {n2}x{n2} zero, 2x2 ranks", main_cases[1][1], {}, on_2x2),
        (f"heat2d_so4 {n2}x{n2} periodic, 2x2 ranks", heat_periodic, {}, on_2x2),
        (f"heat2d_so4 {n2}x{n2} zero overlap, 2x2 ranks", main_cases[1][1],
         {"overlap": True}, on_2x2),
        (f"heat2d_so4 {n2}x{n2} periodic overlap, 2x2 ranks", heat_periodic,
         {"overlap": True}, on_2x2),
        (f"heat2d_so4 {n2}x{n2} k=4 fused zero, 2x2 ranks", main_cases[1][1], fused, on_2x2),
        (f"heat2d_so4 {n2}x{n2} k=4 fused periodic, 2x2 ranks", heat_periodic, fused, on_2x2),
        (f"wave2d_so4 {n2}x{n2} k=4 fused, 2x2 ranks", wave_case[1], fused, on_2x2),
        (f"heat3d_so4 {n3}x{n3}x{n3}, 2x2x1 ranks", main_cases[3][1], {}, on_2x2x1),
    ]
    profiled = {dist_cases[0][0], dist_cases[2][0], dist_cases[4][0]}  # k=1, overlap, fused
    # phase 9: fig-10 advection, recognized by the psyclone-like frontend
    n_adv = 512
    adv_cases = [(f"{kern.__name__} {n_adv}^3 {bc}", recognize(kern, (n_adv,) * 3, boundary=bc))
                 for kern in (pw_advection, tracer_advection) for bc in ("zero", "periodic")]

    def epoch_of(op, k):
        (fused_op,) = compiled(op, exchange_every=k, fused_epoch=True).kernel_epochs()
        return fused_op

    phase6 = [(f"heat2d_so{so} {n2}x{n2} k=4 {bc}",
               epoch_of((heat_op if bc == "zero" else heat_periodic_op)((n2, n2), so), 4), None)
              for so in (2, 4, 8) for bc in ("zero", "periodic")]
    phase6 += [
        (f"wave2d_so4 {n2}x{n2} k=4 zero", epoch_of(wave_case[1], 4), None),
        ("heat3d_so4 128^3 k=2 zero", epoch_of(heat_op((128,) * 3, 4), 2), None),
        ("index chain 2000x1536 k=1", epoch_of(index_program((2000, 1536)), 1), None),
        (f"heat2d_so4 {n2}x{n2} k=4 zero, tile (32, 128)", phase6[2][1], (32, 128)),
    ]
    phase6 += [("heat3d_so4 128^3 k=2 zero, tile (8, 8, 32)", phase6[7][1], (8, 8, 32))]

    wave_apply = compiled(wave_case[1]).kernel_applies()[0]
    phase1 = [(f"heat2d_so{so} {n2}x{n2}", star_spec(heat_star(2, so), (n2, n2), (radius(so),) * 2))
              for so in (2, 4, 8)]
    phase1 += [(f"heat3d_so{so} {n3}^3", star_spec(heat_star(3, so), (n3,) * 3, (radius(so),) * 3))
               for so in (2, 4, 8)]
    phase1 += [
        (f"wave2d_so4 {n2}x{n2} (program apply)", spec_of(wave_apply)),
        (f"random star r3 {n2}x{n2}", star_spec(rand_star, (n2, n2), (3, 3))),
        (f"box27 {n3}^3", star_spec(box, (n3,) * 3, (1, 1, 1))),
    ]
    phase1_sources = [k1.emit_apply_cuda(*s) for _, s in phase1]
    # operands at a storage offset of 1 and 2 floats: pointers only 4- and
    # 8-byte aligned, which the wrappers meet with narrower cp.async copies
    misaligned = [(1, 4), (2, 8)]  # (offset in floats, pointer alignment in bytes)
    skewed_k1, skewed_k2 = phase1[1], phase6[2]  # heat2d_so4 16384², its k=4 zero epoch
    skewed_sources = [k1.emit_apply_cuda(*skewed_k1[1], ptr_align=a) for _, a in misaligned]
    skewed_sources += [k2.emit_epoch_cuda(skewed_k2[1], None, ptr_align=a) for _, a in misaligned]
    sources = phase1_sources + skewed_sources[:2]
    for _, op, kw in main_cases + [epoch_case, wave_case]:
        sources += [k1.emit_apply_cuda(*spec_of(a)) for a in compiled(op, **kw).kernel_applies()]
    for _, op in small:
        sources += [k1.emit_apply_cuda(*spec_of(a)) for a in compiled(op).kernel_applies()]
    for _, op, kw, mesh_kw in dist_cases:
        step_ = compiled(op, **kw, **mesh_kw)
        for a in step_.kernel_applies():
            sources.append(k1.emit_apply_cuda(*spec_of(a)))
            if step_.kernel_out_strides(a) is not None:  # a part of an in-place combine
                sources.append(k1.emit_apply_cuda(*spec_of(a), out_strides=step_.kernel_out_strides(a)))
    for _, prog in adv_cases:
        for mesh_kw in ({}, on_2x2x1):
            sources += [k1.emit_apply_cuda(*spec_of(a))
                        for a in compiled(prog, **mesh_kw).kernel_applies()]
    sources = list(dict.fromkeys(sources))
    n_k1 = len(sources)
    sources += [k2.emit_epoch_cuda(fused_op, tile) for _, fused_op, tile in phase6]
    for _, op, kw, mesh_kw in dist_cases:
        sources += [k2.emit_epoch_cuda(e) for e in compiled(op, **kw, **mesh_kw).kernel_epochs()]
    sources += skewed_sources[2:]
    for _, prog, target in serving_targets(dev):  # phase 13's pools (one source any width)
        sources += api.compile(prog, target).kernel_sources()
    pooled_k1 = (f"heat2d_so4 {n_pool}x{n_pool}", star_spec(heat_star(2, 4), (n_pool, n_pool), (2, 2)))
    sources.append(k1.emit_apply_cuda(*pooled_k1[1]))
    sources += deep_sources(dev, n3)  # phase 20's
    sources = list(dict.fromkeys(sources))
    t0 = time.perf_counter()
    k1.build(sources)
    log(f"build: {n_k1} K1 and {len(sources) - n_k1} K2 sources with nvcc in "
        f"{time.perf_counter() - t0:.1f} s (flags {' '.join(k1.NVCC_FLAGS)})")
    def resource_line(label, source, symbol):
        log(f"  {label}: {kernel_resources(source, symbol)}")

    log("build: ptxas registers, shared memory per CTA and resident CTAs per SM "
        "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    for (name, _), source in zip(phase1, phase1_sources):
        resource_line(f"K1 {name}", source, "k1_apply_occupancy")
    for name, op, kw in main_cases + [epoch_case, wave_case]:
        for n, a in enumerate(compiled(op, **kw).kernel_applies()):
            resource_line(f"K1 main path {name}, apply {n}", k1.emit_apply_cuda(*spec_of(a)),
                          "k1_apply_occupancy")
    for name, fused_op, tile in phase6:
        resource_line(f"K2 {name}", k2.emit_epoch_cuda(fused_op, tile), "k2_epoch_occupancy")
    for (_, align), src1, src2 in zip(misaligned, skewed_sources, skewed_sources[2:]):
        resource_line(f"K1 {skewed_k1[0]}, {align}-byte pointers", src1, "k1_apply_occupancy")
        resource_line(f"K2 {skewed_k2[0]}, {align}-byte pointers", src2, "k2_epoch_occupancy")

    # -- shared measurement helpers ----------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(event):
        us = getattr(event, "self_device_time_total", None)
        return getattr(event, "self_cuda_time_total", 0) if us is None else us

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def kernel_ms(fn, reps, kernel):
        """The device time per call of the kernel named ``kernel`` alone
        (torch.profiler), and the host's time to enqueue one call (no call
        waits for the card); None for the first where the trace does not
        show ``reps`` launches of it."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        if sum(e.count for e in rows) != reps:
            return None, host
        return sum(device_us(e) for e in rows) / 1e3 / reps, host

    def skewed(shape, offset):
        """A random operand whose data starts ``offset`` floats into its
        storage (a contiguous view; offset 0 is a plain allocation)."""
        flat = torch.randn(_numel(shape) + offset, device=dev, generator=gen)
        return flat[offset:].view(shape)

    def bound(spec):
        """Bytes: the window of each operand the apply reads (its result
        grown by the operand's access extent; a full apply's whole padded
        operand, a frame's thin strip), once, and each result written once
        (the cost model's count, ``launch.roofline.apply_counts``)."""
        n_ops, n_bytes = roofline.apply_counts(spec[0])
        return (*least_ms(n_ops, n_bytes), n_bytes, n_ops)

    def conv_weights(spec):
        """The star of a one-operand linear apply, from its impulse responses
        (plain version on the CPU), as a conv weight; None otherwise."""
        apply_op, shapes, origins, rb = spec
        if len(apply_op.operands) != 1 or len(apply_op.results) != 1:
            return None
        lo, hi = apply_op.access_extents()[0]
        h = max(max(-l for l in lo), max(hi))
        rank = rb.rank
        one = stencil.Bounds((0,) * rank, (1,) * rank)
        org = [(-h,) * rank]

        def at(x):
            return eval_apply_body(apply_op, [x], org, one)[0].reshape(())

        zero = torch.zeros((2 * h + 1,) * rank)
        w = torch.zeros((2 * h + 1,) * rank)
        base = at(zero)
        for op in apply_op.body.ops:
            if isinstance(op, stencil.AccessOp):
                idx = tuple(h + o for o in op.offset)
                e = zero.clone()
                e[idx] = 1.0
                w[idx] = at(e) - base
        # linear and homogeneous: f(x) == conv(x, w) at a random point
        x = torch.randn((2 * h + 1,) * rank, generator=rng)
        if base != 0 or abs(float(at(x)) - float((w * x).sum())) > 1e-4 * (1 + float(x.abs().sum())):
            return None
        return w.reshape((1, 1) + w.shape).to(dev)

    def kernel_record(name, specs, launches, step=None):
        """Time K1, its plain version and the conv yardstick on random
        operands of the main path's shapes; hold K1 against the plain
        version (bitwise).  With ``step``, each part of an in-place combine
        writes a view of a result of the combine's shape, as on the path."""
        ms = plain_ms = lib_ms = bound_ms = 0.0
        err = 0.0
        by = set()
        lib_ok = True
        for spec in specs:
            apply_op, shapes, origins, rb = spec
            gen.manual_seed(SEED)
            arrays = [torch.randn(s, device=dev, generator=gen) for s in shapes]
            got = k1.run_apply_cuda(apply_op, arrays, origins, rb,
                                    out=part_views(step, apply_op))
            want = eval_apply_body(apply_op, arrays, origins, rb)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                err = max(err, float((g_ - w_).abs().max()))
                check(torch.equal(g_, w_), f"{name}: K1 differs from its plain version")
            del got, want
            outs = part_views(step, apply_op)
            ms += cuda_ms(lambda: k1.run_apply_cuda(apply_op, arrays, origins, rb, out=outs), 10)
            plain_ms += cuda_ms(lambda: eval_apply_body(apply_op, arrays, origins, rb), 2)
            del outs
            b_ms, b_by, _, _ = bound(spec)
            bound_ms += b_ms
            by.add(b_by)
            w = conv_weights(spec) if lib_ok else None
            if w is None:
                lib_ok = False
            else:
                conv = F.conv2d if rb.rank == 2 else F.conv3d
                x = arrays[0].reshape((1, 1) + arrays[0].shape)
                try:
                    lib_ms += cuda_ms(lambda: conv(x, w), 3)
                except RuntimeError as e:  # cuDNN may refuse a shape: no yardstick then
                    log(f"  {name}: conv yardstick failed: {str(e).splitlines()[0]}")
                    lib_ok = False
            del arrays
            torch.cuda.empty_cache()
        rec = {
            "name": f"stencil_apply[{name}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": lib_ms if lib_ok else None,
        }
        log(f"  K1 {name}: {ms:.4f} ms/launch-set, bound {bound_ms:.4f} ms ({rec['bound_by']}), "
            f"plain {plain_ms:.3f} ms, conv {rec['library_ms']}, max|err| {err}")
        return rec

    def part_views(step, apply_op):
        """Per result of ``apply_op``, a view into a new tensor of its
        combine's shape where ``step`` writes it so (a part of an in-place
        ``stencil.combine``), else None; None without ``step``."""
        strides = None if step is None else step.kernel_out_strides(apply_op)
        if strides is None:
            return None
        views = []
        for res, st in zip(apply_op.results, strides):
            (comb,) = [u.operation for u in res.uses if isinstance(u.operation, stencil.CombineOp)]
            cb, rb = comb.result_bounds, res.type.bounds
            buf = torch.empty(cb.shape, device=dev)
            views.append(buf[tuple(slice(l - c, l - c + n) for l, c, n in zip(rb.lb, cb.lb, rb.shape))])
            check(tuple(views[-1].stride()) == tuple(st), "a combine part's view strides")
        return views

    # -- phase 1: K1 against its plain version on the card -----------------------
    def k1_check(name, spec, offset=0, align=16):
        """K1 against its plain version on the card, bitwise, on random
        operands at storage offset ``offset`` (pointers ``align``-byte
        aligned); timed beside its bound."""
        apply_op, shapes, origins, rb = spec
        gen.manual_seed(SEED)
        arrays = [skewed(s, offset) for s in shapes]
        check(k1.ptr_alignment(arrays) == align, f"{name}: pointers not {align}-byte aligned")
        reset_dispatch_stats()
        got = k1.run_apply_cuda(apply_op, arrays, origins, rb)
        torch.cuda.synchronize()
        launches = dispatch_stats().apply_launches
        want = eval_apply_body(apply_op, arrays, origins, rb)
        torch.cuda.synchronize()
        err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
        check(launches == 1, f"{name}: {launches} K1 launches, expected 1")
        check(all(torch.equal(g_, w_) for g_, w_ in zip(got, want)),
              f"{name}: K1 differs from its plain version (max |err| {err})")
        del got, want
        ms = cuda_ms(lambda: k1.run_apply_cuda(apply_op, arrays, origins, rb), 10)
        b_ms, b_by, _, _ = bound(spec)
        before = BEFORE_MS.get(f"K1 {name}")
        log(f"  {name}: bitwise, max|err| {err}, apply_launches {launches}, K1 {ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f} % of bound"
            + (f", before the redesign {before} ms (PERF.md)" if before else ""))
        del arrays
        torch.cuda.empty_cache()

    def pooled_check(name, kernel, slots, spec=None, fused_op=None, tile=None, corners=({},)):
        """One launch of K1 (``spec``) or K2 (``fused_op``, at each mesh
        coordinate of ``corners``) over ``[slots, *shape]`` operands: bitwise
        against its plain version and against a launch on each slot alone;
        returns (max |err|, ms a pooled launch, ms of the slots' solo
        launches, plain ms (slot by slot), the bound of ``slots`` times the
        solo work (ms, by), the library call's ms or None), timed at the
        last coordinate."""
        shapes = spec[1] if kernel == "K1" else [a.type.bounds.shape for a in fused_op.body.args]
        gen.manual_seed(SEED)
        arrays = [torch.randn((slots,) + tuple(s_), device=dev, generator=gen) for s_ in shapes]
        if kernel == "K1":
            apply_op, _, origins, rb = spec
            run = lambda xs, at: k1.run_apply_cuda(apply_op, xs, origins, rb)  # noqa: E731
            plain = lambda xs, at: eval_apply_body(apply_op, xs, origins, rb)  # noqa: E731
            n_ops, n_bytes = roofline.apply_counts(apply_op)
        else:
            run = lambda xs, at: k2.run_epoch_cuda(fused_op, xs, None, tile=tile, coords=at)  # noqa: E731
            plain = lambda xs, at: k2._emit_region(  # noqa: E731
                fused_op, xs, k2.region_masks(fused_op, dev, at), lambda v: v.type.bounds)
            n_ops, n_bytes = roofline.epoch_counts(fused_op)
        err, plain_ms, solo_ms = 0.0, 0.0, 0.0
        for at in corners:
            reset_dispatch_stats()
            got = run(arrays, at)
            torch.cuda.synchronize()
            stats = dispatch_stats()
            n = stats.apply_launches if kernel == "K1" else stats.fused_epoch_launches
            check(n == 1, f"{name}: {n} {kernel} launches for a pool of {slots}, expected 1")
            for b in range(slots):
                single = [a[b].clone() for a in arrays]
                solo, want = run(single, at), plain(single, at)
                torch.cuda.synchronize()
                err = max([err] + [float((g_[b] - w_).abs().max()) for g_, w_ in zip(got, want)])
                check(all(torch.equal(g_[b], w_) and torch.equal(g_[b], s_)
                          for g_, w_, s_ in zip(got, want, solo)),
                      f"{name} at {at}: slot {b} of the pooled {kernel} launch differs from its "
                      f"plain version or its solo launch (max |err| {err})")
                if at is corners[-1]:
                    solo_ms += cuda_ms(lambda: run(single, at), 10)
                    plain_ms += cuda_ms(lambda: plain(single, at), 1)
                del single, solo, want
            del got
        ms = cuda_ms(lambda: run(arrays, corners[-1]), 10)
        b_ms, b_by = least_ms(slots * n_ops, slots * n_bytes)
        lib_ms = None
        w = conv_weights(spec) if kernel == "K1" else None
        if w is not None:
            conv = F.conv2d if spec[3].rank == 2 else F.conv3d
            x = arrays[0].reshape((slots, 1) + tuple(arrays[0].shape[1:]))
            lib_ms = cuda_ms(lambda: conv(x, w), 3)
            del x
        del arrays
        torch.cuda.empty_cache()
        log(f"  {name}, a pool of {slots}: bitwise its plain version and {slots} solo launches, "
            f"max|err| {err}, {kernel} {ms:.4f} ms a pooled launch against {solo_ms:.4f} ms for "
            f"{slots} solo launches, bound {b_ms:.4f} ms ({b_by}; {slots} x the solo work), "
            f"{100 * b_ms / ms:.1f} % of bound, plain {plain_ms:.3f} ms"
            + ("" if lib_ms is None else f", batched conv {lib_ms:.4f} ms"))
        return err, ms, solo_ms, plain_ms, b_ms, b_by, lib_ms

    log("phase 1: K1 vs plain version on the card (bitwise)")
    for name, spec in phase1:
        k1_check(name, spec)
    for offset, align in misaligned:
        name, spec = skewed_k1
        k1_check(f"{name} at storage offset {offset} ({align}-byte pointers)", spec, offset, align)
    k1_check(*pooled_k1)
    pooled_check(pooled_k1[0], "K1", 16, spec=pooled_k1[1])

    kernels = []

    def drive(name, op, kw):
        """The counted main-path run: Operator.apply through Target(backend=
        "cuda"), counts zeroed just before and read just after; every K1
        and K2 launch the compiled epoch names must happen, and no other.
        Over a mesh every rank launches them.  Returns the launches of the
        case's kernel (K2 where it has epochs)."""
        prog = op.program
        step = compiled(op, **kw)
        ranks = step.target.spatial_ranks if step.target.distributed else 1
        gen.manual_seed(SEED)
        state = tuple(torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                      for f in prog.input_fields)
        if step.target.jit:
            # warm-up: every rotation phase is captured as a graph
            step.time_loop(state, STEPS)
        else:
            step.advance(state)  # warm-up epoch: loads the built kernels
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reset_dispatch_stats()
        api.reset_graph_stats()
        a.record()
        out = op.apply(state, timesteps=STEPS, target=Target(backend="cuda", **{"jit": False, **kw}))
        b.record()
        b.synchronize()
        stats = dispatch_stats()
        k1_launches, k2_launches = stats.apply_launches, stats.fused_epoch_launches
        epochs = step.epochs(STEPS)
        graphs = api.graph_stats()
        check(graphs.replays == (epochs if step.target.jit else 0) and graphs.captures == 0,
              f"{name}: {graphs.replays} graph replays and {graphs.captures} captures for "
              f"{epochs} epochs (jit={step.target.jit})")
        for what, got_, per in (("K1", k1_launches, len(step.kernel_applies())),
                                ("K2", k2_launches, len(step.kernel_epochs()))):
            check(got_ == ranks * epochs * per,
                  f"{name}: {got_} {what} launches, expected {ranks * epochs * per}")
        sec = a.elapsed_time(b) / 1e3
        points = _numel(prog.field_args[0].type.bounds.shape)
        log(f"  {name}: {STEPS} steps, {sec / STEPS * 1e3:.3f} ms/step, "
            f"{points * STEPS / sec / 1e9:.3f} GPts/s, apply_launches {k1_launches}, "
            f"fused_epoch_launches {k2_launches} ({epochs} epochs), "
            + (f"{graphs.replays} graph replays, " if step.target.jit else "")
            + f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        for t in out:
            check(tuple(t.shape) == tuple(prog.field_args[0].type.bounds.shape), f"{name}: shape")
            check(bool(torch.isfinite(t).all()), f"{name}: non-finite values")
        launches = k2_launches if step.kernel_epochs() else k1_launches
        return state, out, launches, [spec_of(x) for x in step.kernel_applies()]

    def same(name, out, other, what):
        diff = max(float((x - y).abs().max()) for x, y in zip(out, other))
        check(len(out) == len(other) and all(torch.equal(x, y) for x, y in zip(out, other)),
              f"{name}: differs from {what} (max |diff| {diff})")
        log(f"  {name}: bitwise equal to {what}")

    # -- phase 2: the main path at the paper's sizes ---------------------------
    log("phase 2: heat main path, backend cuda vs backend torch")
    for name, op, kw in main_cases:
        state, out, launches, specs = drive(name, op, kw)
        other = api.compile(op.program, Target(jit=False, backend="torch", **kw)).time_loop(state, STEPS)
        same(name, out, other, "Target(backend='torch')")
        del state, out, other
        torch.cuda.empty_cache()
        kernels.append(kernel_record(name, specs, launches))

    log("phase 2b: small grids against the oracles of kernels/ref.py (rtol=atol=1e-5)")
    for name, op in small:
        prog = op.program
        so = op.updates[0][0].space_order
        h = radius(so)
        gen.manual_seed(SEED)
        state = tuple(torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                      for f in prog.input_fields)
        out = op.apply(state, timesteps=STEPS, target=Target(jit=False, backend="cuda"))
        want = list(state)
        for _ in range(STEPS):
            padded = [F.pad(s, [h, h] * s.ndim) for s in want]
            if len(want) == 1:
                want = [ref.heat_step_ref(padded[0], 0.1 * 0.5, so, h)]
            else:
                want = [want[1], ref.wave_step_ref(padded[1], padded[0], 0.1 ** 2, so, h)]
        for x, y in zip(out, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        log(f"  {name}: matches the oracle over {STEPS} steps "
            f"(max |diff| {max(float((x - y).abs().max()) for x, y in zip(out, want))})")

    # -- phase 3: epochs without the epoch kernel --------------------------------
    log("phase 3: heat exchange_every=4 (4 K1 launches per epoch) vs exchange_every=1")
    name, op, kw = epoch_case
    state, out, launches, specs = drive(name, op, kw)
    base = op.apply(state, timesteps=STEPS, target=Target(jit=False, backend="cuda"))
    same(name, out, base, "the exchange_every=1 run")
    del state, out, base
    torch.cuda.empty_cache()
    kernels.append(kernel_record(name, specs, launches))

    # -- phase 4: wave, two-buffer rotation --------------------------------------
    log("phase 4: wave main path, backend cuda vs backend torch")
    name, op, kw = wave_case
    state, out, launches, specs = drive(name, op, kw)
    other = api.compile(op.program, Target(jit=False, backend="torch")).time_loop(state, STEPS)
    same(name, out, other, "Target(backend='torch')")
    del state, out, other
    torch.cuda.empty_cache()
    kernels.append(kernel_record(name, specs, launches))

    # -- phase 5: where a step's device time goes ---------------------------
    def run_steps(step, state, n):
        """Enqueue ``n`` steps as epochs of ``advance`` on the state as the
        artifact keeps it between epochs (sharded over a mesh)."""
        for _ in range(step.epochs(n)):
            state = step.advance(state)
        return state

    def where_time_goes(name, step, state):
        """Host time to enqueue a step, untraced wall time, and the device
        time by kernel and busy share over 4 steps (torch.profiler), after
        a warm-up epoch."""
        state = step.advance(step.shard_state(state))
        torch.cuda.synchronize()
        # host clock: the time to enqueue 8 steps (nothing in the cuda
        # route waits for the card), then the wall time until they finish
        t0 = time.perf_counter()
        state = run_steps(step, state, STEPS)
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
        log(f"  {name}: host enqueue {t_host / STEPS * 1e3:.3f} ms/step, "
            f"untraced wall {t_wall / STEPS * 1e3:.3f} ms/step")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_steps(step, state, 4)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            # device kernels only: a CPU op (aten::copy_) reports its
            # kernels' time again, and the tracer's own buffer requests
            # are no work of the program
            if e.device_type != DeviceType.CUDA or e.key == "Activity Buffer Request":
                continue
            us = device_us(e)
            if us > 0:
                rows.append((us / 1e3, e.key, e.count))
        busy = sum(r[0] for r in rows)
        log(f"  {name}: traced wall {wall_ms / 4:.3f} ms/step, device busy "
            f"{busy / 4:.3f} ms/step ({100 * busy / wall_ms:.1f} % of wall)")
        for ms_, key, count in sorted(rows, reverse=True)[:8]:
            log(f"    {ms_ / 4:8.3f} ms/step  {count // 4:3d}/step  {key[:90]}")
        return rows, t_host / STEPS * 1e3

    log("phase 5: device time by kernel over 4 main-path steps (torch.profiler)")
    for name, op, kw in (main_cases[1], main_cases[2], main_cases[3], fused_cases[0]):
        gen.manual_seed(SEED)
        state = tuple(torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                      for f in op.program.input_fields)
        where_time_goes(name, compiled(op, **kw), state)
        del state
        torch.cuda.empty_cache()

    # -- phase 6: the epoch kernel K2 ------------------------------------------
    def epoch_bound(fused_op):
        """Bytes: each operand read once, each escape written once.
        Operations: every float32 op of every sub-step's frame (the cost
        model's count, ``launch.roofline.epoch_counts``)."""
        return least_ms(*roofline.epoch_counts(fused_op))

    def epoch_check(name, fused_op, tile, offset=0, align=16, corners=({},)):
        """K2 against its plain version on the card, bitwise, on random
        operands at storage offset ``offset`` (pointers ``align``-byte
        aligned), at each mesh coordinate of ``corners`` (its box by launch
        arguments; the plain version's masks built at it); returns (max
        |err|, K2 ms, plain ms, K2's device ms by the profiler, host ms to
        enqueue it), timed at the last coordinate."""
        gen.manual_seed(SEED)
        arrays = [skewed(a.type.bounds.shape, offset) for a in fused_op.body.args]
        check(k1.ptr_alignment(arrays) == align, f"{name}: pointers not {align}-byte aligned")
        err = 0.0
        for at in corners:
            reset_dispatch_stats()
            got = k2.run_epoch_cuda(fused_op, arrays, None, tile=tile, coords=at)
            torch.cuda.synchronize()
            launches = dispatch_stats().fused_epoch_launches
            check(launches == 1, f"{name}: {launches} K2 launches, expected 1")
            masks = k2.region_masks(fused_op, dev, at)
            want = k2._emit_region(fused_op, arrays, masks, lambda v: v.type.bounds)
            torch.cuda.synchronize()
            err = max([err] + [float((g_ - w_).abs().max()) for g_, w_ in zip(got, want)])
            check(len(got) == len(want) and all(torch.equal(g_, w_) for g_, w_ in zip(got, want)),
                  f"{name} at {at}: K2 differs from its plain version (max |err| {err})")
            del got, want
        ms = cuda_ms(lambda: k2.run_epoch_cuda(fused_op, arrays, None, tile=tile, coords=at), 10)
        dev_ms, host_ms = kernel_ms(
            lambda: k2.run_epoch_cuda(fused_op, arrays, None, tile=tile, coords=at), 50, "k2_epoch")
        plain_ms = cuda_ms(
            lambda: k2._emit_region(fused_op, arrays, masks, lambda v: v.type.bounds), 2)
        del arrays, masks
        torch.cuda.empty_cache()
        return err, ms, plain_ms, dev_ms, host_ms

    log("phase 6: K2 vs plain version on the card (bitwise)")
    tiled = {}
    for name, fused_op, tile in phase6:
        plan = k2.plan_epoch(fused_op, tile)
        err, ms, plain_ms, dev_ms, host_ms = epoch_check(name, fused_op, tile)
        b_ms, b_by = epoch_bound(fused_op)
        before = BEFORE_MS.get(f"K2 {name}")
        log(f"  {name}: bitwise, max|err| {err}, tile {plan.tile}, "
            f"{k2._storage(fused_op, plan).smem_bytes} B shared, K2 {ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f} % of bound, "
            f"device-only {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}, "
            f"host enqueue {host_ms:.4f} ms/call, plain {plain_ms:.3f} ms"
            + (f", before the redesign {before} ms (PERF.md)" if before else ""))
        if fused_op is phase6[2][1]:
            gen.manual_seed(SEED)
            arrays = [torch.randn(a.type.bounds.shape, device=dev, generator=gen)
                      for a in fused_op.body.args]
            tiled[tile] = k2.run_epoch_cuda(fused_op, arrays, None, tile=tile)
            del arrays
    (a_out,), (b_out,) = tiled.values()
    check(len(tiled) == 2 and torch.equal(a_out, b_out),
          "K2 with tile (32, 128) differs from K2 with its default tile")
    log("  heat2d_so4 k=4: tile (32, 128) bitwise equal to the default tile")
    del tiled, a_out, b_out
    torch.cuda.empty_cache()
    pooled_check(phase6[2][0], "K2", 2, fused_op=phase6[2][1])
    for offset, align in misaligned:
        name, fused_op, _ = skewed_k2
        err, ms, _, dev_ms, _ = epoch_check(name, fused_op, None, offset, align)
        log(f"  {name} at storage offset {offset} ({align}-byte pointers): bitwise, "
            f"K2 {ms:.4f} ms, device-only "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}")

    log("phase 6b: fused main path, one K2 launch and no K1 launch per epoch")
    for name, op, kw in fused_cases:
        state, out, launches, _ = drive(name, op, kw)
        unfused_kw = {"exchange_every": kw["exchange_every"]}
        base = op.apply(state, timesteps=STEPS, target=Target(jit=False, backend="cuda", **unfused_kw))
        same(name, out, base, "the unfused exchange_every=4 route (K1)")
        del base
        other = api.compile(op.program, Target(jit=False, backend="torch")).time_loop(state, STEPS)
        same(name, out, other, "Target(backend='torch')")
        del state, out, other
        torch.cuda.empty_cache()
        (fused_op,) = compiled(op, **kw).kernel_epochs()
        err, ms, plain_ms, _, _ = epoch_check(name, fused_op, None)
        b_ms, b_by = epoch_bound(fused_op)
        # beside it, the same epoch unfused: k K1 launches (no library call
        # computes an epoch)
        unfused_ms = 0.0
        for spec in [spec_of(x) for x in compiled(op, **unfused_kw).kernel_applies()]:
            apply_op, shapes, origins, rb = spec
            gen.manual_seed(SEED)
            arrays = [torch.randn(s_, device=dev, generator=gen) for s_ in shapes]
            unfused_ms += cuda_ms(lambda: k1.run_apply_cuda(apply_op, arrays, origins, rb), 10)
            del arrays
        torch.cuda.empty_cache()
        kernels.append({
            "name": f"epoch_kernel[{name}]", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        log(f"  K2 {name}: {ms:.4f} ms/launch, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f} % of bound, plain {plain_ms:.3f} ms, "
            f"unfused K1 epoch {unfused_ms:.4f} ms, library none, max|err| {err}")

    # -- phase 7: the tests marked gpu, on this card ---------------------------
    log("phase 7: pytest -m gpu on this card")
    root = Path(__file__).resolve().parent
    tests = ["tests/test_torch_kernels.py", "tests/test_torch_epoch_kernel.py", "tests/test_torch_jit.py",
             "tests/test_torch_tune.py", "tests/test_torch_processes.py"]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider", *tests],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    log("  " + (run.stdout.strip().splitlines() or ["(no output)"])[-1])
    check(run.returncode == 0, f"the gpu-marked tests failed:\n{run.stdout[-3000:]}{run.stderr[-2000:]}")

    # -- phase 8: distribution, four ranks on this one card ---------------------
    def ms_per_step(step, state):
        """ms per step of ``advance`` epochs on the state as the artifact
        keeps it (sharded over a mesh: no shard or gather inside), by CUDA
        events after a warm-up epoch."""
        state = step.advance(step.shard_state(state))
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run_steps(step, state, STEPS)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / STEPS

    log("phase 8: distribution, 4 ranks on one card (2x2 mesh, 2x2x1 in 3-D), "
        "bitwise against the single-device cuda run")
    corners = [{"x": x, "y": y} for x in (0, 1) for y in (0, 1)]
    for name, op, kw, mesh_kw in dist_cases:
        state, out, launches, specs = drive(name, op, {**kw, **mesh_kw})
        one = op.apply(state, timesteps=STEPS, target=Target(jit=False, backend="cuda", **kw))
        same(name, out, one, "the single-device cuda run")
        del out, one
        torch.cuda.empty_cache()
        dist_step, one_step = compiled(op, **kw, **mesh_kw), compiled(op, **kw)
        times = {dist_step: [], one_step: []}
        # three rounds in turns (4 ranks, one device, one device, 4 ranks, ...):
        # a step's time follows the shared host, so one pair says little
        for step in [dist_step, one_step, one_step, dist_step, dist_step, one_step]:
            times[step].append(ms_per_step(step, state))
            torch.cuda.empty_cache()
        (d_lo, d_ms, d_hi), (s_lo, s_ms, s_hi) = (sorted(times[dist_step]), sorted(times[one_step]))
        log(f"  {name}: {d_ms:.3f} [{d_lo:.3f}-{d_hi:.3f}] ms/step over 4 ranks, "
            f"{s_ms:.3f} [{s_lo:.3f}-{s_hi:.3f}] ms/step on one device (CUDA events on the "
            f"sharded state, median [min-max] of 3 runs of {STEPS} steps in turns)")
        if name in profiled:
            where_time_goes(name, dist_step, state)
        del state
        torch.cuda.empty_cache()
        if not dist_step.kernel_epochs():
            kernels.append(kernel_record(name, specs, launches, dist_step))
            continue
        (fused_op,) = dist_step.kernel_epochs()
        err, ms, plain_ms, dev_ms, _ = epoch_check(name, fused_op, None, corners=corners)
        b_ms, b_by = epoch_bound(fused_op)
        kernels.append({
            "name": f"epoch_kernel[{name}]", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        log(f"  K2 {name}: bitwise at each corner's box, {ms:.4f} ms/launch, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f} % of bound, device-only "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}, "
            f"plain {plain_ms:.3f} ms, max|err| {err}")

    # -- phase 9: fig-10 advection ------------------------------------------------
    log(f"phase 9: fig-10 advection at {n_adv}^3 (psyclone-like frontend), cuda vs torch "
        "and 2x2x1 ranks vs one device, bitwise")
    for name, prog in adv_cases:
        one, dist = compiled(prog), compiled(prog, **on_2x2x1)
        applies = one.kernel_applies()
        if name.startswith("pw_advection"):
            check(len(applies) == 1 and len(applies[0].results) == 3,
                  f"{name}: PW advection did not fuse to one apply with three results")
        gen.manual_seed(SEED)
        args = [torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                for f in prog.field_args]
        outs, launches = {}, {}
        for label, step, ranks in (("one device", one, 1), ("2x2x1 ranks", dist, 4)):
            step(*args)  # warm-up: loads the built kernels
            torch.cuda.synchronize()
            reset_dispatch_stats()
            outs[label] = step(*args)
            torch.cuda.synchronize()
            launches[label] = dispatch_stats().apply_launches
            check(launches[label] == ranks * len(applies), f"{name}, {label}: "
                  f"{launches[label]} K1 launches, expected {ranks * len(applies)}")
        got = outs["one device"]
        for t in got:
            check(tuple(t.shape) == (n_adv,) * 3 and bool(torch.isfinite(t).all()),
                  f"{name}: shape or non-finite values")
        same(name, got, api.compile(prog, Target(jit=False, backend="torch"))(*args),
             "Target(backend='torch')")
        same(f"{name}, 2x2x1 ranks", outs["2x2x1 ranks"], got, "the single-device cuda run")
        del outs, got
        torch.cuda.empty_cache()
        one_ms, dist_ms = cuda_ms(lambda: one(*args), 3), cuda_ms(lambda: dist(*args), 3)
        log(f"  {name}: {one_ms:.3f} ms/call on one device, {dist_ms:.3f} ms/call over "
            f"4 ranks (global tensors in and out: shard and gather included), "
            f"{len(applies)} apply/call ({', '.join(str(len(a.results)) for a in applies)} results)")
        del args
        torch.cuda.empty_cache()
        kernels.append(kernel_record(name, [spec_of(a) for a in applies], launches["one device"]))
        kernels.append(kernel_record(f"{name}, 2x2x1 ranks",
                                     [spec_of(a) for a in dist.kernel_applies()],
                                     launches["2x2x1 ranks"]))

    # -- phase 10: the compiled step (one CUDA graph replay per epoch) ---------
    def frames_record(name, step, frames, launches):
        """K1 over the overlap path's boundary frames of one rank, as the
        path launches them: each frame into its view of one result of the
        combine's shape; bitwise against the plain version, timed beside
        the least time to read each frame's window once and write the
        frame once."""
        (comb,) = [op for op in step.local_ir.body.ops if isinstance(op, stencil.CombineOp)]
        cb = comb.result_bounds
        gen.manual_seed(SEED)
        padded = frames[0].operands[0].type.bounds
        check(all(a.operands[0].type.bounds == padded and len(a.operands) == 1 for a in frames),
              f"{name}: the frames read one padded operand")
        x = torch.randn(padded.shape, device=dev, generator=gen)
        got, want = torch.zeros(cb.shape, device=dev), torch.zeros(cb.shape, device=dev)

        def view(buf, rb):
            return buf[tuple(slice(l - c, l - c + n) for l, c, n in zip(rb.lb, cb.lb, rb.shape))]

        def run_k1():
            for a in frames:
                k1.run_apply_cuda(a, [x], [padded.lb], a.result_bounds, out=[view(got, a.result_bounds)])

        def run_plain():
            for a in frames:
                view(want, a.result_bounds).copy_(eval_apply_body(a, [x], [padded.lb], a.result_bounds)[0])

        run_k1()
        run_plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"{name}: K1 frames differ from their plain version ({err})")
        # the frames' launches as the path runs them, in a graph: one launch
        # from the host would time the host's launch rate, not the frames
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run_k1()
        ms, host_ms = cuda_ms(graph.replay, 20), cuda_ms(run_k1, 10)
        plain_ms = cuda_ms(run_plain, 2)
        del graph
        b_ms = b_by = 0
        for a in frames:
            one_ms, one_by, _, _ = bound(spec_of(a))
            b_ms, b_by = b_ms + one_ms, one_by
        rec = {
            "name": f"stencil_apply[{name}: overlap frames]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        log(f"  K1 frames {name}: {len(frames)} launches of "
            f"{', '.join('x'.join(map(str, a.result_bounds.shape)) for a in frames)} into one "
            f"{'x'.join(map(str, cb.shape))} result, {ms:.4f} ms per set in a graph "
            f"({host_ms:.4f} ms launched one by one from the host), bound "
            f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}), plain {plain_ms:.3f} ms, bitwise")
        return rec

    def kernel_names(rows, needle):
        """Launches per step and device ms per step of the profile rows
        whose kernel name holds ``needle``."""
        hit = [(ms_, count) for ms_, key, count in rows if needle in key]
        return sum(c for _, c in hit) / 4, sum(m for m, _ in hit) / 4

    def censuses(step):
        """The census of each graph the step captured (one per rotation
        phase), read from the graphs themselves."""
        return [nodes for _, nodes, _ in step._ring.graphs.values()]

    log("phase 10: the compiled step, Target(jit=True, donate=True): one CUDA graph "
        "replay per epoch over every rank, bitwise against jit=False")
    graphed_kw = {"jit": True, "donate": True}
    phase10 = [main_cases[1], main_cases[3], wave_case] + fused_cases + [
        (name, op, {**kw, **mesh_kw}) for name, op, kw, mesh_kw in dist_cases[:5]]
    # each overlap case against the step without overlap of its boundary
    without_overlap = {dist_cases[2][0]: dist_cases[0][0], dist_cases[3][0]: dist_cases[1][0]}
    copies = {}
    jit_ms = {}  # the measured ms/step of each case under jit, for phase 11
    for name, op, kw in phase10:
        eager, graphed = compiled(op, **kw), compiled(op, **kw, **graphed_kw)
        state, out, launches, _ = drive(f"{name}, jit", op, {**kw, **graphed_kw})
        # the kernel nodes the counted run's replays ran (drive zeroes the
        # counts just before it)
        replayed = GraphCensus(dict(api.graph_stats().kernel_nodes))
        ranks = graphed.target.spatial_ranks if graphed.target.distributed else 1
        base = op.apply(state, timesteps=STEPS, target=Target(backend="cuda", jit=False, **kw))
        same(f"{name}, jit", out, base, "jit=False")
        del out, base
        torch.cuda.empty_cache()
        held = censuses(graphed)
        k1_per, k2_per = ranks * len(graphed.kernel_applies()), ranks * len(graphed.kernel_epochs())
        for nodes in held:
            check((nodes.k1, nodes.k2) == (k1_per, k2_per),
                  f"{name}: a graph holds {nodes.k1} K1 and {nodes.k2} K2 nodes, expected "
                  f"{k1_per} and {k2_per}")
        copies[name] = max(n.copies for n in held)
        others = {}
        for nodes in held:
            for key, n in nodes.others().items():
                others[key] = max(others.get(key, 0), n)
        log(f"  {name}, jit: each of its {len(held)} graphs holds {k1_per} K1 and {k2_per} K2 "
            f"kernel nodes, {copies[name]} copies (memcpy nodes and copy kernels), "
            f"{max(n.fills for n in held)} fills and {sum(others.values())} other kernel "
            f"nodes (census of the captured graphs)")
        for key, n in sorted(others.items()):
            log(f"    {n:3d} x {key[:100]}")
        frames = [a for a in graphed.kernel_applies() if a.attributes.get("part") is not None
                  and a.attributes["part"].value == "frame"]
        if frames:
            frame_launches = replayed.of(frames)
            epochs = graphed.epochs(STEPS)
            check(frame_launches == ranks * len(frames) * epochs,
                  f"{name}: the replays ran {frame_launches} frame launches, expected "
                  f"{ranks * len(frames) * epochs}")
            log(f"  {name}, jit: {replayed.k1 / STEPS:.0f} K1 launches per step, "
                f"{frame_launches / STEPS:.0f} of them frames ({len(frames)} per rank, into "
                "the combine's result; counted from the replayed graphs' nodes)")
            # no frame op evaluated by PyTorch, and the overlap step copies
            # what the step without overlap copies (pad and patches): no
            # combine copy
            check(not others, f"{name}: the graphs launch kernels besides K1, copies and "
                  f"fills: {sorted(others)}")
            k1_name = without_overlap[name]
            check(copies[name] <= copies[k1_name],
                  f"{name}: {copies[name]} copies per epoch, without overlap {copies[k1_name]}")
            kernels.append(frames_record(f"{name}, jit", graphed, frames, frame_launches))
        times = {graphed: [], eager: []}
        for step in [graphed, eager, eager, graphed, graphed, eager]:
            times[step].append(ms_per_step(step, state))
            torch.cuda.empty_cache()
        (g_lo, g_ms, g_hi), (e_lo, e_ms, e_hi) = sorted(times[graphed]), sorted(times[eager])
        jit_ms[name] = g_ms
        log(f"  {name}: {g_ms:.3f} [{g_lo:.3f}-{g_hi:.3f}] ms/step with jit=True, "
            f"{e_ms:.3f} [{e_lo:.3f}-{e_hi:.3f}] ms/step with jit=False (CUDA events, median "
            f"[min-max] of 3 runs of {STEPS} steps in turns)")
        rows, host_ms = where_time_goes(f"{name}, jit", graphed, state)
        # the host's time for the replay call alone (a graph of phase 0,
        # its results written over whatever its slots held)
        graph0 = graphed._ring.graphs[0][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            graph0.replay()
        replay_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        log(f"  {name}, jit: host {replay_ms:.4f} ms per CUDAGraph.replay() call, "
            f"{host_ms * graphed.target.exchange_every:.4f} ms per advance() call")
        k1_n, _ = kernel_names(rows, "k1_apply")
        copy_n, copy_ms = (a + b for a, b in zip(kernel_names(rows, "copy"),
                                                 kernel_names(rows, "Memcpy")))
        log(f"  {name}, jit: the profile shows {k1_n:.0f} K1 launches/step and "
            f"{copy_n:.0f} copy launches/step ({copy_ms:.3f} ms/step)")
        graphed.release_graphs()
        del state
        torch.cuda.empty_cache()

    # fig-10 through __call__: every field in, every field out, one replay
    for name, prog in adv_cases:
        for label, kw in (("one device", {}), ("2x2x1 ranks", on_2x2x1)):
            eager, graphed = compiled(prog, **kw), compiled(prog, **kw, **graphed_kw)
            ranks = 4 if kw else 1
            gen.manual_seed(SEED)
            args = [torch.randn(f.type.bounds.shape, device=dev, generator=gen)
                    for f in prog.field_args]
            graphed(*args)  # captures
            torch.cuda.synchronize()
            reset_dispatch_stats()
            api.reset_graph_stats()
            got = graphed(*args)
            torch.cuda.synchronize()
            n = dispatch_stats().apply_launches
            check(n == ranks * len(graphed.kernel_applies()) and api.graph_stats().replays == 1,
                  f"{name}, {label}, jit: {n} K1 launches in {api.graph_stats().replays} "
                  f"replays, expected {ranks * len(graphed.kernel_applies())} in one")
            same(f"{name}, {label}, jit", got, eager(*args), "jit=False")
            del got
            g_ms, e_ms = cuda_ms(lambda: graphed(*args), 3), cuda_ms(lambda: eager(*args), 3)
            log(f"  {name}, {label}: {g_ms:.3f} ms/call with jit=True, {e_ms:.3f} ms/call "
                "with jit=False (global tensors in and out)")
            graphed.release_graphs()
            del args
            torch.cuda.empty_cache()

    # -- phase 11: the cost model and the autotuner ---------------------------
    from repro_torch.tune import cache_stats, reset_cache_stats, tune

    t11 = time.perf_counter()
    log("phase 11: the cost model (CompiledStencil.cost(), launch/roofline.py) against the "
        "card, and the autotuner (repro_torch.tune) on it")
    # a message's latency: one exchange patch copy (a 2-row strip of 8192
    # columns of a padded 8192² shard, as phase 8's ranks send) as a node of a
    # captured graph, the time per node over many nodes
    padded = torch.randn(8196, 8196, device=dev, generator=gen)
    strip, patch = padded[2:4, 2:8194], torch.empty(2, 8192, device=dev)
    n_nodes = 256
    patch.copy_(strip)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_nodes):
            patch.copy_(strip)
    node_us = cuda_ms(graph.replay, 20) / n_nodes * 1e3
    check(torch.equal(patch, strip), "the patch copies")
    log(f"  exchange patch copy (2x8192 float32 strip) as a graph node: {node_us:.4f} us per node "
        f"over {n_nodes} nodes in one graph (launch/roofline.py LINK_LATENCY "
        f"{roofline.LINK_LATENCY * 1e6:.4f} us)")
    del graph, padded, strip, patch

    log("  cost() of each phase-10 case: modeled t_overlapped per step (per rank; times the "
        "ranks sharing this card, the least the card could take) against the measured "
        "jit=True ms/step")
    for name, op, kw in phase10:
        step = compiled(op, **kw, **graphed_kw)
        terms = step.cost()
        d = terms.as_dict()
        k = step.target.exchange_every
        ranks = step.target.spatial_ranks if step.target.distributed else 1
        model_ms = terms.t_overlapped / k * 1e3
        log(f"  {name}: flops {d['flops']:.6g}, bytes {d['bytes_accessed']:.6g}, collective "
            f"bytes {d['collective_bytes']:.6g}, t_memory {d['t_memory'] * 1e3:.4f} ms, "
            f"t_overlapped {d['t_overlapped'] * 1e3:.4f} ms per call of {k} steps, dominant "
            f"{d['dominant']}, recommended_exchange_every {d['recommended_exchange_every']}; "
            f"modeled {model_ms:.4f} ms/step per rank, {ranks * model_ms:.4f} for the {ranks} "
            f"rank(s) on this card, against {jit_ms[name]:.4f} measured "
            f"({100 * ranks * model_ms / jit_ms[name]:.1f} %)")
        check(ranks * model_ms <= 1.05 * jit_ms[name],
              f"{name}: the modeled {ranks * model_ms:.4f} ms/step of {ranks} rank(s) exceeds "
              f"1.05 x the measured {jit_ms[name]:.4f}: the count is wrong")
    log("  bound_ms of the kernels line so far (launch.roofline.apply_counts / epoch_counts):")
    for rec in kernels:
        log(f"    {rec['name']}: {rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    def winner_record(name, step, launches):
        """The kernel record of a tuned winner's kernel at its main-path
        shapes (K2 where it has epochs, at every rank's box)."""
        if not step.kernel_epochs():
            return kernel_record(name, [spec_of(a) for a in step.kernel_applies()], launches, step)
        (fused_op,) = step.kernel_epochs()
        err, ms, plain_ms, _, _ = epoch_check(name, fused_op, step.target.tile,
                                              corners=step._coords)
        b_ms, b_by = epoch_bound(fused_op)
        log(f"  K2 {name}: {ms:.4f} ms/launch, bound {b_ms:.4f} ms ({b_by}), plain "
            f"{plain_ms:.3f} ms, max|err| {err}")
        return {
            "name": f"epoch_kernel[{name}]", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        }

    prog = main_cases[1][1].program
    gen.manual_seed(SEED)
    state = (torch.randn(prog.input_fields[0].type.bounds.shape, device=dev, generator=gen),)
    want = api.compile(prog, Target(backend="cuda", jit=False)).time_loop(state, STEPS)
    searches = [  # (label, tune arguments)
        ("a (Target.tuned, the reference's options, one device)", {"devices": [dev]}),
        ("b (exchange_every=(4,), every candidate measured)",
         {"devices": [dev], "exchange_every": (4,), "keep_quantile": 1.0}),
        ("c (4 ranks on this card, exchange_every=(1, 4))",
         {"ranks": 4, "devices": [dev] * 4, "exchange_every": (1, 4)}),
    ]
    cache_dir = tempfile.mkdtemp(prefix="repro-torch-tune-")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = cache_dir
    try:
        for label, kw in searches:
            t0 = time.perf_counter()
            reset_cache_stats()
            res = tune(prog, measure=True, **kw)
            sec = time.perf_counter() - t0
            survivors = [c for c in res.candidates if not c.pruned]
            log(f"  search {label} on {main_cases[1][0]}: {len(res.candidates)} candidates, "
                f"{len(survivors)} measured, {sec:.1f} s, hardware {res.hardware}")
            for line in res.table().splitlines():
                log("    " + line)
            check(not res.from_cache and cache_stats().stores == 1, f"search {label}: not a fresh search")
            failed = [(c.describe(), c.note) for c in survivors if c.note]
            check(not failed, f"search {label}: survivors failed: {failed}")
            check(all(c.measured_s is not None for c in survivors)
                  and res.winner.measured_s == min(c.measured_s for c in survivors),
                  f"search {label}: the winner is not the measured argmin")
            # the same call again: a cache hit that measures nothing
            reset_dispatch_stats()
            api.reset_graph_stats()
            t0 = time.perf_counter()
            if label.startswith("a "):
                again = Target.tuned(prog, measure=True, **kw)
            else:
                again = tune(prog, measure=True, **kw).target
            hit_s = time.perf_counter() - t0
            stats = cache_stats().as_dict()
            check(again.fingerprint == res.target.fingerprint
                  and stats == {"hits": 1, "misses": 1, "stores": 1, "transfer_hits": 0}
                  and dispatch_stats().apply_calls == dispatch_stats().fused_epoch_calls == 0
                  and api.graph_stats().replays == 0,
                  f"search {label}: the second call was no cache hit that measures nothing "
                  f"({stats}, {dispatch_stats().as_dict()})")
            # the winner through its compiled step, bitwise against jit=False
            step = api.compile(prog, res.target)
            step.time_loop(state, STEPS)  # captures its graphs
            torch.cuda.synchronize()
            reset_dispatch_stats()
            api.reset_graph_stats()
            got = step.time_loop(state, STEPS)
            torch.cuda.synchronize()
            replayed = GraphCensus(dict(api.graph_stats().kernel_nodes))
            ranks = step.target.spatial_ranks if step.target.distributed else 1
            epochs = step.epochs(STEPS)
            per = (ranks * epochs * len(step.kernel_applies()),
                   ranks * epochs * len(step.kernel_epochs()))
            check(api.graph_stats().replays == epochs and (replayed.k1, replayed.k2) == per,
                  f"search {label}: the winner's graphs ran {replayed.k1} K1 and {replayed.k2} "
                  f"K2 launches in {api.graph_stats().replays} replays, expected {per} in {epochs}")
            same(f"search {label}: winner {res.winner.describe()}", got, want,
                 "Target(backend='cuda', jit=False) on one device")
            log(f"  search {label}: winner {res.winner.describe()} "
                f"{res.winner.measured_s * 1e3:.4f} ms/step measured (modeled "
                f"{res.winner.modeled_s * 1e3:.4f}); its 8 steps: {replayed.k1} K1 and "
                f"{replayed.k2} K2 launches in {epochs} replays (counted from its graphs' "
                f"nodes); the second call a cache hit in {hit_s:.3f} s")
            step.release_graphs()
            del got, step
            torch.cuda.empty_cache()
            if res.target.backend == "cuda":
                winner = api.compile(prog, res.target)
                kernels.append(winner_record(f"{main_cases[1][0]}, tuned {label[0]}: "
                                             f"{res.winner.describe()}", winner,
                                             replayed.k2 or replayed.k1))
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
    del state, want
    torch.cuda.empty_cache()
    sec11 = time.perf_counter() - t11
    log(f"phase 11: {sec11:.1f} s")
    check(sec11 < 240, f"phase 11 took {sec11:.1f} s, more than 240 s")

    # -- phase 12: checkpoint and resilience ---------------------------------
    kernels += resilience_phase(dev, main_cases[1][1].program, wave_case[1].program,
                                record=winner_record, card=card)

    # -- phase 13: the serving engine ----------------------------------------
    def pool_record(name, step, launches, slots):
        """The kernel record of a serving pool's kernel at its main-path
        shapes (``[slots, *shape]`` per rank; K2 where it has epochs, at
        every rank's box)."""
        if step.kernel_epochs():
            (fused_op,) = step.kernel_epochs()
            axis = step.target.slot_axis
            corners = list({tuple(sorted((a, c) for a, c in co.items() if a != axis)): co
                            for co in step._coords}.values())
            err, ms, _, plain_ms, b_ms, b_by, lib_ms = pooled_check(
                name, "K2", slots, fused_op=fused_op, tile=step.target.tile, corners=corners)
            return {
                "name": f"epoch_kernel[{name}]", "route": "cuda", "source": K2_SOURCE,
                "replaces": K2_REPLACES, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            }
        rows = [pooled_check(name, "K1", slots, spec=spec_of(a)) for a in step.kernel_applies()]
        libs = [r[6] for r in rows]
        return {
            "name": f"stencil_apply[{name}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches, "max_abs_err": max(r[0] for r in rows),
            "ms": sum(r[1] for r in rows), "plain_ms": sum(r[3] for r in rows),
            "bound_ms": sum(r[4] for r in rows),
            "bound_by": "bytes" if {r[5] for r in rows} == {"bytes"} else "operations",
            "library_ms": None if None in libs else sum(libs),
        }

    kernels += serving_phase(dev, record=pool_record, card=card, big=n2, small=n_pool)

    # -- phase 14: the language-model serving engine (no kernel of its own) ----
    lm_phase(dev, card=card)

    # -- phase 15: language-model training (no kernel of its own) -------------
    train_phase(dev, card=card)

    # -- phase 16: language models over a mesh (no kernel of its own) ---------
    lm_mesh_phase(dev, card=card)

    # -- phase 17: one process per card ----------------------------------------
    one_card = {  # phase 10's ms/step under jit on one card, for the speed-ups
        "heat k=1 zero": jit_ms[main_cases[1][0]], "heat k=1 overlap": jit_ms[main_cases[1][0]],
        "heat k=4 fused": jit_ms[fused_cases[0][0]], "wave k=4 fused": jit_ms[fused_cases[1][0]],
        "weak heat k=1": jit_ms[main_cases[1][0]], "weak heat k=4 fused": jit_ms[fused_cases[0][0]],
    }
    p17 = process_phase(dev, card=card, n2=n2, weak=n2, one_card_ms=one_card)
    # each kernel of phase 17's path at a rank's shapes, on this card: the
    # same local program as a rank of the process mesh (its launches are
    # the processes', counted from their graphs)
    grid = process_grid(torch.cuda.device_count())
    on_grid = {"mesh": Mesh([[dev] * grid[1]] * grid[0], ("x", "y")),
               "strategy": make_strategy_2d(grid)}
    corners = [{"x": x, "y": y} for x in range(grid[0]) for y in range(grid[1])]
    for name, case in p17.items():
        prog = process_program(case["kind"], case["boundary"], case["shape"])
        step = compiled(prog, **on_grid, **case["kw"])
        label = f"phase 17 {name} {case['shape'][0]}x{case['shape'][1]}, one process per card"
        if not step.kernel_epochs():
            kernels.append(kernel_record(label, [spec_of(a) for a in step.kernel_applies()],
                                         case["k1"], step))
            continue
        (fused_op,) = step.kernel_epochs()
        err, ms, plain_ms, _, _ = epoch_check(label, fused_op, None, corners=corners)
        b_ms, b_by = epoch_bound(fused_op)
        kernels.append({
            "name": f"epoch_kernel[{label}]", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": case["k2"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        log(f"  K2 {label}: bitwise at each rank's box, {ms:.4f} ms/launch, bound {b_ms:.4f} "
            f"ms ({b_by}), plain {plain_ms:.3f} ms")

    # -- phase 18: tensor and data parallelism (no kernel of its own) ----------
    tp_phase(dev, card=card)

    # -- phase 19: slot axis, context parallelism and microbatches over processes
    p19 = p19_phase(dev, card=card, n2=n2)
    # each kernel of (a)'s buckets at a rank's pooled shapes on this card (a
    # world of one: the rank is the whole grid); the launches are the
    # process's, counted from its replayed graphs
    for label, prog in p19_programs(n2).items():
        kernel = "K2" if label == "H" else "K1"
        launches = p19.get("a", {}).get(kernel, 0)
        check(launches > 0, f"phase 19 (a): bucket {label} launched {kernel} {launches} times")
        step = api.compile(prog, Target(device=str(dev), jit=False, **p19_kw(label)))
        kernels.append(pool_record(f"phase 19 {label} {n2}x{n2}, slot axis over a process",
                                   step, launches, 4))

    # -- phase 20: deep 3-D fused epochs, K2's streaming and scratch plans ---
    kernels += deep_phase(dev, card=card, n3=n3)

    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


if __name__ == "__main__":
    sys.exit(main())
