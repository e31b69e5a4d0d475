"""The port's observability layer (``repro_torch.obs``: trace export and
roofline drift, copies of the reference's) and the epoch spans that
measure a run, on the CPU.

The port of ``tests/test_obs.py``'s export and drift cases (synthetic
spans, no device), of its traced two-rank exchange-window case (the
``obs-trace-2rank`` scenario of ``tests/dist_worker.py``, here on two
virtual CPU ranks in process), a check that a traced port run and a
traced reference run of one program name the same spans (DESIGN.md §12),
and phase 12 of ``chip_smoke.py`` run at 32² on the CPU with the card
stubbed: the compiled step's ring forced on and each CUDA graph replaced
by a stand-in that runs its phase op by op and counts the kernel calls
its capture made as its K1 and K2 nodes.
"""
import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_programs as P
from repro_torch import api, obs
from repro_torch.api import Target
from repro_torch.core.dialects import comm
from repro_torch.core.passes.decompose import make_strategy_1d
from repro_torch.dist import Mesh
from repro_torch.kernels import _DISPATCH
from repro_torch.kernels.graphs import K1_KERNEL, K2_KERNEL, TAG_HEX, GraphCensus
from repro_torch.obs.trace import LANE_COMM, Span

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_tracer():
    """Every test starts and ends with the singleton disabled + empty."""
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------


def _synthetic_spans():
    """Two ranks, one SPMD span, one comm window overlapping an apply."""
    return [
        Span("epoch", "dispatch", ts=1.0, dur=1.0, rank=None,
             args={"ranks": 2, "k": 4}),
        Span("comm.exchange", "comm", ts=1.1, dur=0.5, rank=None,
             tid=LANE_COMM, args={"ranks": 2}),
        Span("apply:interior", "compute", ts=1.2, dur=0.3, rank=None,
             args={"ranks": 2}),
        Span("engine.step", "serve", ts=2.0, dur=0.1, rank=0),
    ]


def test_chrome_export_schema(tmp_path):
    path = obs.write_chrome(str(tmp_path / "t.json"), _synthetic_spans())
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    xs = [e for e in events if e["ph"] == "X"]
    # two ranks discovered from args.ranks -> two process-name records
    assert {e["args"]["name"] for e in meta if e["name"] == "process_name"} \
        == {"rank 0", "rank 1"}
    # SPMD spans replicate onto both pids; rank-0 span stays on pid 0
    epochs = [e for e in xs if e["name"] == "epoch"]
    assert sorted(e["pid"] for e in epochs) == [0, 1]
    assert all(e["args"]["spmd"] for e in epochs)
    steps = [e for e in xs if e["name"] == "engine.step"]
    assert [e["pid"] for e in steps] == [0]
    # microseconds, comm lane separated
    ep = epochs[0]
    assert ep["ts"] == pytest.approx(1.0 * 1e6) and \
        ep["dur"] == pytest.approx(1.0 * 1e6)
    assert {e["tid"] for e in xs if e["cat"] == "comm"} == {LANE_COMM}


def test_rank_traces_merge_and_reload(tmp_path):
    spans = _synthetic_spans()
    paths = obs.write_rank_traces(str(tmp_path), spans)
    assert len(paths) == 2
    merged_path = str(tmp_path / "merged.json")
    merged = obs.merge_traces(str(tmp_path), out=merged_path)
    xs = [e for e in merged["traceEvents"] if e["ph"] == "X"]
    # 3 SPMD spans x 2 ranks + 1 rank-0 span
    assert len(xs) == 7
    meta = [e for e in merged["traceEvents"] if e["ph"] == "M"]
    names = [(e["name"], e["pid"], e["tid"]) for e in meta]
    assert len(names) == len(set(names)), "merge must dedupe metadata"
    # a merged chrome file loads back into Span objects (rank = pid)
    loaded = obs.load_spans(merged_path)
    assert len(loaded) == 7
    assert {s.rank for s in loaded} == {0, 1}


def test_jsonl_roundtrip(tmp_path):
    spans = _synthetic_spans()
    path = obs.write_jsonl(str(tmp_path / "t.jsonl"), spans)
    loaded = obs.load_spans(path)
    assert loaded == spans


def test_export_is_the_references(tmp_path):
    """Same spans, same Chrome document as the reference's exporter."""
    from repro.obs import export as ref_export
    from repro.obs.trace import Span as RefSpan

    spans = _synthetic_spans()
    ref_spans = [RefSpan(**s.as_dict()) for s in spans]
    assert obs.to_chrome(spans) == ref_export.to_chrome(ref_spans)


# --------------------------------------------------------------------------
# drift
# --------------------------------------------------------------------------


class _FixedTerms:
    """RooflineTerms stand-in with a known modeled step time."""

    def __init__(self, step_s):
        self._s = step_s

    def step_time(self, k):
        return self._s


def _drift_spans(epoch_dur=0.8, k=4):
    spans = []
    for e in range(2):
        t0 = float(e)
        spans.append(Span("epoch", "dispatch", ts=t0, dur=epoch_dur,
                          args={"k": k, "epoch": e}))
        # exchange window 0.2 wide; interior apply covers half of it
        spans.append(Span("comm.exchange", "comm", ts=t0 + 0.1, dur=0.2,
                          tid=LANE_COMM))
        spans.append(Span("apply:interior", "compute", ts=t0 + 0.2, dur=0.3))
    return spans


def test_drift_report_synthetic():
    rep = obs.drift_report(spans=_drift_spans(), terms=_FixedTerms(0.1))
    assert rep.epochs == 2
    assert rep.exchange_every == 4  # inferred from the epoch span's k tag
    assert rep.measured_step_s == pytest.approx(0.8 / 4)
    assert rep.modeled_step_s == pytest.approx(0.1)
    assert rep.drift_ratio == pytest.approx(2.0)
    assert rep.error_pct == pytest.approx(100.0)
    # window [0.1, 0.3], apply covers [0.2, 0.3] -> half hidden
    assert rep.overlap_windows == 2
    assert rep.achieved_overlap == pytest.approx(0.5)
    assert rep.per_phase_s["comm"] == pytest.approx(0.4)
    text = str(rep)
    assert "drift ratio" in text and "achieved overlap" in text
    d = rep.as_dict()
    assert d["drift_ratio"] == pytest.approx(2.0)


def test_drift_report_without_model_or_epochs():
    rep = obs.drift_report(spans=[])
    assert rep.epochs == 0 and rep.measured_step_s is None
    assert rep.drift_ratio is None and rep.achieved_overlap is None
    rep = obs.drift_report(spans=_drift_spans())  # measured-only
    assert rep.modeled_step_s is None and rep.drift_ratio is None
    assert rep.achieved_overlap == pytest.approx(0.5)


def test_drift_report_reads_the_cost_model_of_a_traced_run():
    """``drift_report(terms=compiled.cost())``: the port's
    ``RooflineTerms.step_time`` against the traced epochs of a run."""
    prog = P.heat("repro_torch", (32, 32), 4)
    step = api.compile(prog, Target(device="cpu", exchange_every=2))
    obs.enable()
    step.time_loop(tuple(torch.from_numpy(a) for a in P.rand_state(prog, 1)), 6)
    rep = obs.drift_report(terms=step.cost())
    assert rep.epochs == 3 and rep.exchange_every == 2
    assert rep.modeled_step_s == pytest.approx(step.cost().step_time(2))
    assert rep.drift_ratio == pytest.approx(rep.measured_step_s / rep.modeled_step_s)


# --------------------------------------------------------------------------
# epoch spans
# --------------------------------------------------------------------------


def _mesh1d(n):
    return Mesh(np.array([CPU] * n, dtype=object), ("x",))


def test_traced_two_rank_exchange_windows(tmp_path):
    """``obs-trace-2rank``: a traced 2-rank ``exchange_every=4`` overlap
    run is bitwise the untraced one and shows, on each rank's track, ONE
    exchange span pair per epoch inside its epoch span, each window
    overlapping an interior apply of that rank."""
    k, steps = 4, 8  # two epochs
    prog = P.jacobi("repro_torch", (64, 32), "periodic")
    (u0,) = (torch.from_numpy(a) for a in P.rand_state(prog, 7))
    step = api.compile(prog, Target(device="cpu", mesh=_mesh1d(2), strategy=make_strategy_1d(2),
                                    exchange_every=k, overlap=True))
    want = step.time_loop((u0,), steps)
    n_starts = sum(1 for op in step.local_ir.body.ops if isinstance(op, comm.ExchangeStartOp))
    assert n_starts == 2, f"expected one exchange pair per epoch, IR has {n_starts} starts"

    obs.enable()
    got = step.time_loop((u0,), steps)
    obs.disable()
    assert torch.equal(got[0], want[0])

    spans = obs.spans()
    epochs = sorted((s for s in spans if s.name == "epoch"), key=lambda s: s.ts)
    assert len(epochs) == steps // k
    assert [(e.args["epoch"], e.args["step_begin"], e.args["k"], e.args["ranks"]) for e in epochs] \
        == [(0, 0, k, 2), (1, k, k, 2)]
    for r in (0, 1):
        comm_spans = [s for s in spans if s.cat == "comm" and s.rank == r]
        assert len(comm_spans) == len(epochs) * n_starts
        interior = [s for s in spans if s.name == "apply:interior" and s.rank == r]
        assert interior, "overlap target produced no interior apply spans"
        for e in epochs:
            inside = [c for c in comm_spans if e.ts <= c.ts and c.end <= e.end]
            assert len(inside) == n_starts, f"rank {r}, epoch {e.args['epoch']}"
            c = inside[0]
            assert any(a.ts < c.end and c.ts < a.end for a in interior)

    rep = obs.drift_report(exchange_every=k)
    assert rep.epochs == len(epochs) and rep.achieved_overlap > 0.0, rep.as_dict()

    paths = obs.write_rank_traces(str(tmp_path), spans)
    assert len(paths) == 2
    merged = obs.merge_traces(str(tmp_path), out=str(tmp_path / "merged" / "merged.json"))
    events = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    for r in (0, 1):
        track_comm = [e for e in events if e["pid"] == r and e["cat"] == "comm"]
        assert len(track_comm) == len(epochs) * n_starts
        track_interior = [e for e in events if e["pid"] == r and e["name"] == "apply:interior"]
        for c in track_comm:
            c0, c1 = c["ts"], c["ts"] + c["dur"]
            assert any(a["ts"] < c1 and c0 < a["ts"] + a["dur"] for a in track_interior)


def test_advance_opens_one_epoch_span():
    prog = P.heat("repro_torch", (16, 16), 2)
    step = api.compile(prog, Target(device="cpu", exchange_every=2))
    state = tuple(torch.from_numpy(a) for a in P.rand_state(prog, 3))
    want = step.advance(state)
    obs.enable()
    got = step.advance(state)
    obs.disable()
    assert torch.equal(got[0], want[0])
    (epoch,) = [s for s in obs.spans() if s.name == "epoch"]
    assert epoch.cat == "dispatch" and epoch.rank is None
    assert epoch.args == {"program": prog.name, "k": 2, "ranks": 1}


def test_port_and_reference_traces_name_the_same_spans(tmp_path):
    """A compile, a traced ``time_loop``, and a resilient run killed and
    resumed, traced in each package: the same set of span names."""
    import importlib

    names = {}
    for pkg in ("repro", "repro_torch"):
        papi = importlib.import_module(f"{pkg}.api")
        pobs = importlib.import_module(f"{pkg}.obs")
        res = importlib.import_module(f"{pkg}.resilience")
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        prog = P.jacobi(pkg, (16, 16), "periodic")
        state = P.rand_state(prog, 5)
        if pkg == "repro_torch":
            state = [torch.from_numpy(a) for a in state]
        papi.clear_cache()
        pobs.disable()
        pobs.clear()
        pobs.enable()
        try:
            target = papi.Target(exchange_every=2, **kw)
            papi.compile(prog, target).time_loop(tuple(state), 4)
            d = str(tmp_path / pkg)
            with pytest.raises(res.SimulatedFault):
                res.ResilientLoop(prog, target, tuple(state), 8, directory=d,
                                  fault_plan=res.FaultPlan(kill_at_epoch=2)).run()
            res.resume(prog, d, target).run()
            names[pkg] = {s.name for s in pobs.spans()}
        finally:
            pobs.disable()
            pobs.clear()
            papi.clear_cache()
    assert {"api.compile", "api.build", "epoch", "checkpoint.save", "checkpoint.restore",
            "apply:full"} <= names["repro_torch"]
    assert names["repro"] == names["repro_torch"]


# --------------------------------------------------------------------------
# chip_smoke.py phase 12 with the card stubbed
# --------------------------------------------------------------------------


class _StandInGraph:
    """A captured phase's stand-in: a replay runs the phase op by op, its
    kernel calls left uncounted (``_Ring.replay`` adds the graph's
    nodes)."""

    def __init__(self, ring, p):
        self.ring, self.p = ring, p

    def replay(self):
        saved = _DISPATCH.as_dict()
        self.ring._run(self.p)
        for k, v in saved.items():
            setattr(_DISPATCH, k, v)


def _stand_in_graph(ring, p):
    """``_Ring._graph`` without a card: the eager run, then a 'capture'
    whose K1 and K2 calls become the graph's kernel nodes."""
    if p in ring.graphs:
        return ring.graphs[p]
    ring._run(p)
    before = _DISPATCH.as_dict()
    ring._run(p)
    made = {k: v - before[k] for k, v in _DISPATCH.as_dict().items()}
    for k, v in before.items():
        setattr(_DISPATCH, k, v)
    tag = "0" * TAG_HEX
    nodes = GraphCensus({f"{K1_KERNEL}_{tag}": made["apply_calls"],
                         f"{K2_KERNEL}_{tag}": made["fused_epoch_calls"]})
    api._GRAPHS.captures += 1
    calls = {k: v for k, v in made.items() if k.endswith("_calls")}
    ring.graphs[p] = (_StandInGraph(ring, p), nodes, calls)
    return ring.graphs[p]


def test_chip_smoke_phase_12_with_the_card_stubbed(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    real_init = api._Ring.__init__

    def init(ring, stencil, *args):
        real_init(ring, stencil, *args)
        ring.capture = True

    monkeypatch.setattr(api.CompiledStencil, "_graphed",
                        lambda self: self.target.jit and not obs.enabled())
    monkeypatch.setattr(api._Ring, "__init__", init)
    monkeypatch.setattr(api._Ring, "_graph", _stand_in_graph)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    made = []

    def record(name, step, launches):
        made.append((name, len(step.kernel_epochs()), launches))
        return {"name": name, "launches": launches}

    heat, wave = P.heat("repro_torch", (32, 32), 4), P.wave("repro_torch", (32, 32), 4)
    try:
        records = chip_smoke.resilience_phase(CPU, heat, wave, record=record, card="the CPU")
    finally:
        api.clear_cache()
    out = capsys.readouterr().out
    assert "phase 12:" in out and "time to recover" in out and "roofline drift" in out
    # launches in the counted runs: K2 on A (heat: runs 1, 1b, the killed
    # legs of 2 and 5, the resumed legs of 3 and 5), K2 on B (4 ranks), K1
    # on C (4 ranks, 8 epochs); wave on A and B (k=4), on C and D (k=1)
    assert [(n.split(" resilient on ")[1], k2, n_) for n, k2, n_ in made] == [
        ("A", 1, 4 + 4 + 2 + 2 + 2 + 3), ("B", 1, 4 * 2), ("C", 0, 4 * 8),
        ("A", 1, 4 + 1), ("B", 1, 4 * 3), ("C", 0, 4 * 5), ("D", 0, 11),
    ]
    assert [r["launches"] for r in records] == [m[2] for m in made]


def test_chip_smoke_phase_13_with_the_card_stubbed(monkeypatch, capsys):
    """``chip_smoke.serving_phase`` at 32² and 16² on the CPU, with the
    compiled step's ring forced on and each CUDA graph replaced by the
    stand-in: every case's checks pass, and the kernels line gets one
    entry per pool with the launches its graphs' nodes made."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    real_init = api._Ring.__init__

    def init(ring, stencil, *args):
        real_init(ring, stencil, *args)
        ring.capture = True

    monkeypatch.setattr(api.CompiledStencil, "_graphed",
                        lambda self: self.target.jit and not obs.enabled())
    monkeypatch.setattr(api._Ring, "__init__", init)
    monkeypatch.setattr(api._Ring, "_graph", _stand_in_graph)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    made = []

    def record(name, step, launches, slots):
        made.append((name, len(step.kernel_epochs()), launches, slots))
        return {"name": name, "launches": launches}

    try:
        records = chip_smoke.serving_phase(CPU, record=record, card="the CPU", big=32, small=16)
    finally:
        api.clear_cache()
    out = capsys.readouterr().out
    assert "phase 13:" in out and "case 4:" in out and "GPts/s" in out
    # one K2 node a dispatch of H (6 requests of 4-12 epochs in a pool of
    # 4: 16 dispatches) and W (3 requests of 4 epochs in a pool of 2: 8),
    # one K1 node a dispatch of K (16 steps) and of the small tenants, four
    # K2 nodes (one a rank) a dispatch of the 2x2 bucket (8 dispatches)
    assert [(k2, slots) for _, k2, _, slots in made] == [(1, 4), (1, 2), (0, 4), (0, 16), (1, 2)]
    assert [m[2] for m in made[:3]] + [made[4][2]] == [16, 8, 16, 4 * 8]
    assert 64 <= made[3][2] <= 32 * 64 // 2  # at least 64 steps, at most 2 slots a dispatch
    assert [r["launches"] for r in records] == [m[2] for m in made]


# --------------------------------------------------------------------------
# unified registry and the summary CLI
# --------------------------------------------------------------------------


def test_snapshot_unifies_five_counter_islands():
    snap = obs.snapshot()
    for ns in ("compile", "kernel", "serve", "checkpoint", "tune"):
        assert ns in snap, f"missing namespace {ns}"
        assert isinstance(snap[ns], dict) and snap[ns], snap[ns]
    assert {"hits", "misses", "pipeline_runs", "cache_capacity"} <= set(snap["compile"])
    assert {"apply_calls", "apply_launches", "fused_epoch_calls",
            "fused_epoch_launches"} <= set(snap["kernel"])
    assert "engines" in snap["serve"]
    assert {"saves", "restores"} <= set(snap["checkpoint"])
    assert "hits" in snap["tune"]
    assert snap["trace"]["enabled"] is False
    flat = obs.snapshot(flat=True)
    assert "compile.hits" in flat and "checkpoint.saves" in flat
    assert tuple(obs.NAMESPACES) == ("compile", "kernel", "serve", "checkpoint", "tune")


def test_snapshot_sees_live_traffic():
    from repro_torch.frontends.oec_like import ProgramBuilder

    p = ProgramBuilder("obs_snap", (8, 8))
    u = p.input("u")
    out = p.output("out")
    r = p.apply([p.load(u)], lambda b, u: u.at(0, 0) * 2.0)
    p.store(r, out)
    prog = p.finish(boundary="zero")
    before = obs.snapshot()
    step = api.compile(prog, Target(device="cpu", backend="cuda"))
    step(torch.zeros(8, 8), torch.zeros(8, 8))
    after = obs.snapshot()
    assert after["compile"]["pipeline_runs"] > before["compile"]["pipeline_runs"]
    total = after["compile"]["hits"] + after["compile"]["misses"]
    assert total > before["compile"]["hits"] + before["compile"]["misses"]
    assert after["kernel"]["apply_calls"] == before["kernel"]["apply_calls"] + 1


def test_snapshot_shows_the_engine_and_its_migration(tmp_path):
    """A live engine's serve counters (summed over live engines) and the
    checkpoint counters of its evacuation show in the snapshot."""
    from repro_torch.serve.stencil import StencilEngine

    prog = P.jacobi("repro_torch", (16, 16))
    before = obs.snapshot()
    eng = StencilEngine()
    for i in range(2):
        eng.submit(prog, (np.zeros((16, 16), np.float32),), 4, target=Target(device="cpu"))
    eng.step()
    eng.evacuate(prog.fingerprint, str(tmp_path / "evac"))
    after = obs.snapshot()
    assert after["serve"]["engines"] >= before["serve"]["engines"] + 1
    assert after["serve"]["requests_submitted"] >= before["serve"]["requests_submitted"] + 2
    assert after["serve"]["requests_evacuated"] >= before["serve"]["requests_evacuated"] + 2
    assert after["serve"]["batched_dispatches"] >= before["serve"]["batched_dispatches"] + 1
    assert after["checkpoint"]["saves"] == before["checkpoint"]["saves"] + 2


def test_obs_cli_summarizes_a_trace(tmp_path):
    import subprocess

    spans = [
        Span("epoch", "dispatch", ts=float(e), dur=0.8, args={"k": 4, "epoch": e})
        for e in range(2)
    ]
    path = obs.write_chrome(str(tmp_path / "t.json"), spans)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", path, "--modeled-step", "0.1"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert "epoch" in proc.stdout and "drift" in proc.stdout
    snap = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--snapshot"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert snap.returncode == 0, snap.stderr
    assert set(json.loads(snap.stdout)) >= set(obs.NAMESPACES)
