"""The port's observability (``repro_torch/obs``) against the JAX package's
(``repro/obs``): every unit case of ``tests/test_obs.py`` runs on both
packages; the artifacts of either read in the other; the bucket-schedule
gauges of ResNet-50 equal the reference's; and the port's trainer keeps
the telemetry contract on the CPU (per-step phases within 10% of the step's
wall time, a nested Chrome trace, history rows mirrored to the sink)."""

import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.obs.metrics as jmetrics
import repro.obs.sink as jsink
import repro_torch.obs as tobs
import repro_torch.obs.metrics as tmetrics
import repro_torch.obs.sink as tsink
from repro.core import grad_sync as jgs
from repro.models import resnet as jresnet
from repro_torch.core import grad_sync as tgs
from repro_torch.models import resnet as tresnet


def _pkg(obs, metrics, sink, gs, tree):
    return types.SimpleNamespace(
        ObsConfig=obs.ObsConfig, Telemetry=obs.Telemetry, fingerprint=obs.fingerprint,
        Tracer=obs.Tracer, MetricsRegistry=metrics.MetricsRegistry,
        NULL_REGISTRY=metrics.NULL_REGISTRY,
        DEFAULT_TIME_EDGES_S=metrics.DEFAULT_TIME_EDGES_S, JsonlSink=sink.JsonlSink,
        read_jsonl=sink.read_jsonl, read_run=sink.read_run, run_paths=sink.run_paths,
        record_bucket_metrics=gs.record_bucket_metrics, GradSyncConfig=gs.GradSyncConfig,
        fp32=jnp.float32 if gs is jgs else torch.float32, tree=tree)


def _jax_tree(n=4, width=64):
    return {f"layer{i:02d}": {"kernel": np.zeros((width, width), np.float32)}
            for i in range(n)}


def _torch_tree(n=4, width=64):
    return {f"layer{i:02d}.kernel": torch.zeros(width, width) for i in range(n)}


PACKAGES = {"jax": _pkg(jobs, jmetrics, jsink, jgs, _jax_tree),
            "torch": _pkg(tobs, tmetrics, tsink, tgs, _torch_tree)}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# ------------------------------------------------------------- metrics --

def test_counter_monotonic_and_rejects_negative(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("train/steps")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("train/steps") is c


def test_gauge_last_write_wins(pkg):
    reg = pkg.MetricsRegistry()
    g = reg.gauge("queue_depth")
    g.set(3)
    g.set(1)
    assert g.value == 1.0
    assert reg.snapshot()["queue_depth"] == {"type": "gauge", "value": 1.0}


def test_histogram_upper_bound_edge_semantics(pkg):
    h = pkg.MetricsRegistry().histogram("lat", edges=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 100.0):
        h.observe(v)
    snap = h.snapshot()
    assert [b["count"] for b in snap["buckets"]] == [2, 0, 1, 1]
    assert snap["buckets"][-1]["le"] == "inf"
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(104.5)
    assert snap["min"] == 0.5 and snap["max"] == 100.0
    assert snap["mean"] == pytest.approx(104.5 / 4)


def test_histogram_edges_are_sorted_and_required(pkg):
    reg = pkg.MetricsRegistry()
    assert reg.histogram("x", edges=(4.0, 1.0, 2.0)).edges == (1.0, 2.0, 4.0)
    with pytest.raises(ValueError):
        reg.histogram("empty", edges=())
    assert pkg.DEFAULT_TIME_EDGES_S == jmetrics.DEFAULT_TIME_EDGES_S
    assert len(pkg.DEFAULT_TIME_EDGES_S) == 22


def test_registry_type_mismatch_raises(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("a")
    with pytest.raises(TypeError):
        reg.gauge("a")


def test_registry_names_prefix_filter(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("grad_sync/bucket00/nbytes")
    reg.counter("grad_sync/bucket01/nbytes")
    reg.counter("elastic/recoveries")
    assert reg.names("grad_sync/") == ["grad_sync/bucket00/nbytes",
                                       "grad_sync/bucket01/nbytes"]
    assert len(reg.names()) == 3


def test_registry_remove_prefix(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("a/x").inc()
    reg.gauge("a/y").set(2)
    reg.gauge("ab").set(3)
    reg.gauge("b/z").set(4)
    assert reg.remove_prefix("a/") == 2
    assert reg.names() == ["ab", "b/z"]
    assert reg.remove_prefix("nope/") == 0
    with pytest.raises(ValueError):
        reg.remove_prefix("")


def test_metrics_thread_safety(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("h", edges=(0.5,))

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 8000 and h.count == 8000
    assert h.snapshot()["buckets"][-1]["count"] == 8000


def test_null_registry_accepts_everything_records_nothing(pkg):
    pkg.NULL_REGISTRY.counter("x").inc(5)
    pkg.NULL_REGISTRY.gauge("y").set(3)
    pkg.NULL_REGISTRY.histogram("z").observe(1.0)
    assert pkg.NULL_REGISTRY.snapshot() == {}
    assert pkg.NULL_REGISTRY.names() == []


# ---------------------------------------------------------------- sink --

def test_sink_stamping_and_header(pkg, tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pkg.JsonlSink(path, run_id="abc123", meta={"source": "test"}) as s:
        s.emit({"kind": "metric", "v": 1})
        s.emit({"kind": "event", "event": "x"})
    rows = pkg.read_jsonl(path)
    assert rows[0]["kind"] == "run_header" and rows[0]["meta"] == {"source": "test"}
    assert [r["seq"] for r in rows] == [0, 1, 2]
    assert all(r["run_id"] == "abc123" for r in rows)
    ts = [r["t_s"] for r in rows]
    assert ts == sorted(ts) and ts[0] >= 0.0


def test_sink_payload_cannot_override_stamps(pkg, tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pkg.JsonlSink(path, run_id="realrun") as s:
        s.emit({"kind": "summary", "run_id": "realrun", "seq": 999})
    row = pkg.read_jsonl(path)[1]
    assert row["run_id"] == "realrun" and row["seq"] == 1


def test_sink_emit_after_close_raises(pkg, tmp_path):
    s = pkg.JsonlSink(str(tmp_path / "m.jsonl"))
    s.close()
    s.close()
    with pytest.raises(ValueError):
        s.emit({"kind": "metric"})


def test_sink_rotation_chain_ordering(pkg, tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pkg.JsonlSink(path, rotate_bytes=300, meta={}) as s:
        for i in range(40):
            s.emit({"kind": "metric", "i": i})
    chain = pkg.run_paths(path)
    assert len(chain) > 2 and chain[-1] == path and chain[0] == path + ".1"
    rows = pkg.read_run(path)
    assert [r["seq"] for r in rows] == list(range(41))
    assert [r["i"] for r in rows[1:]] == list(range(40))


def test_torn_tail_dropped_mid_file_corruption_handled(pkg, tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pkg.JsonlSink(path) as s:
        for i in range(5):
            s.emit({"kind": "metric", "i": i})
    with open(path, "ab") as f:
        f.write(b'{"kind": "metr')
    rows = pkg.read_jsonl(path)
    assert len(rows) == 6 and rows[-1]["i"] == 4
    assert len(pkg.read_jsonl(path, strict=True)) == 6
    with open(path, "ab") as f:
        f.write(b'\n{"kind": "metric", "i": 99}\n')
    assert pkg.read_jsonl(path)[-1]["i"] == 99
    with pytest.raises(json.JSONDecodeError):
        pkg.read_jsonl(path, strict=True)


def test_sink_crash_consistency_any_truncation_point(pkg, tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pkg.JsonlSink(path) as s:
        for i in range(10):
            s.emit({"kind": "metric", "i": i, "pad": "x" * 7})
    blob = open(path, "rb").read()
    crash = str(tmp_path / "crash.jsonl")
    rng = np.random.RandomState(0)
    for cut in set(rng.randint(0, len(blob), size=50)) | {0, len(blob)}:
        with open(crash, "wb") as f:
            f.write(blob[:cut])
        rows = pkg.read_jsonl(crash)
        assert [r["seq"] for r in rows] == list(range(len(rows)))


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_either_package_reads_the_other_s_artifacts(writer, reader, tmp_path):
    """One schema: a run's metrics JSONL (rotated) and Chrome trace from
    either package read the same in the other."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    path = str(tmp_path / "m.jsonl")
    tel = w.Telemetry(w.ObsConfig(metrics_path=path, rotate_bytes=400,
                                  trace_path=str(tmp_path / "t.json")),
                      run_id="feedbeef0000", meta={"source": writer})
    for i in range(6):
        with tel.span("step", step=i):
            tel.emit({"kind": "metric", "step": i, "loss": 1.0 / (i + 1)})
    tel.event("checkpoint", step=4, path="step_00000004.npz")
    tel.close()
    assert r.read_run(path) == w.read_run(path)
    rows = r.read_run(path)
    assert len(r.run_paths(path)) > 1
    assert [x["kind"] for x in rows][:2] == ["run_header", "metric"]
    assert rows[-1]["kind"] == "summary" and rows[-1]["run_id"] == "feedbeef0000"
    assert rows[-1]["metrics"]["events/checkpoint"] == {"type": "counter", "value": 1.0}
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    assert [e["args"]["step"] for e in events] == list(range(6))


# ------------------------------------------------------------- tracing --

def test_span_nesting_depth_and_parent(pkg):
    tr = pkg.Tracer()
    with tr.span("step", step=3) as outer:
        with tr.span("sync/bucket3", step=3) as inner:
            time.sleep(0.002)
        assert inner.duration >= 0.002
    assert outer.depth == 0 and outer.parent is None
    assert inner.depth == 1 and inner.parent == "step"
    assert outer.t0 <= inner.t0 and inner.t1 <= outer.t1 + 1e-6
    assert outer.duration >= inner.duration
    assert tr.spans("sync/bucket3", step=3) == [inner]
    assert set(tr.phase_breakdown(3)) == {"step", "sync/bucket3"}


def test_span_exception_safety(pkg):
    tr = pkg.Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    sp = tr.spans("boom")[0]
    assert sp.error and sp.duration is not None
    with tr.span("after") as nxt:
        pass
    assert nxt.depth == 0


def test_disabled_tracer_yields_null_span(pkg):
    tr = pkg.Tracer(enabled=False)
    with tr.span("x") as sp:
        pass
    assert sp.duration == 0.0 and tr.spans() == []


def test_chrome_trace_export_loadable_and_nested(pkg, tmp_path):
    tr = pkg.Tracer()
    with tr.span("step", step=0):
        with tr.span("data", step=0):
            time.sleep(0.001)
        with tr.span("dispatch", step=0):
            time.sleep(0.001)
    path = str(tmp_path / "trace.json")
    n = tr.export_chrome_trace(path)
    events = json.load(open(path))["traceEvents"]
    assert n == len(events) == 3 and all(e["ph"] == "X" for e in events)
    by_name = {e["name"]: e for e in events}
    step = by_name["step"]
    for child in ("data", "dispatch"):
        e = by_name[child]
        assert e["ts"] >= step["ts"]
        assert e["ts"] + e["dur"] <= step["ts"] + step["dur"] + 1.0
        assert e["args"]["step"] == 0


def test_torch_profile_writes_a_trace_of_the_window(tmp_path):
    with tobs.torch_profile(None) as prof:
        assert prof is None
    with tobs.torch_profile(str(tmp_path / "prof"), "cpu", rank=3):
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.load(open(tmp_path / "prof" / "torch_trace_rank3.json"))
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


# -------------------------------------------------- fingerprint/telemetry --

def test_fingerprint_deterministic_and_key_order_free(pkg):
    a = pkg.fingerprint({"x": 1, "y": [1, 2], "z": "s"})
    assert a == pkg.fingerprint({"z": "s", "y": [1, 2], "x": 1}) and len(a) == 12
    assert pkg.fingerprint({"x": 2, "y": [1, 2], "z": "s"}) != a
    assert a == jobs.fingerprint({"x": 1, "y": [1, 2], "z": "s"})


def test_telemetry_events_summary_and_idempotent_close(pkg, tmp_path):
    path = str(tmp_path / "m.jsonl")
    tel = pkg.Telemetry(pkg.ObsConfig(metrics_path=path,
                                      trace_path=str(tmp_path / "t.json")),
                        meta={"source": "test"})
    with tel.span("step", step=0):
        pass
    rec = tel.event("elastic_recovery", step=4)
    assert rec == {"kind": "event", "event": "elastic_recovery", "step": 4}
    tel.close()
    tel.close()
    rows = pkg.read_run(path)
    assert rows[-1]["kind"] == "summary"
    assert rows[-1]["metrics"]["events/elastic_recovery"]["value"] == 1
    assert os.path.exists(str(tmp_path / "t.json"))


def test_telemetry_disabled_is_inert(pkg, tmp_path):
    tel = pkg.Telemetry(pkg.ObsConfig(enabled=False,
                                      metrics_path=str(tmp_path / "no.jsonl")))
    assert tel.registry is pkg.NULL_REGISTRY and tel.sink is None
    with tel.span("x") as sp:
        pass
    assert sp.duration == 0.0
    tel.event("whatever")
    tel.close()
    assert not os.path.exists(str(tmp_path / "no.jsonl"))


def test_telemetry_off_rank_0_writes_no_artifact(tmp_path):
    """Every rank keeps its own registry; only rank 0 opens the sink and
    writes the trace, as the reference's one controller does."""
    cfg = tobs.ObsConfig(metrics_path=str(tmp_path / "m.jsonl"),
                         trace_path=str(tmp_path / "t.json"))
    tel = tobs.Telemetry(cfg, rank=1)
    with tel.span("step", step=0):
        tel.event("checkpoint", step=0)
    tel.close()
    assert tel.sink is None and tel.registry.snapshot()["events/checkpoint"]["value"] == 1
    assert os.listdir(tmp_path) == []


# ------------------------------------------------- bucket-schedule gauges --

def test_record_bucket_metrics_gauges(pkg):
    tree = pkg.tree()
    cfg = pkg.GradSyncConfig(fuse=True, comm_dtype=pkg.fp32, bucket_bytes=16 * 1024)
    reg = pkg.MetricsRegistry()
    assert len(pkg.record_bucket_metrics(tree, cfg, reg)) == 4
    snap = reg.snapshot()
    assert snap["grad_sync/num_buckets"]["value"] == 4
    assert snap["grad_sync/num_exchanges"]["value"] == 4
    assert snap["grad_sync/total_nbytes"]["value"] == 4 * 64 * 64 * 4
    assert snap["grad_sync/bucket00/nbytes"]["value"] == 64 * 64 * 4
    reg2 = pkg.MetricsRegistry()
    layout2 = pkg.record_bucket_metrics(
        tree, pkg.GradSyncConfig(fuse=False, comm_dtype=pkg.fp32), reg2)
    assert [b["mode"] for b in layout2] == ["per_leaf"] * 4
    snap2 = reg2.snapshot()
    assert snap2["grad_sync/num_exchanges"]["value"] == 4
    assert snap2["grad_sync/per_leaf_exchanges"]["value"] == 4
    assert snap2["grad_sync/grouped_buckets"]["value"] == 0
    assert pkg.record_bucket_metrics(tree, cfg, None) == []


def test_record_bucket_metrics_clears_stale_gauges(pkg):
    tree = pkg.tree()
    reg = pkg.MetricsRegistry()
    pkg.record_bucket_metrics(tree, pkg.GradSyncConfig(
        fuse=True, comm_dtype=pkg.fp32, bucket_bytes=16 * 1024), reg)
    assert "grad_sync/bucket03/nbytes" in reg.names("grad_sync/")
    pkg.record_bucket_metrics(tree, pkg.GradSyncConfig(
        fuse=True, comm_dtype=pkg.fp32, bucket_bytes=0), reg)
    names = reg.names("grad_sync/")
    assert "grad_sync/bucket00/nbytes" in names
    assert "grad_sync/bucket03/nbytes" not in names
    assert reg.snapshot()["grad_sync/num_buckets"]["value"] == 1
    pkg.record_bucket_metrics(tree, pkg.GradSyncConfig(fuse=False, comm_dtype=pkg.fp32),
                              reg)
    names = reg.names("grad_sync/")
    assert "grad_sync/num_buckets" not in names
    assert "grad_sync/bucket00/nbytes" not in names
    assert reg.snapshot()["grad_sync/per_leaf_exchanges"]["value"] == 4


@pytest.mark.parametrize("kw", [dict(bucket_bytes=4 << 20), dict(bucket_bytes=0),
                                dict(bucket_bytes=1 << 20, fuse=False),
                                dict(bucket_bytes=4 << 20, comm_dtype="float32")])
def test_record_bucket_metrics_on_resnet50_equals_the_reference(kw):
    jshapes = jax.eval_shape(lambda: jresnet.init(jax.random.key(0),
                                                  jresnet.ResNetConfig.resnet50()))
    with torch.device("meta"):     # shapes only, no weights drawn
        params = dict(tresnet.ResNet(tresnet.ResNetConfig.resnet50(),
                                     torch.Generator(device="cpu")).named_parameters())
    kw = dict(kw)
    dt = kw.pop("comm_dtype", None)
    jcfg = jgs.GradSyncConfig(**kw, **({"comm_dtype": jnp.float32} if dt else {}))
    tcfg = tgs.GradSyncConfig(**kw, **({"comm_dtype": torch.float32} if dt else {}))
    want, got = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    assert tgs.record_bucket_metrics(params, tcfg, got) == \
        jgs.record_bucket_metrics(jshapes, jcfg, want)
    assert got.snapshot() == want.snapshot()
    assert len(got.names("grad_sync/bucket")) >= 2


# ------------------------------------------------- the trainer's telemetry --

def test_trainer_telemetry_end_to_end(tmp_path):
    """The reference's acceptance contract on the port's trainer (one rank,
    CPU): (a) per-step phase durations sum to within 10% of the step's wall
    time, (b) the bucket gauges count the schedule's exchanges, (c) the
    Chrome trace loads and nests data/dispatch/checkpoint under step,
    (d) recording costs under 5% of a step, (e) history rows round-trip
    through JSONL on their ``kind`` marker and every one is mirrored to the
    sink."""
    from repro_torch.core.batch_control import build_plan
    from repro_torch.core.schedules import BatchSchedule, BatchStage
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    n_layers, width = 8, 256     # a step of a few ms, well above the spans' cost
    gen = torch.Generator().manual_seed(0)
    params = {f"layer{i:02d}.kernel": torch.randn(width, width, generator=gen) / width
              for i in range(n_layers)}

    def loss_fn(p, batch, grid):
        x, y = batch
        h = x
        for i in range(n_layers):
            h = torch.tanh(h @ p[f"layer{i:02d}.kernel"])
        return torch.mean((h - y) ** 2), torch.zeros(())

    rng = np.random.RandomState(0)
    xs = rng.randn(512, width).astype(np.float32)
    ys = np.tanh(xs @ rng.randn(width, width).astype(np.float32) / width)

    def data_fn(i, gb):
        idx = (np.arange(gb) + i * gb) % len(xs)
        return torch.from_numpy(xs[idx]), torch.from_numpy(ys[idx])

    metrics_path = str(tmp_path / "metrics.jsonl")
    trace_path = str(tmp_path / "trace.json")
    tcfg = TrainerConfig(
        grad_sync=tgs.GradSyncConfig(strategy="torus2d", comm_dtype=torch.float32,
                                     bucket_bytes=16 * 1024),
        log_every=2, ckpt_every_steps=2,
        obs=tobs.ObsConfig(metrics_path=metrics_path, trace_path=trace_path))
    plan = build_plan(BatchSchedule((BatchStage(0, 1.0, 64),)), dataset_size=512,
                      n_workers=1, max_steps=6)
    trainer = Trainer(loss_fn, tcfg, plan, data_fn, checkpoint_dir=str(tmp_path / "ckpt"))
    state, history = trainer.run(TrainState.create(params), log=lambda *a: None)
    assert state.step == 6

    rows = tobs.read_run(metrics_path)
    snap = [r for r in rows if r["kind"] == "summary"][-1]["metrics"]
    phase_rows = [r for r in rows if r.get("metric") == "step_phases"]
    assert len(phase_rows) == 6
    for r in phase_rows:
        covered = sum(r["phases"].values())
        assert 0.90 * r["wall_s"] <= covered <= 1.02 * r["wall_s"], r

    gauges = [n for n in snap if n.startswith("grad_sync/bucket") and n.endswith("/nbytes")]
    assert len(gauges) == n_layers == snap["grad_sync/num_buckets"]["value"]
    assert snap["train/steps"]["value"] == 6
    assert snap["elastic/down_axes"]["value"] == 0
    assert snap["checkpoint/commits"]["value"] == 4     # initial, 2, 4, 6

    events = json.load(open(trace_path))["traceEvents"]
    assert {"step", "data", "dispatch", "sync_wait", "log", "checkpoint"} <= \
        {e["name"] for e in events}
    steps = sorted((e for e in events if e["name"] == "step"), key=lambda e: e["ts"])
    assert len(steps) == 6
    s0 = steps[0]
    inner = [e for e in events if e["name"] in ("data", "dispatch")
             and s0["ts"] <= e["ts"] <= s0["ts"] + s0["dur"]]
    assert len(inner) >= 2
    assert all(e["ts"] + e["dur"] <= s0["ts"] + s0["dur"] + 1.0 for e in inner)

    tel = tobs.Telemetry(tobs.ObsConfig(metrics_path=str(tmp_path / "bench.jsonl")))
    reg = tel.registry
    n_iters = 1000
    t0 = time.perf_counter()
    for k in range(n_iters):
        with tel.span("step", step=k) as sp:
            for name in ("data", "dispatch", "sync_wait", "log", "checkpoint"):
                with tel.span(name, step=k):
                    pass
        reg.histogram("step/wall_s").observe(sp.duration)
        reg.histogram("step/data_s").observe(0.0)
        reg.histogram("step/sync_wait_s").observe(0.0)
        reg.counter("train/steps").inc()
        reg.gauge("train/loss_scale").set(1.0)
        tel.emit({"kind": "metric", "metric": "step_phases", "step": k,
                  "wall_s": sp.duration, "phases": {"data": 0.0}})
    per_bundle = (time.perf_counter() - t0) / n_iters
    tel.close()
    steady = [r["wall_s"] for r in phase_rows[1:]]
    assert per_bundle < 0.05 * (sum(steady) / len(steady)), (per_bundle, steady)

    assert all(h.get("kind") in ("metric", "event") for h in history)
    back = [json.loads(line) for line in "\n".join(json.dumps(h) for h in history)
            .splitlines()]
    assert back == history
    assert any(e["event"] == "checkpoint" for e in back if e["kind"] == "event")
    mirrored = [r for r in rows if r["kind"] in ("metric", "event")
                and r.get("metric") != "step_phases"]
    assert len(mirrored) == len(history)
