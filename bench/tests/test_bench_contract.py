"""``BENCHMARK.json`` against the benchmark's contract, every file it names
found by name, and the result line's keys."""

import json
import re

from bench.harness import runner, spec
from bench.harness import trace as tr

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _bench():
    return spec.benchmark()


def test_keys_names_and_limits():
    b = _bench()
    assert set(b) == KEYS
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    cells = {w["name"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("bench/") and (spec.ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and set(m["workloads"]) <= cells
    # a full check: 2 + 14 runs a cell of run_seconds + 60, 180 s a cell to compile, 1200 spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_metric_and_file_found_by_name():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.cell(w["name"], b)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert set(cell.traffic["limits"]) <= {"loss_gap", "grad_gap", "change_gap",
                                               "grad_gap_median", "change_gap_median",
                                               "update_diff_median"}
        assert cell.traffic["limits"]
        assert spec.system(cell.config).build
        for m in cell.end_to_end:
            assert callable(spec.reader("end_to_end", m["name"]))
        for m in cell.per_layer:
            assert callable(spec.reader("metrics", m["name"]))
            assert m["moves"] in reported


def test_result_line_keys():
    cell = spec.cell("resnet50.mlperf256")
    t = tr.Trace(2, 0.2, 0.1, [("k", "elementwise", 0.0, 0.1)], [("aten::add", 0.1)])
    r = {"numbers": {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 2.0, "grad_gap_median": 0.0,
                     "change_gap_median": 0.0, "update_diff_median": 0.0}, "attempted": 20,
         "failed": 0, "memory_peak_bytes": 1, "busy_s": 0.1, "trace": t,
         "window": runner.Window("images", 20, 32, 2.0, [0.1] * 20, 5.0, 1)}
    line, checks = runner.result(cell, r, runner.Options(cell.name, (1,), 1.0), "NVIDIA")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is False and len(checks) == len(cell.traffic["limits"])
    assert set(line["metrics"]) == {"images_per_s_per_chip", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    traced, _ = runner.result(cell, r, runner.Options(cell.name, (1,), 1.0, trace=True), "NVIDIA")
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    json.dumps(traced)


def test_a_kind_of_traffic_brings_its_feed_and_trainer_fields(monkeypatch, tmp_path):
    """A new kind of traffic is a new file: its ``fetch`` feeds ``data_fn``
    and its ``trainer_fields`` reach the program's trainer."""
    import time
    import types

    from conftest import TINY

    from bench.traffic import images

    calls, dirs = [], []

    def fetch(pool, call):
        calls.append(call)
        return pool[0]

    def trainer_fields(traffic, workdir):
        dirs.append(workdir)
        return {"checkpoint_dir": str(tmp_path / "ckpt")}

    kind = types.SimpleNamespace(pool=images.pool, items=images.items, fetch=fetch,
                                 trainer_fields=trainer_fields)
    monkeypatch.setattr(spec, "traffic", lambda name: kind)
    opts = runner.Options("resnet50.mlperf256", (3,), 0.1, device="cpu",
                          overrides=TINY["resnet"])
    r = runner.run(opts, time.perf_counter(), log=lambda line: None)[0]
    t = runner.load_cell(opts).traffic
    assert calls == list(range(len(calls)))
    assert len(calls) == t["check_steps"] + t["warmup_steps"] + r["window"].steps
    assert len(dirs) == 1 and dirs[0]
    assert any((tmp_path / "ckpt").iterdir())
