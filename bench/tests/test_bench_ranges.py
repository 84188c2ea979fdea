"""The program's ranges in a profiler window (``ranges.py``) on a
hand-written trace: device operations go to the range that launched them,
idle gaps are cut by the training thread's ranges over time, and the
ranges move nothing that ``trace.py`` and the per-layer readers read."""

import pytest

from bench.harness import ranges, runner, spec
from bench.harness import trace as tr

H100 = "NVIDIA H100 80GB HBM3"


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _range(name, ts, dur):
    return _x(ranges.PREFIX + name, "user_annotation", ts, dur)


# one step on the training thread (tid 1): the loop's spans and the step
# function's, as the trainer nests them (microseconds)
RANGES = [
    _range("step", 10, 180), _range("data", 10, 10), _range("dispatch", 20, 130),
    _range("forward", 20, 30), _range("backward", 50, 50), _range("grad_sync", 100, 10),
    _range("guard", 110, 15), _range("optimizer", 125, 10), _range("guard", 135, 10),
    _range("step_metrics", 145, 5), _range("sync_wait", 150, 30), _range("log", 180, 10),
]

OPERATIONS = [
    _x(tr.WINDOW, "user_annotation", 0, 200),
    _x("aten::mm", "cpu_op", 22, 5),
    _x("cudaLaunchKernel", "cuda_runtime", 24, 1, correlation=1),
    # the autograd engine's thread launches while tid 1 waits inside backward
    _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op", 58, 4, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 60, 1, tid=2, correlation=2),
    _x("aten::where", "cpu_op", 111, 3),
    _x("cudaLaunchKernel", "cuda_runtime", 112, 1, correlation=3),
    _x("aten::item", "cpu_op", 152, 20),
    _x("cudaMemcpyAsync", "cuda_runtime", 155, 1, correlation=4),
    _x("nvjet_tst_128x256_64x4", "kernel", 30, 30, tid=7, correlation=1),
    _x("void at::native::elementwise_kernel", "kernel", 60, 30, tid=7, correlation=2),
    _x("void at::native::where_kernel", "kernel", 112, 28, tid=7, correlation=3),
    # idle from 140 to 165: the guard's last 5, step_metrics' 5, then sync_wait's 15
    _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 165, 5, tid=7, correlation=4),
]


def test_device_ops_go_to_the_range_that_launched_them():
    r = ranges.attribute(RANGES + OPERATIONS, steps=1)
    assert r.device_s == pytest.approx({"forward": 30e-6, "backward": 30e-6,
                                        "guard": 28e-6, "sync_wait": 5e-6})
    assert r.launches == {"forward": 1, "backward": 1, "guard": 1, "sync_wait": 1}
    assert r.ms_per_step("guard") == pytest.approx(28e-3)
    assert r.ms_per_step("grad_sync", "optimizer") == 0.0


def test_idle_gaps_are_cut_by_the_training_thread_s_ranges():
    r = ranges.attribute(RANGES + OPERATIONS, steps=1)
    # gaps: 0-30 (outside, data, forward), 90-112 (backward, grad_sync, guard),
    # 140-165 (guard, step_metrics, sync_wait), 170-200 (sync_wait, log, outside)
    assert r.idle_s == pytest.approx({ranges.OUTSIDE: 20e-6, "data": 10e-6, "forward": 10e-6,
                                      "backward": 10e-6, "grad_sync": 10e-6, "guard": 7e-6,
                                      "step_metrics": 5e-6, "sync_wait": 25e-6,
                                      "log": 10e-6})
    assert r.idle_ms_per_step(*ranges.DISPATCH) == pytest.approx(42e-3)
    assert r.idle_ms_per_step(*ranges.LOOP) == pytest.approx(45e-3)
    # whole: the labels' device time is the window's busy time, their idle the rest
    t = tr.reduce(RANGES + OPERATIONS, steps=1)
    assert sum(r.device_s.values()) == pytest.approx(t.busy_s)
    assert sum(r.idle_s.values()) == pytest.approx(t.window_s - t.busy_s)


def test_a_trace_without_program_ranges_has_no_attribution():
    assert ranges.attribute(OPERATIONS, steps=1) is None
    # the benchmark's own window and NCCL's annotations are no program range
    assert ranges.attribute(OPERATIONS + [_x("nccl:all_reduce", "user_annotation", 100, 5)],
                            steps=1) is None


@pytest.mark.parametrize("name", ["resnet50.mlperf256", "qwen3-1.7b.seq4096"])
def test_the_ranges_move_nothing_the_benchmark_reads(name):
    cell = spec.cell(name)
    without = tr.reduce(OPERATIONS, steps=1)
    with_ranges = tr.reduce(RANGES + OPERATIONS, steps=1)
    assert (with_ranges.window_s, with_ranges.busy_s, with_ranges.ops) == \
        (without.window_s, without.busy_s, without.ops)
    assert sorted(s for _, s in with_ranges.gaps) == sorted(s for _, s in without.gaps)
    assert with_ranges.top_ops(10) == without.top_ops(10)

    def read(t):
        layers = runner.Layers(t, 0.3, cell.config, cell.traffic, H100)
        return {m["name"]: spec.reader("metrics", m["name"])(layers) for m in cell.per_layer}

    assert read(with_ranges) == read(without)


def test_segments_label_each_piece_by_the_innermost_range():
    segs = ranges.segments([(0, 10, "step"), (2, 4, "data"), (4, 9, "dispatch"),
                            (5, 6, "guard")])
    assert segs == [(0, 2, "step"), (2, 4, "data"), (4, 5, "dispatch"), (5, 6, "guard"),
                    (6, 9, "dispatch"), (9, 10, "step")]
