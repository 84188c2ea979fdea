"""The trace reduction and the rates on synthetic inputs."""

from bench.harness import classes, runner, spec
from bench.harness import trace as tr


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_union_and_gaps():
    assert tr.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert tr.gaps([(0, 3), (5, 8)], -1, 10) == [(-1, 0), (3, 5), (8, 10)]


def test_reduce_counts_overlapping_streams_once_and_labels_gaps():
    events = [
        _x(tr.WINDOW, "user_annotation", 0, 100),
        _x("aten::conv2d", "cpu_op", 0, 20),
        _x("aten::convolution", "cpu_op", 1, 10),           # nested: not a label
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
        _x("nccl:all_reduce", "user_annotation", 40, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 41, 1, correlation=2),
        _x("sm90_xmma_conv_kernel", "kernel", 10, 20, tid=7, correlation=1),
        _x("ncclDevKernel_AllReduce", "kernel", 25, 25, tid=8, correlation=2),   # overlaps
        _x("vectorized_elementwise_kernel", "kernel", 90, 20, tid=7, correlation=3),  # cut at 100
    ]
    t = tr.reduce(events, steps=2)
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - (40 + 10) * 1e-6) < 1e-12          # [10, 50] and [90, 100]
    labels = dict((k, round(v * 1e6, 6)) for k, v in t.gaps)
    assert labels == {"aten::conv2d": 10.0, "no launch found": 40.0}
    assert t.launches_per_step() == 1.5
    assert abs(t.ms_per_step(include=(classes.NCCL,)) - 25e-3 / 2) < 1e-12
    assert abs(t.ms_per_step(exclude=(classes.MATMUL, classes.NCCL)) - 10e-3 / 2) < 1e-12
    assert t.top_ops(1)[0][0] == "ncclDevKernel_AllReduce"
    idle = spec.reader("metrics", "device_idle_share.resnet")(
        runner.Layers(t, 0.1, {"family": "resnet"}, {}, "cpu"))
    assert abs(idle - 50.0) < 1e-9


def test_window_without_the_host_operators():
    events = [_x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
              _x("k1", "kernel", 10, 20, tid=7, correlation=1),
              _x("k2", "kernel", 40, 20, tid=7, correlation=2)]
    t = tr.reduce(events, steps=1)
    assert abs(t.window_s - 55e-6) < 1e-12 and abs(t.busy_s - 40e-6) < 1e-12


def test_classes_of_the_port_kernels():
    assert classes.classify("dkdv_wg_kernel<128>") == classes.FLASH
    assert classes.classify("lars_norms_kernel") == classes.LARS
    assert classes.classify("ls_xent_bwd_kernel") == classes.XENT
    assert classes.classify("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL") == classes.NCCL
    assert classes.classify("nvjet_tst_128x256_64x4") == classes.MATMUL
    assert classes.classify("void at::native::vectorized_elementwise_kernel") == "elementwise"


def test_rates_are_every_item_over_the_window():
    periods = [i / 1000 for i in range(1, 101)]         # 1 .. 100 ms
    w = runner.Window("images", 100, 32, sum(periods), periods, 1.0, 1)
    rate = spec.reader("end_to_end", "images_per_s_per_chip")(w)
    assert abs(rate - 100 * 32 / sum(periods)) < 1e-9
    assert spec.reader("end_to_end", "tokens_per_s_per_chip")(w) is None
    lm = runner.Window("tokens", 10, 8192, 4.0, [0.4] * 10, 1.0, 1)
    assert abs(spec.reader("end_to_end", "tokens_per_s_per_chip")(lm) - 20480.0) < 1e-9
    assert spec.reader("end_to_end", "images_per_s_per_chip")(lm) is None
