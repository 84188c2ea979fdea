"""The work counts of ``bench/counts`` against counts made by hand."""

import json

from bench.counts import lm, peaks, resnet
from bench.harness import spec


def _config(name):
    return json.loads((spec.BENCH / "configs" / f"{name}.json").read_text())


def test_resnet50_forward_macs_by_hand():
    m = _config("resnet50-v1.5")["model"]
    # (output side, cin, cout, kernel) of every conv, stage by stage, at 224 px
    convs = [(112, 3, 64, 7)]
    cin, side = 64, 56
    for stage, n in enumerate((3, 4, 6, 3)):
        inner, out = 64 * 2 ** stage, 256 * 2 ** stage
        for b in range(n):
            o = side // 2 if stage > 0 and b == 0 else side
            convs += [(side, cin, inner, 1), (o, inner, inner, 3), (o, inner, out, 1)]
            if b == 0:
                convs.append((o, cin, out, 1))
            cin, side = out, o
    macs = sum(s * s * ci * co * k * k for s, ci, co, k in convs) + 2048 * 1000
    assert resnet.forward_macs(m) == macs
    assert abs(macs - 4.1e9) / 4.1e9 < 0.01          # the usual ~4.1 GMAC
    assert resnet.train_flops(m, 32) == 6 * macs * 32


def test_qwen3_params_and_flops_by_hand():
    m = _config("qwen3-1.7b")["model"]
    assert lm.params(m) == 1_720_574_976
    # 6 N + 12 L H D (S + 1) / 2 at S = 4096
    assert lm.flops_per_token(m, 4096) == 6 * 1_720_574_976 + 12 * 28 * 16 * 128 * 4097 / 2
    assert abs(lm.flops_per_token(m, 4096) - 1.17e10) / 1.17e10 < 0.005
    fwd_layer = 4 * 2 * 16 * 128 * 4096 * 4097 / 2
    assert lm.flash_flops(m, 2, 4096) == 3.5 * fwd_layer * 28
    assert lm.lars_bytes(m) == 20 * 1_720_574_976


def test_peaks_only_for_the_listed_card():
    assert peaks.peak("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989.4e12
    assert peaks.peak("NVIDIA H100 PCIe") is None
