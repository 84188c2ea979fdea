"""Model FLOPs utilisation of the whole step: three forwards' FLOPs of the
rank's images, counted from ResNet's layer shapes (``counts/resnet.py``),
over the untraced window's time a step at the chip's bf16 peak, in %."""

from bench.counts import peaks, resnet


def read(t):
    peak = peaks.peak(t.device_name)
    if peak is None:
        return None
    flops = resnet.train_flops(t.config["model"], t.traffic["per_rank_batch"])
    return 100.0 * flops / t.step_s / peak["bf16_flops"]
