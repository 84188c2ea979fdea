"""The flash kernels' share of their roofline: the least time the chip could
take for every layer's causal attention forward and backward (the larger of
its FLOPs at the bf16 peak and its bytes at the HBM peak, ``counts/lm.py``)
over the flash kernels' summed device time a step, in %."""

from bench.counts import lm, peaks
from bench.harness import classes


def read(t):
    peak = peaks.peak(t.device_name)
    ms = t.trace.ms_per_step(include=(classes.FLASH,))
    if peak is None or ms <= 0:
        return None
    m, b, s = t.config["model"], t.traffic["per_rank_batch"], t.traffic["seq_len"]
    bound = max(lm.flash_flops(m, b, s) / peak["bf16_flops"],
                lm.flash_bytes(m, b, s) / peak["hbm_bytes"])
    return 100.0 * bound / (ms / 1e3)
