"""The LARS kernels' share of their roofline: p, g and v read once and p and
v written once in float32 at the HBM peak (``counts/lm.py``), over the LARS
kernels' summed device time a step, in %."""

from bench.counts import lm, peaks
from bench.harness import classes


def read(t):
    peak = peaks.peak(t.device_name)
    ms = t.trace.ms_per_step(include=(classes.LARS,))
    if peak is None or ms <= 0:
        return None
    return 100.0 * lm.lars_bytes(t.config["model"]) / peak["hbm_bytes"] / (ms / 1e3)
