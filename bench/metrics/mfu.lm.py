"""Model FLOPs utilisation of the whole step: 6 N plus causal attention
FLOPs a token (``counts/lm.py``) times the rank's tokens, over the untraced
window's time a step at the chip's bf16 peak, in %."""

from bench.counts import lm, peaks


def read(t):
    peak = peaks.peak(t.device_name)
    if peak is None:
        return None
    s = t.traffic["seq_len"]
    flops = lm.flops_per_token(t.config["model"], s) * t.traffic["per_rank_batch"] * s
    return 100.0 * flops / t.step_s / peak["bf16_flops"]
