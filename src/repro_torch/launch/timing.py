"""Device time of one call on the card, and the least time the card could
take for the same work, for ``chip_smoke.py`` and the ``launch/profile_*``
scripts. The timing helpers need a CUDA card."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM peak rates, from NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12        # device memory
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 on the tensor cores, dense
TF32_FLOPS_PER_S = 494.7e12      # TF32 on the tensor cores, dense


def bound(nbytes: int, flops: int, flops_per_s: float = FP32_FLOPS_PER_S
          ) -> tuple[float, str]:
    """(least ms, what bounds it: "bytes" or "operations") for work that
    moves ``nbytes`` through device memory and does ``flops`` at
    ``flops_per_s``."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / flops_per_s
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events (no host launch
    cost inside the window)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters: int = 20) -> float:
    """Time of one eager ``fn()`` call between CUDA events, host launch
    cost included (what the main path pays)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
