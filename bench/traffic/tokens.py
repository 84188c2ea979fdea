"""Traffic of kind ``tokens``: a pool of ready global batches of token
sequences, made on the device from the seed, that ``data_fn`` cycles
through. Tokens are uniform over the whole vocabulary, and the labels are
the next tokens; a step trains its global batch times ``seq_len`` tokens.
The cell's file gives ``pool`` and ``seq_len``.
"""

from __future__ import annotations

import torch

from bench.harness import data


def pool(cell, seed: int, device, global_batch: int) -> list[tuple]:
    t, m = cell.traffic, cell.config["model"]
    seq = torch.randint(0, m["vocab_size"], (t["pool"], global_batch, t["seq_len"] + 1),
                        generator=data.generator(device, seed, 1), device=device)
    return [(seq[i, :, :-1].contiguous(), seq[i, :, 1:].contiguous()) for i in range(t["pool"])]


def items(traffic: dict, global_batch: int) -> int:
    return global_batch * traffic["seq_len"]
