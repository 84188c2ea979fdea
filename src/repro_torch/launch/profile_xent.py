"""Time the label-smoothed cross-entropy kernels on one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_xent [--sweep] [--out FILE]

At each shape of ``SHAPES`` (the ResNet-50 head's and the Qwen3-1.7B
training logits') it times ``ls_xent_fwd_cuda`` and ``ls_xent_bwd_cuda``
beside their bound (``launch/timing.py:bound``: bytes / 3.35 TB/s, or
operations / the fp32 rate if larger), their plain versions in
``kernels/ref.py``, and ``F.cross_entropy(label_smoothing=0.1,
reduction="none")``: forward alone beside the forward kernel, forward with
backward beside the backward one. At the long-row shapes it also times
``x.sum()`` and ``d.copy_(x)`` over the same logits: what PyTorch's own
streaming kernels reach on the forward's and the backward's bytes. All times
are device time from CUDA-graph replay (``launch/timing.py``); the logits of
the long-row shapes are larger than the 50 MB L2, so each launch finds them
in device memory. Prints one JSON line a shape and the card's name and power
limit; ``--out`` writes them all as one JSON file. ``--sweep`` first times
both kernels at every threads-a-row mapping that they take (``ROW_THREADS``:
32, a warp a row; 128 or 512, a block a row) over ``SWEEP_VOCABS`` x
``SWEEP_ROWS`` x fp32/bf16: the measurements that set
``kernels/ls_xent.py:row_threads``. Needs a CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import ls_xent, ref
from repro_torch.kernels.ls_xent import ls_xent_bwd_cuda, ls_xent_fwd_cuda
from repro_torch.launch.profile_step import gpu_line
from repro_torch.launch.timing import bound, eager_ms, graph_ms

SMOOTHING = 0.1
# (rows, vocab, dtype, what): the ResNet-50 head at its two batch stages;
# Qwen3-1.7B's logits for 2 sequences of 2048 tokens (vocab 151,936)
SHAPES = ((32, 1000, torch.float32, "ResNet-50 head, 32 images"),
          (64, 1000, torch.float32, "ResNet-50 head, 64 images"),
          (4096, 151936, torch.float32, "Qwen3-1.7B logits, 2 x 2048 tokens"),
          (4096, 151936, torch.bfloat16, "Qwen3-1.7B logits, 2 x 2048 tokens"))

SWEEP_VOCABS = (1000, 4096, 8192, 16384, 32768, 151936)
SWEEP_ROWS = (64, 512, 4096)


def time_xent(rows: int, vocab: int, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """Both kernels at (rows, vocab) logits of ``dtype``: their ms (and
    eager ms, host launch included), bound, plain ms and the library's ms."""
    dev = gen.device
    x = (4.0 * torch.randn(rows, vocab, generator=gen, device=dev)).to(dtype)
    y = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
    gout = torch.full((rows,), 1.0 / rows, device=dev)
    lse = ref.ls_xent_fwd_ref(x, y, SMOOTHING)[1]
    xl = x.detach().requires_grad_(True)

    def lib_fwd_bwd():
        out = F.cross_entropy(xl, y, label_smoothing=SMOOTHING, reduction="none")
        return torch.autograd.grad(out, xl, gout)

    big = rows * vocab * x.element_size() > 2**26
    kw = dict(iters=5, replays=3) if big else {}
    logits_bytes = rows * vocab * x.element_size()
    row_bytes = rows * (8 + 4 + 4)    # fwd: label in, loss and lse out; bwd: label, lse, gout in
    at = f"({rows}, {vocab}) {str(dtype)[6:]} logits"
    out = {
        "ls_xent_fwd": {
            "ms": graph_ms(lambda: ls_xent_fwd_cuda(x, y, SMOOTHING), **kw),
            "eager_ms": eager_ms(lambda: ls_xent_fwd_cuda(x, y, SMOOTHING),
                                 iters=kw.get("iters", 20)),
            "plain_ms": graph_ms(lambda: ref.ls_xent_fwd_ref(x, y, SMOOTHING), **kw),
            "library_ms": graph_ms(lambda: F.cross_entropy(
                x, y, label_smoothing=SMOOTHING, reduction="none"), **kw),
            "bytes": logits_bytes + row_bytes,
            "flops": 5 * rows * vocab,     # max, exp, rescale, two sums
            "at": at,
        },
        "ls_xent_bwd": {
            "ms": graph_ms(lambda: ls_xent_bwd_cuda(x, y, lse, gout, SMOOTHING), **kw),
            "eager_ms": eager_ms(lambda: ls_xent_bwd_cuda(x, y, lse, gout, SMOOTHING),
                                 iters=kw.get("iters", 20)),
            "plain_ms": graph_ms(lambda: ref.ls_xent_bwd_ref(x, y, lse, gout, SMOOTHING),
                                 **kw),
            # no single PyTorch call computes only this backward
            "library_ms": None,
            "library_fwd_bwd_ms": graph_ms(lib_fwd_bwd, **kw),
            "bytes": 2 * logits_bytes + row_bytes,
            "flops": 5 * rows * vocab,     # sub, exp, two offsets, scale
            "at": at,
        },
    }
    if big:   # PyTorch's own streaming kernels over the same logits
        d = torch.empty_like(x)
        out["ls_xent_fwd"]["sum_ms"] = graph_ms(lambda: x.sum(), **kw)
        out["ls_xent_bwd"]["copy_ms"] = graph_ms(lambda: d.copy_(x), **kw)
        del d
    for t in out.values():
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
        t["of_bound"] = t["bound_ms"] / t["ms"]
    del x, y, gout, lse, xl
    torch.cuda.empty_cache()
    return out


def sweep(gen: torch.Generator) -> list[dict]:
    """Kernel ms of both kernels at each row mapping, vocab, rows and dtype,
    and which mapping the wrapper picks there."""
    out = []
    for rows in SWEEP_ROWS:
        for vocab in SWEEP_VOCABS:
            for dtype in (torch.float32, torch.bfloat16):
                x = (4.0 * torch.randn(rows, vocab, generator=gen, device=gen.device)).to(dtype)
                y = torch.randint(0, vocab, (rows,), generator=gen, device=gen.device)
                gout = torch.full((rows,), 1.0 / rows, device=gen.device)
                lse = ref.ls_xent_fwd_ref(x, y, SMOOTHING)[1]
                kw = dict(iters=5, replays=3) if x.numel() * x.element_size() > 2**26 else {}
                row = {"rows": rows, "vocab": vocab, "dtype": str(dtype)[6:],
                       "picked_fwd": ls_xent.row_threads(vocab, x.element_size()),
                       "picked_bwd": ls_xent.row_threads(vocab, x.element_size(), True)}
                for th in ls_xent.ROW_THREADS:
                    row[f"fwd_ms_{th}"] = graph_ms(
                        lambda: ls_xent._fwd_launch(x, y, SMOOTHING, th), **kw)
                    row[f"bwd_ms_{th}"] = graph_ms(
                        lambda: ls_xent._bwd_launch(x, y, lse, gout, SMOOTHING, th), **kw)
                print(json.dumps(row))
                out.append(row)
                del x, y, gout, lse
                torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_xent: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.zeros(1, device="cuda")
    # the launch floor in graph replay: one kernel that writes one float
    result = {"gpu": card, "torch": torch.__version__,
              "floor_ms": graph_ms(lambda: one.fill_(1.0)), "shapes": []}
    print(f"floor: one 1-element fill kernel {result['floor_ms']} ms")
    if args.sweep:
        result["sweep"] = sweep(gen)
    for rows, vocab, dtype, what in SHAPES:
        t = time_xent(rows, vocab, dtype, gen)
        result["shapes"].append({"what": what, **t})
        print(json.dumps({"what": what, **t}))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
