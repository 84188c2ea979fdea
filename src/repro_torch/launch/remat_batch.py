"""The largest batch of an LM that trains on one card with ``remat``.

    PYTHONPATH=src python3 -m repro_torch.launch.remat_batch \
        [--arch qwen3-1.7b] [--seq 2048] [--batches 4,8,12,16,20,24] [--steps 3]

Each batch size in ``--batches`` is tried in a process of its own, so that
no size meets the allocator state an earlier one left. It builds the
training run of ``repro_torch.launch.train.build`` at full width with
``remat`` on (one stage of ``--steps`` steps of that many sequences of
``--seq`` tokens; the 1 x 1 grid, random weights from seed 0) and trains
it, printing the step ms (host clock; the median after the first step),
tokens/s and peak device memory. A size that runs out of device memory is
tried once more in a fresh process with the allocator's history recorded,
and the failure is printed: the allocation that failed (its size and the
innermost frames of this package under it), the allocator's counts at that
moment, and the live blocks by the frame that allocated them, largest
first. The answer is the largest size before the first that ran out of
memory (fragmentation can let a larger one run: those that did are listed
too), printed beside the card's name and power limit, which
``chip_smoke.py`` then trains as a plain stage. Set
``PYTORCH_CUDA_ALLOC_CONF`` outside to try another allocator setting; the
children inherit it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import multiprocessing
import queue
import sys
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.launch import profile_trainer
from repro_torch.launch import train as launch_train
from repro_torch.launch.profile_step import gpu_line

GIB = 2**30


def train_at(arch: str, batch: int, seq: int, steps: int) -> dict:
    """One stage of ``steps`` steps at ``batch`` sequences with remat: step
    ms, tokens/s and peak GiB."""
    cfg = dataclasses.replace(registry.get(arch), remat=True)
    run = launch_train.build(arch, cfg=cfg, seq=seq, batch_stages=(batch,), steps=None,
                             stage_steps=steps, device="cuda", log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, history = run.trainer.run(run.state, log=lambda s: None)
    torch.cuda.synchronize()
    rows = [h for h in history if h["kind"] == "metric"]
    st = profile_trainer.stage_medians(run.trainer.plan, rows)[0]
    finite = all(abs(r["loss"]) < float("inf") and not r["skipped"] for r in rows)
    return {"batch": batch, "step_ms": st["step_ms"],
            "steady_median_ms": st["steady_median_ms"],
            "tokens_per_s": batch * seq / (st["steady_median_ms"] / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / GIB, "finite": finite}


def _site(frames) -> str:
    """The innermost frames of this package in a stack, innermost first."""
    ours = [f for f in frames if "repro_torch" in f["filename"]]
    return " <- ".join(f"{f['filename'].rsplit('repro_torch/', 1)[-1]}:{f['line']} "
                       f"{f['name']}" for f in ours[:3]) or "(outside repro_torch)"


def oom_report(err: BaseException) -> dict:
    """What the allocator held when ``err`` (an out-of-memory error) was
    raised: the failing call site, the counts, and the live blocks grouped
    by the frame that allocated them (needs the recorded history)."""
    tb = [{"filename": f.filename, "line": f.lineno, "name": f.name}
          for f in reversed(traceback.extract_tb(err.__traceback__))]
    stats = torch.cuda.memory_stats()
    by_site = collections.Counter()
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for block in seg["blocks"]:
            if block["state"] == "active_allocated":
                by_site[_site(block.get("frames", []))] += block["size"]
    return {"message": str(err).splitlines()[0], "failed_at": _site(tb),
            "allocated_gib": stats["allocated_bytes.all.current"] / GIB,
            "reserved_gib": stats["reserved_bytes.all.current"] / GIB,
            "inactive_split_gib": stats["inactive_split_bytes.all.current"] / GIB,
            "live_by_site_gib": [(site, n / GIB) for site, n in by_site.most_common(8)]}


def _child(arch: str, batch: int, seq: int, steps: int, record: bool, out) -> None:
    if record:
        torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
    try:
        out.put(train_at(arch, batch, seq, steps))
    except torch.cuda.OutOfMemoryError as err:
        out.put({"batch": batch, "oom": oom_report(err) if record else str(err)})


def try_batch(arch: str, batch: int, seq: int, steps: int, record: bool) -> dict:
    """``train_at`` in a fresh process (``record``: the allocator's history
    on, for the report of an out-of-memory error)."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_child, args=(arch, batch, seq, steps, record, out))
    proc.start()
    while True:
        try:
            row = out.get(timeout=5)
            break
        except queue.Empty:
            if not proc.is_alive():
                raise RuntimeError(f"batch {batch}: the process exited {proc.exitcode}")
    proc.join()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batches", default="4,8,12,16,20,24")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("remat_batch: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_line()
    fits, ooms = [], []
    for b in (int(s) for s in args.batches.split(",")):
        row = try_batch(args.arch, b, args.seq, args.steps, record=False)
        tag = f"{args.arch} batch {b} x {args.seq} remat"
        if "oom" in row:
            print(f"{tag}: out of device memory ({card}): {row['oom']}")
            row = try_batch(args.arch, b, args.seq, args.steps, record=True)
        if "oom" in row:
            print(f"{tag}, history recorded: {json.dumps(row['oom'], indent=1)}")
            ooms.append(b)
            continue
        fits.append(row)
        print(f"{tag}: step ms {[round(w, 2) for w in row['step_ms']]}, median "
              f"{row['steady_median_ms']:.2f} ms, {row['tokens_per_s']:.0f} tokens/s, "
              f"peak {row['peak_gib']:.2f} GiB, finite {row['finite']} ({card})")
    largest = max((r["batch"] for r in fits if not ooms or r["batch"] < ooms[0]),
                  default=None)
    print(json.dumps({"arch": args.arch, "seq": args.seq, "fits": [r["batch"] for r in fits],
                      "out_of_memory": ooms, "largest": largest, "card": card}))
    return 0 if fits and all(r["finite"] for r in fits) else 1


if __name__ == "__main__":
    raise SystemExit(main())
