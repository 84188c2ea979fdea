"""Check and time the non-finite guard's kernels on one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_guard [--out FILE]

At the leaves of Qwen3-1.7B (310, 1,720,574,976 fp32 elements) and of
ResNet-50 (161, 25,557,032), laid out as ``sync_tree`` and LARS return them
(views of one flat buffer each), ``check`` holds the two kernels
(``csrc/guard.cu``) against their plain versions (``kernels/ref.py``) run
on the card, bit for bit, on a clean step and on one with a NaN planted.
``time_tree`` then times, beside their byte bounds at 3.35 TB/s:

- ``unscale_ms``: ``guard_unscale_count_cuda``, reading and writing each
  gradient once (8 bytes an element);
- ``commit_finite_ms``: ``guard_commit_cuda`` on a finite step, which moves
  no parameter byte; ``commit_skipped_ms`` on a skipped one, which copies
  the old p and v over the new (16 bytes an element);
- ``guard_eager_ms``: the guard as ``make_train_step`` runs it (the two
  kernels, the finite flag and ``next_loss_scale``), host launches included;
- ``plain_ms``: the guard's per-leaf code (the plain versions, the flag and
  the loss scale's rules);
- ``library_ms``: ``torch._amp_foreach_non_finite_check_and_unscale_``, the
  library's multi-tensor unscale and flag (no count), the yardstick that
  the port never calls;
- ``host_us``: the host's time of one step's guard, and ``plain_host_us``
  of the plain version's, timed over calls that the card finishes faster
  than the host issues them.

Device time from CUDA-graph replay (``launch/timing.py``) for the kernels
and the library call; eager (host launches included) for the plain
version, whose thousands of launches are its cost. ``chip_smoke.py`` runs
the same check and timing. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.guard import guard_commit_cuda, guard_unscale_count_cuda
from repro_torch.launch.profile_step import gpu_line
from repro_torch.launch.timing import HBM_BYTES_PER_S, eager_ms, graph_ms
from repro_torch.train.trainer import GuardConfig, next_loss_scale

CFG = GuardConfig()
TREES = ("resnet50", "qwen3-1.7b")


def leaf_sizes(tree: str) -> list[int]:
    """The leaves' sizes of ``"qwen3-1.7b"`` or ``"resnet50"``, in order."""
    if tree == "qwen3-1.7b":
        from repro_torch.configs import registry
        from repro_torch.models import transformer as T
        model = T.init(registry.get(tree), device="meta")
    else:
        from repro_torch.models import resnet
        model = resnet.init(resnet.ResNetConfig.resnet50(num_classes=1000, image_size=224),
                            seed=0, device="cuda")
    return [p.numel() for _, p in model.named_parameters()]


def _leaves(sizes, gen, mag=1.0):
    flat = torch.randn(sum(sizes), generator=gen, device="cuda")
    if mag != 1.0:
        flat.mul_(mag)
    return list(torch.split(flat, sizes))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32 \
        else torch.equal(a, b)


def _err(got: list[torch.Tensor], want: list[torch.Tensor]) -> float:
    """The largest |got - want| over the leaves, NaN where one is NaN and
    the other is not."""
    worst = 0.0
    for a, b in zip(got, want):
        d = (a - b).abs()
        both = torch.isnan(a) & torch.isnan(b)
        worst = max(worst, torch.where(both | (a == b), 0.0, d).max().item())
    return worst


def _guard(grads, loss, scale, good, old_p, new_p, old_v, new_v, unscale_count, commit):
    """The guard as ``make_train_step`` composes it."""
    grads, count = unscale_count(grads, scale)
    finite = torch.isfinite(loss) & (count == 0)
    new_p, new_v = commit(finite, old_p, new_p, old_v, new_v)
    return grads, count, new_p, new_v, next_loss_scale(finite, scale, good, CFG)


def check(sizes: list[int], gen: torch.Generator) -> dict:
    """The kernels against the plain version on the card, bit for bit: the
    unscale at 2^-3 with and without a NaN, then the commit of the finite
    and of the skipped step that follows; one pass at a time, to bound the
    memory. ``*_same`` each a bool, ``max_abs_err`` over all of them."""
    scale = torch.tensor(2.0 ** -3, device="cuda")
    out, err = {}, 0.0
    for fault in (False, True):
        grads = _leaves(sizes, gen, 1e-2)
        if fault:
            grads[len(sizes) // 2][-1] = float("nan")
        want, want_count = ref.guard_unscale_count_ref(grads, scale)
        got, count = guard_unscale_count_cuda(grads, scale)     # in place
        out[f"unscale_{'nan' if fault else 'clean'}_same"] = bool(
            all(_same(a, b) for a, b in zip(got, want)) and int(count) == int(want_count))
        err = max(err, _err(got, want))
        del grads, want, got
        old_p, new_p, old_v, new_v = (_leaves(sizes, gen) for _ in range(4))
        finite = torch.isfinite(torch.tensor(2.5, device="cuda")) & (count == 0)
        want = ref.guard_commit_ref(finite, old_p, new_p, old_v, new_v)
        got = guard_commit_cuda(finite, old_p, new_p, old_v, new_v)
        out[f"commit_{'skipped' if fault else 'finite'}_same"] = bool(
            bool(finite) != fault and
            all(_same(a, b) for ga, wa in zip(got, want) for a, b in zip(ga, wa)))
        err = max(err, _err(got[0] + got[1], want[0] + want[1]))
        del old_p, new_p, old_v, new_v, want, got
        torch.cuda.empty_cache()
    return {**out, "max_abs_err": err}


def _host_us(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / iters


def time_tree(tree: str, sizes: list[int], gen: torch.Generator) -> dict:
    n = sum(sizes)
    scale = torch.tensor(1.0, device="cuda")      # the unscale repeats in place: keep 1
    grads = _leaves(sizes, gen, 1e-2)
    old_p, new_p, old_v, new_v = (_leaves(sizes, gen) for _ in range(4))
    good = torch.zeros((), dtype=torch.int32, device="cuda")
    loss = torch.tensor(2.5, device="cuda")
    clean, skipped = (torch.tensor(f, device="cuda") for f in (True, False))
    _, count = guard_unscale_count_cuda(grads, scale)
    torch.cuda.synchronize()
    assert int(count) == 0

    def commit(finite):
        return lambda: guard_commit_cuda(finite, old_p, new_p, old_v, new_v)

    def step():            # the guard as make_train_step runs it
        _guard(grads, loss, scale, good, old_p, new_p, old_v, new_v,
               ops.guard_unscale_count, ops.guard_commit)

    def plain():
        _guard(grads, loss, scale, good, old_p, new_p, old_v, new_v,
               ref.guard_unscale_count_ref, ref.guard_commit_ref)

    found = torch.zeros(1, device="cuda")
    inv = torch.ones(1, device="cuda")

    def library():
        torch._amp_foreach_non_finite_check_and_unscale_(grads, found, inv)

    small = n < 10**8
    out = {
        "tree": tree, "leaves": len(sizes), "elements": n,
        "unscale_ms": graph_ms(lambda: guard_unscale_count_cuda(grads, scale), iters=10),
        "unscale_bound_ms": 1e3 * 8 * n / HBM_BYTES_PER_S,
        "commit_finite_ms": graph_ms(commit(clean), iters=10),
        "commit_skipped_ms": graph_ms(commit(skipped), iters=10),
        "commit_skipped_bound_ms": 1e3 * 16 * n / HBM_BYTES_PER_S,
        "guard_eager_ms": eager_ms(step, iters=10),
        "plain_ms": eager_ms(plain, iters=10 if small else 3),
        "library_ms": graph_ms(library, iters=10),
        "host_us": _host_us(step, 200 if small else 10),
        "plain_host_us": _host_us(plain, 50 if small else 3),
    }
    out["unscale_of_bound"] = out["unscale_bound_ms"] / out["unscale_ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_guard: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"gpu": card, "torch": torch.__version__, "trees": []}
    ok = True
    for tree in TREES:
        sizes = leaf_sizes(tree)
        checked = check(sizes, gen)
        ok &= all(v for k, v in checked.items() if k.endswith("_same"))
        print(json.dumps({"tree": tree, **checked}), flush=True)
        row = {**time_tree(tree, sizes, gen), **checked}
        result["trees"].append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
