"""Time the flash-attention kernels on one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_flash [--out FILE]

At each shape of ``SHAPES`` it times the kernel that ``ops.flash_attention``
picks for the dtype (bf16: ``csrc/flash_attn_tc.cu``, fp32:
``csrc/flash_attn.cu``), and the bf16 kernel at ``SERVE_SHAPES``, the other
archs' serve prefills (granite's, recurrentgemma's windowed MQA at D 256,
the VLM's self and unmasked cross layers), each with its masks, beside:

- its bound (``launch/timing.py:bound``): q, k, v read and o written once
  over 3.35 TB/s, or the operations over the type's peak if larger. bf16:
  989 TFLOP/s. fp32: three TF32 products at 494.7 TFLOP/s (the 3xTF32
  bound, ``bound_ms``), and the fp32 FMA rate of 67 TFLOP/s beside it
  (``fma_bound_ms``);
- its plain version (``kernels/ref.py:flash_attention_ref``);
- ``F.scaled_dot_product_attention(enable_gqa=True)`` on (B, H, S, D)
  copies made beforehand, in the same dtype with TF32 off, ``is_causal``
  for a causal shape (a window of S or more, as recurrentgemma's 2048 at S
  2048, binds nothing), no mask for a cross shape: a yardstick the port
  never calls.

The backward (``csrc/flash_attn_bwd.cu``: bf16 on wgmma at every head dim;
``csrc/flash_attn_bwd_f32.cu``: fp32 in 3xTF32 on wgmma up to D 128, on
FMAs at D 256) is timed at ``BWD_SHAPES`` (Qwen3-1.7B's training shape in
both dtypes, gemma-7b's at D 256 in bf16, the smoke config's in fp32) and,
in bf16, at ``SERVE_SHAPES``, from the forward kernel's o and lse, beside:
its bound (five products of 2 D flops a kept pair, 2.5x the forward's,
over the bf16 peak or, for fp32, three TF32 products over the TF32 peak,
with the fp32 FMA bound beside it; or q, k, v, o, dO, lse read and dq, dk,
dv written over 3.35 TB/s); its plain version
(``ref.flash_attention_bwd_ref``; not measured where its (B, H, S, Skv)
fp32 probabilities pass ``PLAIN_BYTES``); and SDPA's forward + backward
less its forward under autograd, eager (``library_ms``), which the port
never calls. It holds the backward to ``ref.flash_attention_bwd_tol``
(elementwise and normwise) where the plain version ran. ``check_flash_bwd``
is the backward's card check at ``BWD_CHECKS``, which ``chip_smoke.py`` and
``launch/check_bwd_faults.py`` run; ``repeat_flash_bwd`` checks at
``BWD_REPEATS`` that two calls give the same bytes.

It also holds the kernel's output to ``ref.flash_attention_tol`` (fp32:
against the exact answer, the plain version in fp64) and reports the worst
err/tol; at ``ACCURACY``'s large-logit fp32 inputs it reports the kernel's
and the fp32 plain version's err/tol against the exact answer, and the
kernel's against the plain version. Device times come from CUDA-graph
replay, eager times include the host's launch. Prints one JSON line a shape and the
card's name and power limit; ``--out`` writes them as one JSON file;
``--bwd`` times the backward rows only. Needs a CUDA card; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attn import (flash_attention_bwd_bf16, flash_attention_bwd_f32,
                                            flash_attention_cuda, flash_attention_f32,
                                            flash_attention_tc)
from repro_torch.launch.profile_serve import BATCH, SEQ
from repro_torch.launch.profile_step import gpu_line
from repro_torch.launch.timing import (BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, TF32_FLOPS_PER_S,
                                       bound, eager_ms, graph_ms)

# (B, S, Skv, H, Hkv, D)
QWEN = (BATCH, SEQ, SEQ, 16, 8, 128)   # Qwen3-1.7B's prefill at the serve shape
SMOKE = (4, 48, 48, 4, 2, 32)          # the Qwen3 smoke config's prefill
CAUSAL = {"causal": True}
# (kernel, shape, dtype, masks, what)
SHAPES = (("flash_attn", QWEN, torch.bfloat16, CAUSAL, "Qwen3-1.7B prefill"),
          ("flash_attn_f32", QWEN, torch.float32, CAUSAL, "Qwen3-1.7B prefill"),
          ("flash_attn_f32", SMOKE, torch.float32, CAUSAL, "Qwen3 smoke config"))
# the bf16 kernel at the other archs' prefills on the serve shape: (shape,
# masks, what)
SERVE_SHAPES = (
    ((BATCH, SEQ, SEQ, 24, 8, 64), CAUSAL, "granite-moe-3b-a800m prefill"),
    ((BATCH, SEQ, SEQ, 16, 1, 256), {"causal": True, "window": 2048},
     "recurrentgemma-9b local layers' prefill"),
    ((BATCH, SEQ, SEQ, 64, 8, 128), CAUSAL, "llama-3.2-vision-90b self layers' prefill"),
    ((BATCH, SEQ, 1601, 64, 8, 128), {"causal": False},
     "llama-3.2-vision-90b cross layer's prefill over 1601 vision tokens"),
)
WRAPPERS = {"flash_attn": flash_attention_tc, "flash_attn_f32": flash_attention_f32,
            "flash_attn_bwd": flash_attention_bwd_bf16,
            "flash_attn_bwd_f32": flash_attention_bwd_f32}
# the backward on the training path: Qwen3-1.7B at 4 x 2048 tokens a step
# (chip_smoke.py's second batch stage) in both dtypes, gemma-7b's attention
# at 4 x 2048 (D 256, 16/16 heads) in bf16, the smoke config in fp32
TRAIN = (4, 2048, 2048, 16, 8, 128)
GEMMA = (4, 2048, 2048, 16, 16, 256)
BWD_SHAPES = (("flash_attn_bwd", TRAIN, torch.bfloat16, CAUSAL, "Qwen3-1.7B training"),
              ("flash_attn_bwd_f32", TRAIN, torch.float32, CAUSAL, "Qwen3-1.7B training"),
              ("flash_attn_bwd", GEMMA, torch.bfloat16, CAUSAL, "gemma-7b training"),
              ("flash_attn_bwd_f32", SMOKE, torch.float32, CAUSAL, "Qwen3 smoke training"))
PLAIN_BYTES = 4 << 30   # the plain backward's (B, H, S, Skv) fp32 tensors, at most
# the backward's card check (chip_smoke.py, launch/check_bwd_faults.py), both
# dtypes: ((B, S, Skv, H, Hkv, D), masks, q and k's scale, what); fp32 at
# batch 2 at most. The softcap case scales q and k so that |s| reaches the
# cap (1 - tanh^2(s/50) down to ~0.4), or the backward's softcap factor would
# go untested
BWD_CHECKS = (
    (TRAIN, CAUSAL, 1.0, "Qwen3-1.7B training"),
    ((8, 2048, 2048, 16, 8, 128), CAUSAL, 1.0, "Qwen3-1.7B prefill"),
    ((8, 2048, 2048, 24, 8, 64), CAUSAL, 1.0, "granite-moe-3b-a800m prefill"),
    ((2, 4096, 4096, 16, 1, 256), {"causal": True, "window": 2048}, 1.0,
     "recurrentgemma-9b local, window 2048: bands skip"),
    ((2, 2048, 1601, 64, 8, 128), {"causal": False}, 1.0,
     "llama-3.2-vision-90b cross, unmasked (batch 8 cut to 2)"),
    ((2, 1024, 1024, 16, 8, 128), {"causal": True, "softcap": 50.0}, 4.0,
     "softcap 50 (gemma2), q and k x4"),
    ((4, 1024, 1024, 8, 2, 32), {"causal": True, "window": 128}, 1.0,
     "D 32 under a window of 128 (the smoke configs' head dim)"),
)
# the repeat check (chip_smoke.py): two calls on the same inputs give the same
# bytes, at the training shape, granite's GQA prefill (D 64) and
# recurrentgemma's MQA under its window (D 256), both dtypes
BWD_REPEATS = (BWD_CHECKS[0], BWD_CHECKS[2], BWD_CHECKS[3])
# fp32 inputs with large logits (|s| up to ~50): ((B, S, Skv, H, Hkv, D), q and
# k's scale, masks), as the card tests' window/softcap and large-logit cases
ACCURACY = (((2, 300, 300, 4, 2, 128), 3.0, dict(causal=True, window=16)),
            ((2, 333, 290, 4, 1, 256), 2.0, dict(causal=False, softcap=30.0)),
            ((2, 333, 290, 4, 2, 256), 2.0, dict(causal=False, window=64, scale=0.2)))


def _exact(q, k, v, **kw) -> torch.Tensor:
    """What a kernel is held to (``ref.flash_attention_tol``): fp32 inputs'
    exact answer, the plain version in fp64; bf16: the plain version."""
    if q.dtype == torch.float32:
        return ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    return ref.flash_attention_ref(q, k, v, **kw).double()


def accuracy(gen: torch.Generator) -> list[dict]:
    """The fp32 kernel where the logits are large (``ACCURACY``): its worst
    err/tol against the exact answer, the fp32 plain version's own, and the
    kernel's against the fp32 plain version."""
    out = []
    for (b, s, skv, h, hkv, d), mag, kw in ACCURACY:
        q = mag * torch.randn(b, s, h, d, generator=gen, device=gen.device)
        k = mag * torch.randn(b, skv, hkv, d, generator=gen, device=gen.device)
        v = torch.randn(b, skv, hkv, d, generator=gen, device=gen.device)
        exact = _exact(q, k, v, **kw)
        plain = ref.flash_attention_ref(q, k, v, **kw).double()
        got = flash_attention_f32(q, k, v, **kw).double()
        tol = ref.flash_attention_tol(q, k, v, exact, **kw)
        out.append({"at": f"B{b} S{s} Skv{skv} H{h}/{hkv} D{d} fp32, q and k x{mag}, {kw}",
                    **{name: ((x - y).abs() / tol).max().item() for name, x, y in (
                        ("kernel_vs_exact", got, exact), ("plain_vs_exact", plain, exact),
                        ("kernel_vs_plain", got, plain))}})
    return out


def kept_pairs(s: int, skv: int, causal: bool = True, window: int | None = None) -> int:
    """(query, key) pairs a head that the masks keep: query i sees key j < Skv
    with j <= i (causal) and j > i - window (window)."""
    i = torch.arange(s, dtype=torch.int64)
    hi = torch.clamp(i, max=skv - 1) if causal else torch.full_like(i, skv - 1)
    lo = torch.clamp(i - window + 1, min=0) if window is not None else torch.zeros_like(i)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def time_flash(name: str, shape: tuple, dtype: torch.dtype, masks: dict, what: str,
               gen: torch.Generator) -> dict:
    """One kernel at one shape (B, S, Skv, H, Hkv, D) under ``masks``
    (``causal``, ``window``): ms (graph replay), eager ms, bound, plain ms,
    SDPA's ms, and its worst err/tol (``_exact``)."""
    b, s, skv, h, hkv, d = shape
    dev = gen.device
    fn = WRAPPERS[name]
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * h * kept_pairs(s, skv, **masks)
    # SDPA's causal mask is the same function only where no window binds
    assert masks.get("window", s) >= s, masks
    big = s >= 1024
    kw = dict(iters=10, replays=3) if big else dict(iters=50, replays=10)
    want = _exact(q, k, v, **masks)
    err = (fn(q, k, v, **masks).double() - want).abs()
    tol = ref.flash_attention_tol(q, k, v, want, **masks)
    t = {
        "ms": graph_ms(lambda: fn(q, k, v, **masks), **kw),
        "eager_ms": eager_ms(lambda: ops.flash_attention(q, k, v, **masks),
                             iters=kw["iters"]),
        "plain_ms": eager_ms(lambda: ref.flash_attention_ref(q, k, v, **masks),
                             iters=3 if big else 20),
        "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=masks["causal"], enable_gqa=True), **kw),
        "bytes": q.element_size() * (2 * q.numel() + 2 * k.numel()),  # q, k, v in, o out
        "flops": 4 * d * pairs,                    # q.k and p.v, 2 flops a MAC
        "max_abs_err": err.max().item(),
        "worst_err_over_tol": (err / tol).max().item(),
        "at": f"B{b} S{s} Skv{skv} H{h} Hkv{hkv} D{d} {str(dtype)[6:]} "
              f"{', '.join(f'{k}={v}' for k, v in masks.items())} ({what})",
    }
    if dtype == torch.bfloat16:
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], BF16_FLOPS_PER_S)
        t["rate"] = "bf16 tensor cores 989 TFLOP/s, HBM 3.35 TB/s"
    else:
        # 3xTF32: each product is three TF32 products on the tensor cores
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], 3 * t["flops"], TF32_FLOPS_PER_S)
        t["fma_bound_ms"] = bound(t["bytes"], t["flops"], FP32_FLOPS_PER_S)[0]
        t["rate"] = ("3xTF32: 3 products at TF32 494.7 TFLOP/s (fma_bound_ms: fp32 "
                     "67 TFLOP/s), HBM 3.35 TB/s")
    t["tflops_per_s"] = t["flops"] / t["ms"] / 1e9
    t["of_bound"] = t["bound_ms"] / t["ms"]
    del q, k, v, qt, kt, vt, want, err, tol
    torch.cuda.empty_cache()
    return t


def check_flash_bwd(shape: tuple, masks: dict, mag: float, dtype: torch.dtype,
                    gen: torch.Generator) -> dict:
    """The backward kernel for ``dtype`` at one case of ``BWD_CHECKS``, from
    the forward kernel's o and lse, against its plain version (bf16: in
    fp32; fp32: in fp64, the exact answer): per output its max abs error,
    worst err/tol and norm err/limit (``ref.flash_attention_bwd_errors``),
    and the launches its wrapper counted."""
    b, s, skv, h, hkv, d = shape
    b = b if dtype == torch.bfloat16 else min(b, 2)
    dev = gen.device
    fn = WRAPPERS["flash_attn_bwd" if dtype == torch.bfloat16 else "flash_attn_bwd_f32"]
    q = (mag * torch.randn(b, s, h, d, generator=gen, device=dev)).to(dtype)
    k = (mag * torch.randn(b, skv, hkv, d, generator=gen, device=dev)).to(dtype)
    v, do = (torch.randn(*shape_, generator=gen, device=dev).to(dtype)
             for shape_ in ((b, skv, hkv, d), (b, s, h, d)))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **masks)
    before = fn.launches
    got = fn(q, k, v, o, lse, do, **masks)
    launched = fn.launches - before
    if dtype == torch.float32:
        want = ref.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse, do)),
                                           **masks)
    else:
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **masks)
    errors = ref.flash_attention_bwd_errors(got, want, q, k, v, o, lse, do, **masks)
    del q, k, v, do, o, lse, got, want
    torch.cuda.empty_cache()
    return {"at": f"B{b} S{s} Skv{skv} H{h}/{hkv} D{d} {str(dtype)[6:]} "
                  f"{', '.join(f'{k}={v}' for k, v in masks.items())}"
                  + (f", q and k x{mag:g}" if mag != 1 else ""),
            "kernel": fn.__name__, "launches": launched, "errors": errors,
            "max_abs_err": max(e["max_abs_err"] for e in errors),
            "worst_err_over_tol": max(e["err_over_tol"] for e in errors),
            "worst_norm_over_limit": max(e["norm_over_limit"] for e in errors)}


def repeat_flash_bwd(shape: tuple, masks: dict, dtype: torch.dtype,
                     gen: torch.Generator) -> bool:
    """Whether two calls of the backward for ``dtype`` on the same inputs
    (from the forward kernel's o and lse; fp32 at batch 2 at most) give
    equal dq, dk and dv, byte for byte: the kernels take every sum in a
    fixed order and use no float atomics."""
    b, s, skv, h, hkv, d = shape
    b = b if dtype == torch.bfloat16 else min(b, 2)
    dev = gen.device
    fn = WRAPPERS["flash_attn_bwd" if dtype == torch.bfloat16 else "flash_attn_bwd_f32"]
    q, do = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **masks)
    first = fn(q, k, v, o, lse, do, **masks)
    second = fn(q, k, v, o, lse, do, **masks)
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    del q, k, v, do, o, lse, first, second
    torch.cuda.empty_cache()
    return same


def time_flash_bwd(name: str, shape: tuple, dtype: torch.dtype, masks: dict, what: str,
                   gen: torch.Generator) -> dict:
    """The backward at one shape (B, S, Skv, H, Hkv, D) under ``masks``, from
    the forward kernel's o and lse: ms (graph replay), eager ms, bound,
    plain ms, SDPA's backward ms, and its worst err/tol where the plain
    version ran (fp32: against the exact answer, the plain version in fp64)."""
    b, s, skv, h, hkv, d = shape
    dev = gen.device
    fn = WRAPPERS[name]
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **masks)
    pairs = b * h * kept_pairs(s, skv, **masks)
    assert masks.get("window", s) >= s, masks   # SDPA's mask is the same function
    big = s >= 1024
    kw = dict(iters=5, replays=3) if big else dict(iters=50, replays=10)
    call = lambda: fn(q, k, v, o, lse, do, **masks)   # noqa: E731
    t = {"ms": graph_ms(call, **kw), "eager_ms": eager_ms(call, iters=kw["iters"])}
    plain_fits = 4 * b * h * s * skv <= PLAIN_BYTES
    t["plain_ms"] = (eager_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **masks),
                              iters=3 if big else 20) if plain_fits else None)
    # SDPA: forward + backward under autograd, less the forward alone
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=masks["causal"],
                                              enable_gqa=True)
    fwd_bwd = eager_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                       iters=kw["iters"])
    t["library_ms"] = fwd_bwd - eager_ms(sdpa, iters=kw["iters"])
    t["library_fwd_bwd_ms"] = fwd_bwd
    e = q.element_size()
    t["bytes"] = e * 4 * (q.numel() + k.numel()) + 4 * lse.numel()
    t["flops"] = 10 * d * pairs      # five products of 2 D flops a kept pair
    if plain_fits:
        got = call()
        if dtype == torch.float32:
            want = ref.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse, do)),
                                               **masks)
        else:
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **masks)
        errors = ref.flash_attention_bwd_errors(got, want, q, k, v, o, lse, do, **masks)
        t["max_abs_err"] = max(e["max_abs_err"] for e in errors)
        t["worst_err_over_tol"] = max(e["err_over_tol"] for e in errors)
        t["worst_norm_over_limit"] = max(e["norm_over_limit"] for e in errors)
        del got, want
    if dtype == torch.bfloat16:
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], BF16_FLOPS_PER_S)
        t["rate"] = ("bf16 tensor cores 989 TFLOP/s (fma_bound_ms: fp32 67 TFLOP/s), "
                     "HBM 3.35 TB/s")
    else:   # 3xTF32: each product is three TF32 products on the tensor cores
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], 3 * t["flops"], TF32_FLOPS_PER_S)
        t["rate"] = ("3xTF32: 3 products at TF32 494.7 TFLOP/s (fma_bound_ms: fp32 "
                     "67 TFLOP/s), HBM 3.35 TB/s")
    t["fma_bound_ms"] = bound(t["bytes"], t["flops"], FP32_FLOPS_PER_S)[0]
    t["tflops_per_s"] = t["flops"] / t["ms"] / 1e9
    t["of_bound"] = t["bound_ms"] / t["ms"]
    t["at"] = (f"B{b} S{s} Skv{skv} H{h} Hkv{hkv} D{d} {str(dtype)[6:]} "
               f"{', '.join(f'{k}={v}' for k, v in masks.items())} ({what})")
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return t


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward only (BWD_SHAPES and, in bf16, SERVE_SHAPES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"gpu": card, "torch": torch.__version__, "shapes": []}
    for name, shape, dtype, masks, what in () if args.bwd else SHAPES + tuple(
            ("flash_attn", shape, torch.bfloat16, masks, what)
            for shape, masks, what in SERVE_SHAPES):
        t = {"kernel": name, **time_flash(name, shape, dtype, masks, what, gen)}
        result["shapes"].append(t)
        print(json.dumps(t))
    for name, shape, dtype, masks, what in BWD_SHAPES + tuple(
            ("flash_attn_bwd", shape, torch.bfloat16, masks, what)
            for shape, masks, what in SERVE_SHAPES):
        t = {"kernel": name, **time_flash_bwd(name, shape, dtype, masks, what, gen)}
        result["shapes"].append(t)
        print(json.dumps(t))
    result["accuracy"] = [] if args.bwd else accuracy(gen)
    for row in result["accuracy"]:
        print(json.dumps(row))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
