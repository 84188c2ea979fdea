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

It also holds the kernel's output to ``ref.flash_attention_tol`` (fp32:
against the exact answer, the plain version in fp64) and reports the worst
err/tol; at ``ACCURACY``'s large-logit fp32 inputs it reports the kernel's
and the fp32 plain version's err/tol against the exact answer, and the
kernel's against the plain version. Device times come from CUDA-graph
replay, eager times include the host's launch. Prints one JSON line a shape and the
card's name and power limit; ``--out`` writes them as one JSON file. Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attn import flash_attention_f32, flash_attention_tc
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
WRAPPERS = {"flash_attn": flash_attention_tc, "flash_attn_f32": flash_attention_f32}
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"gpu": card, "torch": torch.__version__, "shapes": []}
    for name, shape, dtype, masks, what in SHAPES + tuple(
            ("flash_attn", shape, torch.bfloat16, masks, what)
            for shape, masks, what in SERVE_SHAPES):
        t = {"kernel": name, **time_flash(name, shape, dtype, masks, what, gen)}
        result["shapes"].append(t)
        print(json.dumps(t))
    result["accuracy"] = accuracy(gen)
    for row in result["accuracy"]:
        print(json.dumps(row))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
