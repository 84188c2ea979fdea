"""Attention inputs whose answer lives in the low mantissa bits that one
TF32 product drops.

Shared by the CPU emulation test of the fp32 flash kernel's arithmetic
(tests/test_torch_attention.py) and its card test (tests/test_torch_cuda.py),
with the TF32 split that the emulations of the fp32 forward and backward
(tests/test_torch_flash_bwd.py) take their products through.
"""

import torch

SCALE = 1 / 16   # a power of two, so q * scale is exact


def low_bit_qkv(seed: int, b: int = 2, s: int = 300, h: int = 2, hkv: int = 1,
                d: int = 128):
    """fp32 (q, k, v) on the CPU, causal attention at ``SCALE``:

    - q = 1000 (1 + a 2^-15), a < 4 (one vector a (batch, head));
    - k = +-(1 + b 2^-15), b < 4, with as many + as - signs in each key, so
      the high parts' logit q_hi . k_hi is exactly 0 and every key's logit
      is hi.lo + lo.hi (a few hundredths each);
    - v = V_j (1 + e 2^-15), e < 4, where the integer V_j in [200, 1800]
      follows key j's logit over its query heads.

    Every TF32 product of the split operands is then exact, and a kernel
    that drops the hi.lo or the lo.hi product of either matmul moves the
    output by 9x to 1000x the fp32 bound 1e-5 + 1e-5 |ref|. (The plain fp32
    version, whose products round, misses that bound here by up to 3x.)
    """
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    a = torch.randint(0, 4, (b, 1, h, d), generator=g).to(f64)
    q = (1000 * (1 + a * 2.0 ** -15)).expand(b, s, h, d)
    sign = (torch.rand(b, s, hkv, d, generator=g).argsort(-1) < d // 2).to(f64) * 2 - 1
    k = sign * (1 + torch.randint(0, 4, (b, s, hkv, d), generator=g).to(f64) * 2.0 ** -15)
    group = h // hkv
    logit = torch.einsum("bhd,bkhd->bkh", q[:, 0] * SCALE, k.repeat_interleave(group, 2))
    z = logit.reshape(b, s, hkv, group).sum(-1)
    z = (z - z.mean(1, keepdim=True)) / z.std(1, keepdim=True)
    big = (1000 + 400 * z).round().clamp(200, 1800)
    e = torch.randint(0, 4, (b, s, hkv, d), generator=g).to(f64)
    v = big[..., None] * (1 + e * 2.0 ** -15)
    return tuple(x.float().contiguous() for x in (q, k, v))


def tf32_round(x):
    """x rounded to the nearest TF32, ties away from zero, its low 13
    mantissa bits cleared in the int32 view, as the kernel does."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


THREE = ("hi.hi", "hi.lo", "lo.hi")


def tf32_product(eq, a, b, terms):
    """einsum(eq, a, b) as the fp32 kernel takes it on the tensor cores: the
    sum, in fp32, of the TF32 products in ``terms`` of the split operands
    (hi = x rounded to TF32, so hi + lo == x exactly for lo = x - hi, which
    is then rounded to TF32 itself; "one": a single product of a and b
    rounded to TF32). Each product of two TF32 values is exact in fp32."""
    if terms == ("one",):
        return torch.einsum(eq, tf32_round(a), tf32_round(b))
    ah, bh = tf32_round(a), tf32_round(b)
    part = {"hi.hi": (ah, bh), "hi.lo": (ah, tf32_round(b - bh)),
            "lo.hi": (tf32_round(a - ah), bh)}
    out = torch.einsum(eq, *part[terms[0]])
    for t in terms[1:]:
        out = out + torch.einsum(eq, *part[t])
    return out
