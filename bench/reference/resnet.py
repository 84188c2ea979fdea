"""Plain ResNet-50 v1.5 (He et al., arXiv:1512.03385; v1.5 puts the stride in
the 3x3 conv) in float32, written from the paper's description and the
configuration file, with no code of the program under test.

Parameters are the flat ``{name: tensor}`` dict that the benchmark hands to
both sides, named as the program names them (``stages.0.1.conv1.kernel``):
conv kernels OIHW, the head's kernel (in, out). BN normalises with the batch
moments of the whole global batch (the synced BN of every rank is the BN
of their concatenated rows when the ranks hold equal rows), the variance as
E[x^2] - mean^2, without running averages. Convolutions and the max pool
pad as XLA's "SAME" does: at stride 2 on an even size the extra row and
column go last.

``q`` rounds the operands of every convolution and matrix product (the
control's lower precision, ``reference/fp8.py``); None keeps float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.train import smoothed_xent

FAMILY = "resnet"


def _blocks(m: dict):
    """(stage, block, cin, inner, cout, stride) of every bottleneck."""
    cin, width = m["width"], m["width"]
    for s, n in enumerate(m["stage_sizes"]):
        inner = width * 2 ** s
        for b in range(n):
            yield s, b, cin, inner, inner * 4, 2 if s > 0 and b == 0 else 1
            cin = inner * 4


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the program's naming."""
    m = cfg["model"]
    w = m["width"]
    out = {"stem.conv.kernel": (w, 3, 7, 7), "stem.bn.bn_scale": (w,), "stem.bn.bn_bias": (w,)}
    cout = w
    for s, b, cin, inner, cout, _ in _blocks(m):
        pre = f"stages.{s}.{b}."
        for conv, bn, ci, co, k in (("conv1", "bn1", cin, inner, 1),
                                    ("conv2", "bn2", inner, inner, 3),
                                    ("conv3", "bn3", inner, cout, 1)):
            out[pre + conv + ".kernel"] = (co, ci, k, k)
            out[pre + bn + ".bn_scale"] = (co,)
            out[pre + bn + ".bn_bias"] = (co,)
        if cin != cout:
            out[pre + "proj.kernel"] = (cout, cin, 1, 1)
            out[pre + "bn_proj.bn_scale"] = (cout,)
            out[pre + "bn_proj.bn_bias"] = (cout,)
    out["head.kernel"] = (cout, m["num_classes"])
    out["head.bias"] = (m["num_classes"],)
    return out


def init_rule(name: str, shape) -> tuple[str, float]:
    """The model's initialisation (He et al., and the paper's §3.2): He
    fan-in normal kernels, zero biases, BN gamma 1 but 0 on the last BN of
    each residual block, so that each block starts as its shortcut. (With
    every gamma at 1 the first gradient of the early layers explodes, and
    any rounding moves their norms by a fifth or more.) ("normal", std) or
    ("const", value)."""
    if name.endswith("bn_scale"):
        return "const", 0.0 if ".bn3." in name else 1.0
    if name.endswith("bias"):
        return "const", 0.0
    fan_in = shape[1] * shape[2] * shape[3] if len(shape) == 4 else shape[0]
    return "normal", (2.0 / fan_in) ** 0.5


def lars_groups(names, cfg: dict):
    """One LARS group a leaf: [(names, takes the trust ratio)]."""
    tags = cfg["recipe"]["lars"]["skip_tags"]
    return [((n,), not any(t in n.replace(".", "/").lower() for t in tags)) for n in names]


def _same(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad(x, k: int, stride: int, value: float = 0.0):
    ph, pw = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _conv(x, w, stride: int, q):
    if q is not None:
        x, w = q(x), q(w)
    return F.conv2d(_pad(x, w.shape[2], stride), w, stride=stride)


def _bn(x, scale, bias, eps: float):
    mean = x.mean((0, 2, 3))
    var = (x * x).mean((0, 2, 3)) - mean * mean
    inv = torch.rsqrt(var + eps) * scale
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + bias[None, :, None, None]


def logits(p: dict, images: torch.Tensor, cfg: dict, q=None) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, classes), float32."""
    m = cfg["model"]
    eps = m["bn_eps"]
    x = images.float().permute(0, 3, 1, 2)
    x = _conv(x, p["stem.conv.kernel"], 2, q)
    x = F.relu(_bn(x, p["stem.bn.bn_scale"], p["stem.bn.bn_bias"], eps))
    x = F.max_pool2d(_pad(x, 3, 2, float("-inf")), 3, 2)
    for s, b, cin, _, cout, stride in _blocks(m):
        pre = f"stages.{s}.{b}."

        def cbn(h, conv, bn, st):
            h = _conv(h, p[pre + conv + ".kernel"], st, q)
            return _bn(h, p[pre + bn + ".bn_scale"], p[pre + bn + ".bn_bias"], eps)

        h = F.relu(cbn(x, "conv1", "bn1", 1))
        h = F.relu(cbn(h, "conv2", "bn2", stride))
        h = cbn(h, "conv3", "bn3", 1)
        sc = cbn(x, "proj", "bn_proj", stride) if cin != cout else x
        x = F.relu(h + sc)
    pooled = x.mean((2, 3))
    w = p["head.kernel"]
    if q is not None:
        pooled, w = q(pooled), q(w)
    return pooled @ w + p["head.bias"]


def loss(p: dict, batch, cfg: dict, q=None) -> torch.Tensor:
    """The mean label-smoothed cross-entropy of the batch (images, labels)."""
    images, labels = batch
    return smoothed_xent(logits(p, images, cfg, q), labels,
                         cfg["recipe"]["label_smoothing"]).mean()
