"""ResNet-50 (He et al. [7]), v1.5 bottleneck, as ``repro/models/resnet.py``:

- He fan-in init; the last BN gamma of every residual block is zero-init.
- BN "without moving average": train-time batch statistics; eval
  statistics come from a calibration pass (``collect_stats``).
- Mixed precision: params are fp32 masters, fwd/bwd runs in
  ``compute_dtype``; the head runs in fp32 from the fp32 masters.

Module names are the JAX package's parameter paths with "." for "/"
(``stages.0.1.conv1.kernel`` is ``stages/0/1/conv1/kernel``), so LARS skip
tags match the same leaves. Images come in as (B, H, W, 3) and logits go
out as (B, num_classes), the JAX layout; inside, activations are NCHW with
channels-last strides.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch import device as device_lib
from repro_torch.nn import layers as L


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)      # ResNet-50
    width: int = 64
    num_classes: int = 1000
    compute_dtype: torch.dtype = torch.bfloat16
    image_size: int = 224

    @staticmethod
    def resnet50(**kw):
        return ResNetConfig(**kw)

    @staticmethod
    def tiny(**kw):
        """Reduced variant for CPU tests: 2 stages x 1 block, width 8."""
        kw.setdefault("stage_sizes", (1, 1))
        kw.setdefault("width", 8)
        kw.setdefault("num_classes", 10)
        kw.setdefault("image_size", 32)
        return ResNetConfig(**kw)


class Stem(nn.Module):
    def __init__(self, gen: torch.Generator, width: int):
        super().__init__()
        self.conv = L.Conv(gen, 7, 7, 3, width, stride=2)
        self.bn = L.BatchNorm(width, device=gen.device)


class Bottleneck(nn.Module):
    def __init__(self, gen: torch.Generator, cin: int, inner: int, cout: int,
                 stride: int):
        super().__init__()
        dev = gen.device
        self.conv1 = L.Conv(gen, 1, 1, cin, inner)
        self.bn1 = L.BatchNorm(inner, device=dev)
        self.conv2 = L.Conv(gen, 3, 3, inner, inner, stride=stride)  # v1.5
        self.bn2 = L.BatchNorm(inner, device=dev)
        self.conv3 = L.Conv(gen, 1, 1, inner, cout)
        self.bn3 = L.BatchNorm(cout, device=dev, zero_gamma=True)
        if cin != cout:
            self.proj = L.Conv(gen, 1, 1, cin, cout, stride=stride)
            self.bn_proj = L.BatchNorm(cout, device=dev)

    def forward(self, x, stats=None, collect=False):
        sts = {}

        def bn(name, h):
            st = None if stats is None else stats[name]
            out = getattr(self, name)(h, stats=st, return_stats=collect)
            if collect:
                out, sts[name] = out
            return out

        h = F.relu(bn("bn1", self.conv1(x)))
        h = F.relu(bn("bn2", self.conv2(h)))
        h = bn("bn3", self.conv3(h))
        sc = bn("bn_proj", self.proj(x)) if hasattr(self, "proj") else x
        out = F.relu(h + sc)
        return (out, sts) if collect else out


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.stem = Stem(gen, cfg.width)
        self.stages = nn.ModuleList()
        cin = cfg.width
        for s, nblocks in enumerate(cfg.stage_sizes):
            inner = cfg.width * (2 ** s)
            cout = inner * 4
            blocks = nn.ModuleList()
            for b in range(nblocks):
                stride = 2 if (s > 0 and b == 0) else 1
                blocks.append(Bottleneck(gen, cin, inner, cout, stride))
                cin = cout
            self.stages.append(blocks)
        self.head = L.Dense(gen, cin, cfg.num_classes)

    def forward(self, images: torch.Tensor, stats=None,
                collect_stats: bool = False):
        """images: (B, H, W, 3) -> logits (B, K) fp32.

        ``stats``: per-BN (mean, var) for eval, nested as the JAX package's
        ``{"stem": {"bn": ...}, "stages": [[{"bn1": ...}, ...], ...]}``;
        ``collect_stats`` returns (logits, stats) -- the calibration pass.
        """
        x = images.to(self.cfg.compute_dtype).permute(0, 3, 1, 2)
        all_stats = {"stem": {}, "stages": []}

        st = None if stats is None else stats["stem"].get("bn")
        out = self.stem.bn(self.stem.conv(x), stats=st,
                           return_stats=collect_stats)
        if collect_stats:
            out, all_stats["stem"]["bn"] = out
        h = L.max_pool(F.relu(out), 3, 2)

        for si, blocks in enumerate(self.stages):
            stage_stats = []
            for bi, block in enumerate(blocks):
                bst = None if stats is None else stats["stages"][si][bi]
                out = block(h, stats=bst, collect=collect_stats)
                if collect_stats:
                    h, s = out
                    stage_stats.append(s)
                else:
                    h = out
            all_stats["stages"].append(stage_stats)

        logits = self.head(L.global_avg_pool(h).float())
        return (logits, all_stats) if collect_stats else logits


def init(cfg: ResNetConfig, *, seed: int = 0, device=None) -> ResNet:
    """A ResNet with fresh fp32 weights drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device_lib.resolve(device))
    gen.manual_seed(seed)
    return ResNet(cfg, gen)


def apply(model: ResNet, images: torch.Tensor, *, params=None, stats=None,
          collect_stats: bool = False):
    """``model(images)``, or with ``params`` ({name: tensor}) in place of
    the module's own -- the functional form the train step differentiates."""
    kwargs = {"stats": stats, "collect_stats": collect_stats}
    if params is None:
        return model(images, **kwargs)
    return functional_call(model, params, (images,), kwargs)


def num_params(params) -> int:
    """Element count of a model or of a {name: tensor} dict."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return sum(p.numel() for p in params.values())
