"""Input shapes of the zoo and the step kind each one drives, as
``repro/configs/shapes.py``.

  train_4k     seq 4,096    global_batch 256   -> train step
  prefill_32k  seq 32,768   global_batch 32    -> prefill
  decode_32k   seq 32,768   global_batch 128   -> serve step (1 token + KV)
  long_500k    seq 524,288  global_batch 1     -> serve step

``long_500k`` needs sub-quadratic context handling: SSM archs run natively;
attention archs run the *long-context variant*, where global attention
layers become sliding-window (window <= 32k).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

LONG_WINDOW = 32_768


def long_context_variant(cfg: ArchConfig) -> ArchConfig:
    """Sliding-window variant for the 500k decode shape.

    Global attention layers become local with window min(32k, existing).
    SSM/RG-LRU layers are untouched (already O(1)-state). Archs that already
    have a window (gemma2 local layers: 4096) keep it.
    """
    if all(k in ("ssd", "rglru") for k in cfg.pattern):
        return cfg                              # pure SSM: natively linear
    pattern = tuple("local" if k == "attn" else k for k in cfg.pattern)
    window = cfg.window or LONG_WINDOW
    return dataclasses.replace(cfg, pattern=pattern, window=window)


def needs_long_variant(cfg: ArchConfig) -> bool:
    return any(k == "attn" for k in cfg.pattern)
