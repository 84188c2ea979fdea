"""Serving: batched prefill, then autoregressive decode over the KV cache,
as ``repro/serve/decode.py``.

``make_serve_step`` builds the one-token step. ``generate`` runs a full
prefill-then-decode loop (greedy, or temperature sampling from a
``torch.Generator``). ``RequestBatcher`` left-pads prompts into one fixed
(batch, seq) shape.

Prefill attention runs the flash kernel on the card, one launch an
attention or cross layer (28 a prefill for Qwen3-1.7B); decode attention
is plain PyTorch, as the JAX package's decode is an einsum outside any
kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models import transformer as T


def make_serve_step(cfg: T.ArchConfig):
    """(params, token (B,1), cache, index) -> (next_token, logits, cache)."""
    def serve_step(params, token, cache, index):
        logits, cache = T.decode_step(params, token, cache, index, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return serve_step


@torch.inference_mode()
def generate(params, prompts: torch.Tensor, cfg: T.ArchConfig, *,
             max_new_tokens: int = 16, vision: torch.Tensor | None = None,
             cache_len: int | None = None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """prompts: (B, S) int on the params' device -> (B, max_new_tokens) int32.
    ``vision`` (B, vision_tokens, cross_kv_dim), on the same device, feeds
    the cross layers' prefill; decode reads their cached k/v.

    The matrices are cast to ``cfg.compute_dtype`` once here, not at each
    use; the cache is bf16 (the JAX default). Greedy at temperature 0;
    otherwise each token is drawn from softmax(logits / temperature) with
    ``generator`` (seeded 0 on the prompts' device when not given).
    """
    B, S = prompts.shape
    cache_len = cache_len or (S + max_new_tokens)
    params = T.compute_params(params, cfg.compute_dtype)
    logits, cache = T.prefill(params, prompts, cfg, vision=vision, cache_len=cache_len)
    step = make_serve_step(cfg)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=prompts.device).manual_seed(0)

    def sample(lg):
        if temperature <= 0.0:
            return torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        probs = torch.softmax(lg[:, -1] / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(torch.int32)

    tok = sample(logits)
    out = [tok]
    for t in range(1, max_new_tokens):
        nxt, logits, cache = step(params, tok, cache, S + t - 1)
        tok = sample(logits) if temperature > 0 else nxt
        out.append(tok)
    return torch.cat(out, dim=1)


@dataclasses.dataclass
class RequestBatcher:
    """Packs variable-length prompts into a fixed (batch, seq) shape.

    The synchronous version of continuous batching: collect up to
    ``batch_size`` requests, left-pad to ``seq_len``, run one ``generate``
    call, slice results back out. As in the JAX package, no padding mask
    goes with the batch: the model attends to the pad tokens.
    """
    batch_size: int
    seq_len: int
    pad_id: int = 0

    def pack(self, prompts: list[list[int]], device=None):
        """-> (tokens (batch, seq) int32, lengths (batch,) int32, n_real),
        on ``device`` (the card unless given)."""
        if len(prompts) > self.batch_size:
            raise ValueError(f"got {len(prompts)} > batch {self.batch_size}")
        dev = device_lib.resolve(device)
        n = len(prompts)
        buf = np.full((self.batch_size, self.seq_len), self.pad_id, np.int32)
        lens = np.zeros((self.batch_size,), np.int32)
        for i, prom in enumerate(prompts):
            prom = prom[-self.seq_len:]
            buf[i, self.seq_len - len(prom):] = prom     # left-pad
            lens[i] = len(prom)
        return torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev), n

    def unpack(self, generated: torch.Tensor, n_real: int) -> list[list[int]]:
        return [generated[i].tolist() for i in range(n_real)]
