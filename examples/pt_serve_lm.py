"""Serving example of the PyTorch port: batched requests through prefill and
KV-cache decode (``examples/serve_lm.py``).

    PYTHONPATH=src python examples/pt_serve_lm.py --arch gemma2-27b [--device cpu]

Uses the smoke variant of the selected arch (random weights, seed 0).
Shows the ``RequestBatcher`` packing variable-length prompts into one
shape and greedy decode over the rolling/sliding-window caches; the VLM
(``llama-3.2-vision-90b``) also takes a seeded vision input for its cross
layers. Runs on the card unless ``--device cpu`` is given.
"""

import argparse

import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.serve.decode import RequestBatcher, generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b", choices=list(registry.ARCH_IDS))
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None, help="cpu; default: the card")
    args = ap.parse_args()

    dev = device_lib.resolve(args.device)
    cfg = registry.get_smoke(args.arch)
    print(f"serving {cfg.name} ({cfg.num_params() / 1e6:.1f}M params, "
          f"pattern={cfg.pattern}) on {dev.type}")
    model = T.init(cfg, seed=0, device=dev)

    batcher = RequestBatcher(batch_size=4, seq_len=16)
    requests = [
        [3, 1, 4, 1, 5, 9, 2, 6],
        [2, 7, 1, 8],
        [1, 1, 2, 3, 5, 8, 13],
    ]
    prompts, lens, n = batcher.pack(requests, device=dev)

    vision = None
    if cfg.vision_tokens:
        vision = torch.randn((4, cfg.vision_tokens, cfg.cross_kv_dim),
                             generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    toks = generate(model, prompts, cfg, max_new_tokens=args.new_tokens, vision=vision)
    for i, out in enumerate(batcher.unpack(toks, n)):
        print(f"request {i}: prompt={requests[i]} -> generated={out}")


if __name__ == "__main__":
    main()
