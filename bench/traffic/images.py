"""Traffic of kind ``images``: a pool of ready global batches of images and
their labels, made on the device from the seed, that ``data_fn`` cycles
through; a step trains its global batch of images.

The images follow the pattern of the program's ``data/synthetic.py``
(copied here, so that no change of the program moves them): each class has
a random low-resolution template, and an image is its class's template
upsampled plus Gaussian noise. The cell's file gives ``pool``, ``noise``
and ``template_downsample``.
"""

from __future__ import annotations

import torch

from bench.harness import data


def pool(cell, seed: int, device, global_batch: int) -> list[tuple]:
    t, m = cell.traffic, cell.config["model"]
    gen = data.generator(device, seed, 1)
    k, size, down = m["num_classes"], m["image_size"], t["template_downsample"]
    templates = torch.randn((k, size // down, size // down, 3), generator=gen, device=device)
    labels = torch.randint(0, k, (t["pool"], global_batch), generator=gen, device=device)
    noise = torch.randn((t["pool"], global_batch, size, size, 3), generator=gen, device=device)
    up = templates[labels].repeat_interleave(down, 2).repeat_interleave(down, 3)
    images = up.add_(noise.mul_(t["noise"]))
    return [(images[i], labels[i]) for i in range(t["pool"])]


def items(traffic: dict, global_batch: int) -> int:
    return global_batch
