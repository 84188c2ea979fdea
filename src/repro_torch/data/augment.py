"""Image augmentation on the device (paper §3.2 lists NNL's pipeline:
padding, scaling, rotations, resizing, distortion, flipping, brightness
adjustment, contrast adjustment, and noising).

Every op is batched (B, H, W, C). The ``random_*`` ops draw from a
``torch.Generator`` on the images' device; the geometric group is one
affine resample (bilinear gather) whose matrices ``affine_matrices`` builds
from explicit draws, so tests can feed both packages the same draws.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def random_flip(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    flip = torch.rand(images.shape[0], generator=gen, device=gen.device) < 0.5
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_brightness(gen, images, max_delta=0.2):
    return images + _uniform(gen, (images.shape[0], 1, 1, 1), -max_delta, max_delta)


def random_contrast(gen, images, lower=0.8, upper=1.2):
    f = _uniform(gen, (images.shape[0], 1, 1, 1), lower, upper)
    mean = images.mean(dim=(1, 2), keepdim=True)
    return (images - mean) * f + mean


def random_noise(gen, images, std=0.02):
    return images + std * torch.randn(images.shape, generator=gen,
                                      device=gen.device, dtype=images.dtype)


def affine_resample(images: torch.Tensor, mats: torch.Tensor,
                    out_hw) -> torch.Tensor:
    """Batched affine warp with bilinear sampling.

    mats: (B, 2, 3) mapping output pixel coords -> input coords.
    """
    B, H, W, C = images.shape
    oh, ow = out_hw
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([ys.reshape(-1), xs.reshape(-1),
                        torch.ones(oh * ow, device=dev)], 0)       # (3, P)
    src = torch.einsum("bij,jp->bip", mats, grid)                   # (B,2,P)
    sy, sx = src[:, 0], src[:, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    flat = images.reshape(B, H * W, C)

    def gather(yi, xi):
        yc = yi.long().clamp(0, H - 1)
        xc = xi.long().clamp(0, W - 1)
        idx = (yc * W + xc).unsqueeze(-1).expand(B, oh * ow, C)
        return torch.gather(flat, 1, idx)

    out = (gather(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + gather(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + gather(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + gather(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    return out.reshape(B, oh, ow, C)


def affine_matrices(angles_deg, scales, shifts, in_hw, out_hw) -> torch.Tensor:
    """(B, 2, 3) out->in maps: rotate/scale about the centre, then shift.

    shifts: (B, 2) in pixels (y, x).
    """
    H, W = in_hw
    oh, ow = out_hw
    ang = angles_deg * (math.pi / 180.0)
    cos, sin = torch.cos(ang) / scales, torch.sin(ang) / scales
    cy, cx = (H - 1) / 2, (W - 1) / 2
    ocy, ocx = (oh - 1) / 2, (ow - 1) / 2
    return torch.stack([
        torch.stack([cos, -sin, cy - cos * ocy + sin * ocx + shifts[:, 0]], 1),
        torch.stack([sin, cos, cx - sin * ocy - cos * ocx + shifts[:, 1]], 1),
    ], 1)


def random_affine(gen, images, out_hw=None, max_rot=15.0, scale=(0.7, 1.3),
                  max_shift=0.1):
    """Rotation + scale + shift ('rotations, scaling, distortion, resizing')
    in one bilinear resample."""
    B, H, W, _ = images.shape
    out_hw = out_hw or (H, W)
    ang = _uniform(gen, (B,), -max_rot, max_rot)
    sc = _uniform(gen, (B,), scale[0], scale[1])
    shift = _uniform(gen, (B, 2), -max_shift, max_shift) * torch.tensor(
        [H, W], dtype=torch.float32, device=images.device)
    return affine_resample(images, affine_matrices(ang, sc, shift, (H, W), out_hw),
                           out_hw)


def augment(gen: torch.Generator, images: torch.Tensor, out_hw=(224, 224)):
    """The paper's full augmentation stack, fused order: geometric ->
    flip -> photometric -> noise."""
    x = random_affine(gen, images, out_hw)
    x = random_flip(gen, x)
    x = random_brightness(gen, x)
    x = random_contrast(gen, x)
    return random_noise(gen, x)
