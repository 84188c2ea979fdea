"""The chip's published peaks (NVIDIA's H100 SXM data sheet, dense, at its
700 W limit), by the name the card reports. A card not listed has no peak,
and a share of it is not reported."""

from __future__ import annotations

PEAKS = {
    "H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str) -> dict | None:
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None
