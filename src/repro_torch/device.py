"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    With no device given and no CUDA card present this raises instead of
    drifting to the CPU: a run meant for the card never silently trains
    on the host. Pass ``device="cpu"`` to run the plain versions on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
