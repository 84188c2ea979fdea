"""Per-mesh fabric constants and bucket-size defaults
(``repro/configs/comm.py``).

The bucket autotuner (``core/autotune.py``) needs three constants a
fabric: link bandwidth, per-step latency and the backward pass's wall time
that the exchange overlaps. The reference keeps them here for its
production meshes, as the paper's TPU-pod targets. None of those is an
H100 number, and no fabric of the port has been measured (no run has used
more than one card), so ``HW_BY_MESH`` starts empty: ``hw_for_mesh`` and
``bucket_bytes="auto"`` take the constants from the caller and raise
without them, naming what to pass. A measured fabric goes into
``HW_BY_MESH`` under its mesh's name, beside the script that measured it.

``default_bucket_bytes`` is the reference's: ``"auto"`` for every arch the
manual gradient sync runs, ``0`` for FSDP archs, whose collectives follow
from their shardings and never reach a sync.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.autotune import HardwareModel

#: Measured fabric constants by mesh name ("pod16x16", "pod2x16x16"): none yet.
HW_BY_MESH: dict[str, HardwareModel] = {}


def mesh_name(mesh) -> str:
    """"pod2x16x16" for a mesh with a ``pod`` dim, else "pod16x16" (the
    reference's two production meshes); a name passes through."""
    if isinstance(mesh, str):
        return mesh
    return "pod2x16x16" if "pod" in (mesh.mesh_dim_names or ()) else "pod16x16"


def hw_for_mesh(mesh, backward_seconds: float | None = None,
                hw: HardwareModel | None = None) -> HardwareModel:
    """The ``HardwareModel`` of a mesh (a ``DeviceMesh`` or its name):
    ``hw`` when given, else the measured constants in ``HW_BY_MESH``.
    ``backward_seconds`` replaces the overlap window. Raises when neither
    exists: the port has no fabric to default to."""
    name = mesh_name(mesh)
    hw = hw if hw is not None else HW_BY_MESH.get(name)
    if hw is None:
        raise ValueError(
            f"no measured fabric constants for mesh {name!r}: pass hw=autotune."
            "HardwareModel(link_bw=<bytes/s a link>, latency_s=<s a ring step>, "
            "backward_seconds=<s>, name=...) (the reference's are a TPU pod's "
            "and do not hold for the H100)")
    if backward_seconds is not None:
        hw = dataclasses.replace(hw, backward_seconds=backward_seconds)
    return hw


def backward_seconds_estimate(step_flops: float, n_chips: int,
                              peak_flops_per_chip: float, mfu: float) -> float:
    """Rough backward wall time from a step's FLOPs: backward is ~2/3 of a
    train step's (forward + 2x in backward), over the fleet's realised rate
    (peak times an assumed MFU). Both rates are the caller's: the
    reference's 90 TFLOP/s and 0.4 are a TPU chip's."""
    if step_flops <= 0 or n_chips <= 0:
        raise ValueError(f"need step_flops > 0 and n_chips > 0, got {step_flops}, "
                         f"{n_chips}")
    return (2.0 / 3.0) * step_flops / (n_chips * peak_flops_per_chip * mfu)


def default_bucket_bytes(arch_id: str, fsdp: bool = False) -> int | str:
    """``GradSyncConfig.bucket_bytes`` by arch: ``"auto"`` for every
    manually synced arch, ``0`` for FSDP archs (no manual sync)."""
    return 0 if fsdp else "auto"
