"""``configs/comm.py`` against ``repro/configs/comm.py``: the bucket
defaults and the backward estimate (given the rates explicitly) equal the
reference's; with no fabric given, ``hw_for_mesh`` and ``"auto"`` raise
where the reference falls back to its TPU constants."""

import dataclasses

import pytest
import torch

from repro.configs import comm as jcomm
from repro.configs import registry as jregistry
from repro_torch.configs import comm
from repro_torch.core import grad_sync
from repro_torch.core.autotune import HardwareModel
from repro_torch.core.topology import TorusGrid

ARCHS = tuple(jregistry.ARCH_IDS)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_default_bucket_bytes_is_the_reference(arch, fsdp):
    assert comm.default_bucket_bytes(arch, fsdp) == jcomm.default_bucket_bytes(arch, fsdp)


@pytest.mark.parametrize("flops,chips,peak,mfu", [
    (1e15, 256, 90e12, 0.4), (3.7e18, 512, 989e12, 0.35), (5e12, 1, 67e12, 1.0)])
def test_backward_seconds_estimate_is_the_reference(flops, chips, peak, mfu):
    got = comm.backward_seconds_estimate(flops, chips, peak_flops_per_chip=peak, mfu=mfu)
    want = jcomm.backward_seconds_estimate(flops, chips, peak_flops_per_chip=peak, mfu=mfu)
    assert got == want


def test_backward_seconds_estimate_takes_no_default_rate():
    with pytest.raises(TypeError):
        comm.backward_seconds_estimate(1e15, 256)        # no TPU peak to fall back on
    with pytest.raises(ValueError):
        comm.backward_seconds_estimate(0.0, 256, 1e12, 0.4)


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_hw_for_mesh_raises_without_a_fabric(mesh):
    assert comm.HW_BY_MESH == {}
    with pytest.raises(ValueError, match="hw=autotune.HardwareModel"):
        comm.hw_for_mesh(mesh)
    hw = HardwareModel(link_bw=1e11, latency_s=2e-6, backward_seconds=0.1, name="given")
    assert comm.hw_for_mesh(mesh, hw=hw) is hw
    assert comm.hw_for_mesh(mesh, 0.5, hw=hw) == dataclasses.replace(hw, backward_seconds=0.5)


def test_auto_bucket_bytes_raises_without_a_fabric():
    """``"auto"`` resolves against a given fabric and raises with none."""
    cfg = grad_sync.GradSyncConfig(bucket_bytes=grad_sync.AUTO)
    with pytest.raises(ValueError, match="HardwareModel"):
        grad_sync.resolve_sync_config(cfg, TorusGrid(), hw=None)
    hw = HardwareModel(link_bw=1e11, latency_s=2e-6, backward_seconds=0.1, name="given")
    params = {"w": torch.zeros(64, 64), "b": torch.zeros(64)}
    got, events = grad_sync.resolve_sync_config(cfg, TorusGrid(), params_like=params,
                                                hw=comm.hw_for_mesh("pod16x16", hw=hw))
    assert isinstance(got.bucket_bytes, int)
    assert events[-1]["event"] == "bucket_autotune"
