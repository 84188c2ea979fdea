"""``launch/cost_extrapolate.py`` against ``repro/launch/cost_extrapolate.py``,
on torch's ``fake`` process group and meta tensors.

``_cost_cfg`` is the reference's field for field on every arch's config.
The fit of the costs at 1 and 2 blocks equals the full count (the port's
dry run counts every layer) within ``LINEAR_RTOL`` for a train, a prefill
and a decode combination of the smoke configs on small meshes, and the
CLI merges ``cost_true`` with the reference's keys into an artifact.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch.configs import registry
from repro_torch.launch import cost_extrapolate as ce
from repro_torch.launch import dryrun

MESHES = {"1d": {"data": 4, "model": 2}, "2d": {"pod": 2, "data": 2, "model": 2}}
# cost_true's keys in the reference (src/repro/launch/cost_extrapolate.py:44-75)
REF_KEYS = {"flops", "bytes_accessed", "coll_total", "coll_f32", "coll_wire", "coll_wire_f32"}


def _reference():
    """The reference module. Importing it sets ``XLA_FLAGS`` for 512
    devices, which the backend, up already, ignores; the variable is put
    back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import cost_extrapolate as jce
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jce


def _fields(cfg) -> dict:
    """A config's fields, the dtype by name; ``source`` left out: the
    port's configs name the right model where some of the reference's do
    not (ROADMAP, reference-side caveats)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "source"}
    dt = out["compute_dtype"]
    out["compute_dtype"] = (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
                            else np.dtype(dt).name)
    return out


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cost_cfg_is_the_references(arch, k):
    jce = _reference()
    got, want = ce._cost_cfg(registry.get(arch), k, 4096), jce._cost_cfg(jregistry.get(arch),
                                                                          k, 4096)
    assert _fields(got) == _fields(want)
    assert (got.n_prefix, got.n_blocks) == (want.n_prefix, want.n_blocks)


@pytest.mark.parametrize("arch,shape,mesh", [("llama3-405b", "train_4k", "2d"),
                                             ("granite-moe-3b-a800m", "prefill_32k", "1d"),
                                             ("llama3-405b", "decode_32k", "1d")])
def test_fit_equals_the_full_count(arch, shape, mesh):
    """The port counts every layer: the fit from 1 and 2 blocks gives the
    full step's FLOPs and collective bytes within 0.1%."""
    full = dryrun.run_one(arch, shape, False, save=False, quiet=True,
                          mesh_shape=MESHES[mesh], smoke_arch=True)
    ct = ce.extrapolate(arch, shape, False, mesh_shape=MESHES[mesh], smoke_arch=True)
    assert REF_KEYS | {f"{k}_body" for k in REF_KEYS} | {"n_blocks"} == set(ct)
    assert ct["n_blocks"] == dryrun.arch_for(arch, dryrun.SHAPES[shape], True).n_blocks
    lin = ce.linearity(full, ct)
    assert lin["ok"], lin
    assert ct["flops"] > 0 and ct["bytes_accessed"] > 0
    np.testing.assert_allclose(ct["flops"], full["cost"]["flops"], rtol=1e-3)
    np.testing.assert_allclose(ct["coll_total"], full["collectives"]["total_bytes"], rtol=1e-3)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma-7b"])
def test_fit_of_the_manual_sync_is_that_of_per_layer_leaves(arch):
    """A manually synced train step: the fit's FLOPs are the full count's,
    and its collective bytes are exactly those of the full depth with a
    leaf a layer (``scan_blocks=False``, as the fit's configs have); the
    full run exchanges the reference's stacked leaves, which can take
    another exchange mode, so its bytes may differ by a little."""
    shape = dryrun.SHAPES["train_4k"]
    full = dryrun.run_one(arch, "train_4k", False, save=False, quiet=True,
                          mesh_shape=MESHES["2d"], smoke_arch=True)
    cfg = dataclasses.replace(dryrun.arch_for(arch, shape, True), scan_blocks=False)
    with dryrun.fake_world(8):
        mesh, _ = dryrun._mesh(False, MESHES["2d"])
        fn, args, _ = dryrun.build_train(arch, cfg, shape, mesh)
        per_layer = ce._extract(dryrun.measure(fn, args))
    ct = ce.extrapolate(arch, "train_4k", False, mesh_shape=MESHES["2d"], smoke_arch=True)
    assert ct["flops"] == full["cost"]["flops"] > 0
    for key in ("coll_total", "coll_f32", "coll_wire", "coll_wire_f32"):
        np.testing.assert_allclose(ct[key], per_layer[key], rtol=1e-9)


def test_fit_reports_remat_units_that_are_not_layers():
    """recurrentgemma's remat unit is a block of three layers in the full
    run and one layer in the fit (``scan_blocks=False``, as the
    reference's): ``torch.utils.checkpoint`` ends each unit's recompute
    after the last tensor its backward needs, so the fit's FLOPs differ,
    and ``linearity`` says so rather than passing it."""
    full = dryrun.run_one("recurrentgemma-9b", "train_4k", False, save=False, quiet=True,
                          mesh_shape=MESHES["1d"], smoke_arch=True)
    lin = ce.linearity(full, ce.extrapolate("recurrentgemma-9b", "train_4k", False,
                                            mesh_shape=MESHES["1d"], smoke_arch=True))
    assert not lin["ok"] and abs(lin["rel_diff"]["flops"]) > ce.LINEAR_RTOL, lin


def test_main_merges_cost_true_into_the_artifact(tmp_path, capsys):
    """The CLI over a directory of artifacts: Qwen3-1.7B's ``train_4k`` at
    its full width on the 16 x 16 mesh gets ``cost_true`` with the
    reference's keys and a linearity record; a second run skips it."""
    dryrun.run_one("qwen3-1.7b", "train_4k", False, out_dir=str(tmp_path), quiet=True)
    (tmp_path / "notes.json").write_text("[]")       # not an artifact: passed over
    ce.main(["--dir", str(tmp_path), "--only", "qwen3"])
    rec = json.loads((tmp_path / "qwen3-1.7b__train_4k__pod16x16.json").read_text())
    ct = rec["cost_true"]
    assert REF_KEYS <= set(ct) and ct["n_blocks"] == 28
    assert set(ct["linear"]["rel_diff"]) == {"flops", "coll_total", "coll_wire",
                                             "bytes_accessed"}
    assert abs(ct["flops"] / rec["cost"]["flops"] - 1) <= ce.LINEAR_RTOL
    ce.main(["--dir", str(tmp_path)])
    assert "[skip] qwen3-1.7b__train_4k__pod16x16.json" in capsys.readouterr().out
