"""The dry run's cost, fitted from one and two blocks
(``repro/launch/cost_extrapolate.py``), and here a check that it is linear.

The reference needs the fit: XLA's ``cost_analysis`` (and its HLO text)
count a ``lax.scan`` body once, so it lowers the same step with
n_blocks = 1 and = 2, unrolled (``_cost_cfg``), and scales

    body  = cost(2) - cost(1)
    total = cost(1) + body * (n_blocks - 1)

The port's dry run counts every layer already (``FlopCounterMode`` and
``hlo_stats.Recorder`` see each op the step runs), so the fit is no
correction here but a check of linearity: ``cost_true.flops`` must equal
the full run's ``cost.flops``, and the fitted collective bytes its
``collectives``, within ``LINEAR_RTOL`` (the bytes accessed are compared
and reported, not held). Where they do not, the step's cost a block is
not uniform: a ``gathered`` site that fires in one block and not
another; a gradient leaf that the sync exchanges another way once it is
stacked over all blocks (the full run's leaves are the reference's
stacked ones, the fit's one a layer, as ``scan_blocks=False`` gives); a
remat unit that is a block of several layers in the full run and a layer
in the fit (``torch.utils.checkpoint`` stops a unit's recompute after the
last tensor its backward needs, so where the units end moves the count);
or a first block that differs from the rest. Each such case is printed
and written into the artifact's ``cost_true.linear``, not hidden.

The fit takes the steps from ``launch/dryrun.py``'s ``build_train``,
``build_prefill`` and ``build_decode`` on the same mesh and merges
``cost_true`` into each artifact of ``experiments/dryrun_torch/`` under
the reference's keys: ``flops``, ``bytes_accessed``, ``coll_total``,
``coll_f32``, ``coll_wire``, ``coll_wire_f32``, each also with
``_body``, and ``n_blocks``.

    PYTHONPATH=src python -m repro_torch.launch.cost_extrapolate [--only <arch>] [--force]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.models import transformer as T

#: how far the fit may lie from the full count, relative, before the
#: combination is reported as not linear in its blocks
LINEAR_RTOL = 1e-3
#: the fitted keys beside the full run's count: the FLOPs and collective
#: bytes are held to ``LINEAR_RTOL``; the bytes accessed are reported
_COMPARED = {"flops": ("cost", "flops"), "coll_total": ("collectives", "total_bytes"),
             "coll_wire": ("collectives", "total_wire_bytes"),
             "bytes_accessed": ("cost", "bytes_accessed")}
_HELD = ("flops", "coll_total", "coll_wire")


def _cost_cfg(cfg: T.ArchConfig, k_blocks: int, seq_len: int) -> T.ArchConfig:
    """The reference's config of ``k_blocks`` blocks, unrolled, field for field."""
    n_layers = cfg.n_prefix + k_blocks * len(cfg.pattern)
    return dataclasses.replace(cfg, n_layers=n_layers, scan_blocks=False,
                               q_chunk_unroll=True, ssm_unroll=True)


def _extract(m: dict) -> dict:
    """The reference's cost terms of one ``dryrun.measure`` result."""
    coll = hlo_stats.collective_stats(m["recorder"])
    return {
        "flops": float(m["flops"]),
        "bytes_accessed": float(m["bytes_accessed"]),
        "coll_total": float(coll["total_bytes"]),
        "coll_f32": float(coll["by_dtype"].get("f32", 0)),
        "coll_wire": float(coll["total_wire_bytes"]),
        "coll_wire_f32": float(coll["wire_by_dtype"].get("f32", 0)),
    }


def build(arch_id: str, cfg: T.ArchConfig, shape, mesh):
    """``(step, args)`` of ``shape``'s step for ``cfg`` on ``mesh``."""
    if shape.step == "train":
        fn, args, _ = dryrun.build_train(arch_id, cfg, shape, mesh)
    elif shape.step == "prefill":
        fn, args = dryrun.build_prefill(arch_id, cfg, shape, mesh)
    else:
        fn, args = dryrun.build_decode(arch_id, cfg, shape, mesh)
    return fn, args


def fit(costs: dict, n_blocks: int) -> dict:
    """The reference's fit of ``{1: cost(1), 2: cost(2)}`` to ``n_blocks``."""
    out = {}
    for key in costs[1]:
        body = costs[2][key] - costs[1][key]
        out[key] = costs[1][key] + body * (n_blocks - 1)
        out[f"{key}_body"] = body
    out["n_blocks"] = n_blocks
    return out


def extrapolate(arch_id: str, shape_name: str, multi_pod: bool,
                mesh_shape: dict | None = None, smoke_arch: bool = False) -> dict:
    """``cost_true`` of one combination: its step at 1 and 2 blocks on the
    same mesh (``mesh_shape`` and ``smoke_arch`` as ``dryrun.run_one``'s)."""
    shape = SHAPES[shape_name]
    base_cfg = dryrun.arch_for(arch_id, shape, smoke_arch)
    costs = {}
    for k in (1, 2):
        with dryrun.fake_world(dryrun.world_of(multi_pod, mesh_shape)):
            mesh, _ = dryrun._mesh(multi_pod, mesh_shape)
            fn, args = build(arch_id, _cost_cfg(base_cfg, k, shape.seq_len), shape, mesh)
            costs[k] = _extract(dryrun.measure(fn, args))
    return fit(costs, base_cfg.n_blocks)


def linearity(rec: dict, ct: dict) -> dict:
    """The fit against the full run's count: the relative difference of
    each ``_COMPARED`` key, and whether the FLOPs' and the collective
    bytes' lie within ``LINEAR_RTOL``."""
    diffs = {}
    for key, (sect, field) in _COMPARED.items():
        full = rec[sect][field]
        diffs[key] = (ct[key] - full) / full if full else float(ct[key] != 0)
    return {"rel_diff": diffs, "ok": all(abs(diffs[k]) <= LINEAR_RTOL for k in _HELD),
            "gathered": rec.get("gathered") or {}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="arch substring filter")
    ap.add_argument("--dir", default=dryrun.OUT_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    nonlinear = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "arch" not in rec or "cost" not in rec:       # not a combination's artifact
            continue
        if args.only and args.only not in rec["arch"]:
            continue
        if "cost_true" in rec and not args.force:
            print(f"[skip] {os.path.basename(path)}")
            continue
        try:
            ct = extrapolate(rec["arch"], rec["shape"], rec["mesh"] == "pod2x16x16")
        except Exception as e:  # noqa: BLE001 -- reported, the others go on
            print(f"[fail] {os.path.basename(path)}: {e!r}")
            nonlinear.append(os.path.basename(path))
            continue
        ct["linear"] = linearity(rec, ct)
        rec["cost_true"] = ct
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        lin = ct["linear"]
        diffs = " ".join(f"{k} {v:+.2e}" for k, v in lin["rel_diff"].items())
        print(f"[{'ok' if lin['ok'] else 'NONLINEAR'}] {os.path.basename(path)} flops "
              f"{rec['cost']['flops']:.4e} -> {ct['flops']:.4e}; fit - full, relative: {diffs}"
              + ("" if lin["ok"] else f"; held whole {lin['gathered']}"))
        if not lin["ok"]:
            nonlinear.append(os.path.basename(path))
    print(f"cost_extrapolate: {len(nonlinear)} not linear within {LINEAR_RTOL:g} "
          f"(or failed): {nonlinear}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
