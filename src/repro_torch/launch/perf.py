"""Roofline terms of the dry run's steps under named variants
(``repro/launch/perf.py``): rebuild an (arch x shape) under a variant,
count its FLOPs, bytes and collectives, and turn them into times at the
H100's peaks.

    PYTHONPATH=src python -m repro_torch.launch.perf --list
    PYTHONPATH=src python -m repro_torch.launch.perf --exp sync_strategies --link-bw <bytes/s>

Each experiment returns a list of variant records; ``save`` writes them to
``experiments/perf_torch/<exp>.json`` (never the reference's
``experiments/perf/``). The variants reuse the dry run's step functions
(``launch/dryrun.py``), so their numbers compare with its artifacts. All
four experiments run as the dry run does: one rank's program on torch's
``fake`` process group at 256 or 512 ranks, on meta tensors, in this
process. None of their models fits one H100 (gemma-7b's fp32 weights,
gradients and momentum alone are ~100 GB), so none runs on a card; their
numbers are host counts, and their times what those counts would take at
the card's peaks.

A record's terms, for one rank:
- ``compute_s``: FLOPs (``FlopCounterMode``) over ``PEAK_FLOPS``;
- ``memory_s``: bytes accessed over ``HBM_BW``: the traffic of the port's
  eager program op by op, no fusion credited, the kernels as they move
  their inputs and outputs (``dryrun.py``'s ``cost.bytes_accessed``);
- ``collective_s``: the collectives' wire bytes (a ring's, as the
  reference's ``_wire_bytes``) over the fabric's link bandwidth. No
  fabric of the port has been measured (``configs/comm.py``'s
  ``HW_BY_MESH`` is empty), so it is a flag, ``--link-bw``; a record with
  wire bytes and no fabric raises. On train steps the gradient exchange
  runs in fp32, the reference's host comm dtype (the dry run's
  ``grad_comm_dtype``), so, as the reference does, half of the fp32 wire
  bytes are taken off for the bf16 exchange of a production run;
- ``coll_bytes``, ``coll_counts``, ``temp_gib`` (the peak of the storages
  the step made; ``argument_gib``: its inputs), ``wall_s`` (the host's
  seconds to build and run the step on meta tensors, in place of the
  reference's ``compile_s``), ``dominant`` (the largest term).

The reference fits its costs from 1 and 2 blocks because XLA counts a
scanned body once; the port counts every layer, so a record's terms are
the full count's, and with ``extrapolate`` the fit is kept beside them
as a check (``fit_rel_diff``, ``launch/cost_extrapolate.py``).

``card_step`` makes the same record for the training step that
``chip_smoke.py`` runs on one card (at a 1 x 1 mesh, where a rank's
program is the whole step), to be held against the card's own time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import comm as comm_cfg
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.cost_extrapolate import _cost_cfg, fit
from repro_torch.launch.mesh import cache_pspecs, dp_axes_of, mesh_sizes, with_shardings
from repro_torch.models import transformer as T

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit: the
# rates that PERF.md's kernel bounds use
PEAK_FLOPS = 989.4e12        # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s

OUT_DIR = "experiments/perf_torch"
# the meshes of the experiments, {dim: size}, model last: the production
# pod (16 x 16), two pods, and one pod's data dim as a 4 x 4 torus
POD = {"data": 16, "model": 16}
TWO_PODS = {"pod": 2, "data": 16, "model": 16}
FACTORIZED = {"data_y": 4, "data_x": 4, "model": 16}
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _link_bw(mesh_shape: dict, link_bw: float | None) -> float | None:
    """The fabric's bytes/s a link: ``link_bw``, else the measured fabric of
    the mesh (``configs/comm.py``), else None."""
    if link_bw is not None:
        return link_bw
    hw = comm_cfg.HW_BY_MESH.get("pod2x16x16" if "pod" in mesh_shape else "pod16x16")
    return None if hw is None else hw.link_bw


def _extract_cost(m: dict) -> dict:
    """Cost terms of one ``dryrun.measure`` result, as the reference's."""
    coll = hlo_stats.collective_stats(m["recorder"])
    return {"flops": float(m["flops"]), "bytes": float(m["bytes_accessed"]),
            "coll": float(coll["total_wire_bytes"]),
            "f32": float(coll["wire_by_dtype"].get("f32", 0))}


def _measure(build, *, step: str, label: str, mesh_shape: dict, link_bw: float | None = None,
             n_blocks_pair=None) -> dict:
    """Run ``build(mesh)``'s step (``(fn, args)``) on the fake group of
    ``mesh_shape`` and make its record. ``n_blocks_pair``: ``(build_1,
    build_2, n_blocks)``, the steps at 1 and 2 blocks, fitted to
    ``n_blocks`` and recorded beside the full count."""
    world = dryrun.world_of(False, mesh_shape)
    with dryrun.fake_world(world):
        mesh, _ = dryrun._mesh(False, mesh_shape)
        t0 = time.time()
        fn, args = build(mesh)
        m = dryrun.measure(fn, args)
        wall = time.time() - t0
    coll = hlo_stats.collective_stats(m["recorder"])
    cost = _extract_cost(m)
    flops, bytes_acc, coll_total, f32 = cost["flops"], cost["bytes"], cost["coll"], cost["f32"]
    fit_diff = None
    if n_blocks_pair is not None:
        b1, b2, nb = n_blocks_pair
        costs = {}
        for k, b in ((1, b1), (2, b2)):
            with dryrun.fake_world(world):
                costs[k] = _extract_cost(dryrun.measure(*b(dryrun._mesh(False, mesh_shape)[0])))
        fitted = fit(costs, nb)
        fit_diff = {key: (fitted[key] - cost[key]) / cost[key] if cost[key] else
                    float(fitted[key] != 0) for key in cost}
    if step == "train":
        coll_total -= f32 / 2        # the bf16 exchange of a production run (see dryrun)
    bw = _link_bw(mesh_shape, link_bw)
    if coll_total and bw is None:
        raise ValueError(f"{label}: {coll_total:.4g} wire bytes a rank and no fabric: pass "
                         "--link-bw <bytes/s a link> (link_bw=); no fabric of the port has "
                         "been measured (configs/comm.py HW_BY_MESH)")
    rec = {
        "label": label,
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll_total / bw if coll_total else 0.0,
        "coll_bytes": coll_total,
        "coll_counts": {k: coll[k]["count"] for k in _KINDS},
        "coll_max_bytes": max((op["nbytes"] for op in m["recorder"].collectives), default=0),
        "temp_gib": m["recorder"].peak_bytes / 2**30,
        "argument_gib": m["argument_bytes"] / 2**30,
        "wall_s": round(wall, 1),
        "flops": flops, "bytes_accessed": bytes_acc,
        "kernel_bytes": m["kernel_bytes"], "gathered": m["gathered"],
        "chips": world, "link_bw": bw,
        **({"fit_rel_diff": fit_diff} if fit_diff is not None else {}),
    }
    rec["dominant"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: rec[k])
    return rec


def _blocks_pair(build, cfg, seq_len: int) -> tuple:
    """``_measure``'s ``n_blocks_pair``: ``build`` of the configs of 1 and 2
    blocks (``_cost_cfg``), and ``cfg``'s blocks."""
    return build(_cost_cfg(cfg, 1, seq_len)), build(_cost_cfg(cfg, 2, seq_len)), cfg.n_blocks


def measure_train(arch_id, shape_name, mesh_shape, sync, label, fuse=None, extrapolate=True,
                  *, link_bw=None, smoke=False, shape=None):
    """A train step of ``arch_id`` under gradient-sync ``sync``.
    ``shape``: a ``ShapeConfig`` in place of ``shape_name``'s."""
    shape = shape or SHAPES[shape_name]
    cfg = dryrun.arch_for(arch_id, shape, smoke)

    def build(c):
        def fn(mesh):
            step, args, _ = dryrun.build_train(arch_id, c, shape, mesh, sync, fuse=fuse)
            return step, args
        return fn

    pair = _blocks_pair(build, cfg, shape.seq_len) if extrapolate else None
    return _measure(build(cfg), step="train", label=label, mesh_shape=mesh_shape,
                    link_bw=link_bw, n_blocks_pair=pair)


def measure_decode(arch_id, shape_name, mesh_shape, label, cfg_patch=None,
                   cache_override=None, extrapolate=True, *, link_bw=None, smoke=False):
    """A decode step of ``arch_id``; ``cfg_patch`` replaces config fields,
    ``cache_override(cfg, cache)`` the cache."""
    shape = SHAPES[shape_name]
    cfg = dryrun.arch_for(arch_id, shape, smoke)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)

    def build(c):
        def fn(mesh):
            step, args = dryrun.build_decode(arch_id, c, shape, mesh)
            if cache_override is not None:
                args = (args[0], args[1], cache_override(c, args[2]), args[3])
            return step, args
        return fn

    pair = _blocks_pair(build, cfg, shape.seq_len) if extrapolate else None
    return _measure(build(cfg), step="decode", label=label, mesh_shape=mesh_shape,
                    link_bw=link_bw, n_blocks_pair=pair)


def measure_decode_2dtp(arch_id, shape_name, mesh_shape, label, *, link_bw=None,
                        smoke=False):
    """Decode with the weights 2D-sharded over (data x model) and the token
    batch REPLICATED over data: the per-token FSDP weight all-gathers
    become sums of activations over data (weight-stationary serving). The
    kv cache stays batch-sharded over data (~2 TB at 405B/32k/128): the
    attention runs on each rank's cache rows (``dtensor.headwise`` cuts the
    query to them). A step whose collective holds more than a rank's rows
    of a cache tensor (every other dim whole) has moved the cache across
    the batch, and raises: that would not be this variant. (Gathering a
    rank's own rows whole, as both variants do where the kv heads do not
    divide over ``model`` and the cache is split along D, stays within
    that.)"""
    shape = SHAPES[shape_name]
    cfg = dryrun.arch_for(arch_id, shape, smoke)
    B = shape.global_batch

    def build(c):
        def fn(mesh):
            params, _ = dryrun._params(c, mesh, fsdp=True)
            cache = T.init_cache(c, B, shape.seq_len, device="meta")
            specs = cache_pspecs(cache, dp_axes_of(mesh), mesh)
            cache = [with_shardings(x, mesh, s) for x, s in zip(cache, specs)]
            token = dryrun._meta((B, 1), torch.long, mesh, ())
            dp = math.prod(mesh_sizes(mesh)[a] for a in dp_axes_of(mesh))
            cache_rows[0] = max(t.numel() * t.element_size() for layer in cache
                                for t in layer.values()) // dp

            @torch.no_grad()
            def step(params, token, cache, index):
                with implicit_replication():
                    tree = T.compute_params(T.params_tree(params), c.compute_dtype)
                    return T.decode_step(tree, token, cache, index, c)

            return step, (params, token, cache, shape.seq_len - 1)
        return fn

    cache_rows = [0]            # a rank's rows of the largest cache tensor, other dims whole
    rec = _measure(build(cfg), step="decode", label=label, mesh_shape=mesh_shape,
                   link_bw=link_bw, n_blocks_pair=_blocks_pair(build, cfg, shape.seq_len))
    if rec["coll_max_bytes"] > cache_rows[0]:
        raise RuntimeError(f"{label}: a collective moved {rec['coll_max_bytes']} B, more than "
                           f"a rank's rows of a cache tensor ({cache_rows[0]} B): the cache "
                           "moved across the batch")
    return rec


def card_step(arch_id: str, batch: int, seq: int, smoke: bool = False) -> dict:
    """The record of ``arch_id``'s training step at full width, remat on,
    ``batch`` x ``seq`` tokens on one rank (a 1 x 1 mesh): the step that
    ``chip_smoke.py`` times on the card, counted on meta tensors, with the
    flash kernels' share of the bytes."""
    shape = ShapeConfig("card", seq, batch, "train")
    rec = measure_train(arch_id, "card", {"data": 1, "model": 1}, "torus2d",
                        f"{arch_id} {batch} x {seq} remat, one rank", extrapolate=False,
                        smoke=smoke, shape=shape)
    flash = sum(v for k, v in rec["kernel_bytes"].items() if k.startswith("flash_attn"))
    rec["attention_bytes_share"] = flash / rec["bytes_accessed"]
    return rec


def save(exp_name: str, records: list, out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{exp_name}.json")
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    for r in records:
        print(f"{exp_name:28s} {r['label']:42s} "
              f"cmp {r['compute_s']:.2e} mem {r['memory_s']:.2e} "
              f"coll {r['collective_s']:.2e} dom={r['dominant']}")
    return path


# ---------------------------------------------------------------------------
# Experiments: each takes the fabric and, for the tests' small runs, its
# meshes and the arch's smoke config
# ---------------------------------------------------------------------------

def exp_sync_strategies(link_bw=None, meshes=(POD, TWO_PODS), smoke=False):
    """Paper Table-2 analogue: gradient-sync strategy sweep on gemma-7b
    train_4k, single-pod (1D data ring) and multi-pod (2D torus)."""
    out = []
    for mesh in meshes:
        mname = "2pod" if "pod" in mesh else "1pod"
        for sync in ("psum", "ring", "hierarchical", "torus2d"):
            out.append(measure_train("gemma-7b", "train_4k", mesh, sync, f"{mname}/{sync}",
                                     link_bw=link_bw, smoke=smoke))
    return out


def exp_factorized_torus(link_bw=None, flat=POD, factorized=FACTORIZED, smoke=False):
    """Beyond the production mesh: the single pod's data dim factorized into
    a 4x4 torus (paper Table 4 style), so the 2D decomposition exists
    inside one pod; against the flat 16-ring."""
    kw = dict(link_bw=link_bw, smoke=smoke)
    return [
        measure_train("gemma-7b", "train_4k", flat, "torus2d", "flat data=16 (1D ring)", **kw),
        measure_train("gemma-7b", "train_4k", factorized, "torus2d", "factorized 4x4 torus",
                      **kw),
        measure_train("gemma-7b", "train_4k", factorized, "hierarchical",
                      "factorized 4x4 hierarchical", **kw),
        measure_train("gemma-7b", "train_4k", factorized, "ring",
                      "factorized flat ring (control)", **kw),
    ]


def exp_kimi_decode(link_bw=None, mesh=POD, smoke=False):
    """kimi-k2 decode_32k: collective-bound MoE decode. The variant attacks
    the dispatch/combine traffic: capacity factor 1.0 (fewer padded slots)."""
    kw = dict(link_bw=link_bw, smoke=smoke)
    return [measure_decode("kimi-k2-1t-a32b", "decode_32k", mesh, "baseline", **kw),
            measure_decode("kimi-k2-1t-a32b", "decode_32k", mesh, "capacity 1.0",
                           cfg_patch={"moe_capacity_factor": 1.0}, **kw)]


def exp_llama_decode(link_bw=None, mesh=POD, smoke=False):
    """llama3-405b decode_32k: collective-bound (per-token FSDP weight
    all-gathers). Variant: 2D-TP weight-stationary serving."""
    kw = dict(link_bw=link_bw, smoke=smoke)
    return [measure_decode("llama3-405b", "decode_32k", mesh, "baseline fsdp+batch-sharded",
                           **kw),
            measure_decode_2dtp("llama3-405b", "decode_32k", mesh, "2D-TP weight-stationary",
                                **kw)]


EXPERIMENTS = {
    "sync_strategies": exp_sync_strategies,
    "factorized_torus": exp_factorized_torus,
    "kimi_decode": exp_kimi_decode,
    "llama_decode": exp_llama_decode,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default=None, choices=list(EXPERIMENTS))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--link-bw", type=float, default=None,
                    help="the fabric's bytes/s a link (no fabric of the port is measured)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.list or not args.exp:
        print("\n".join(EXPERIMENTS))
        return 0
    save(args.exp, EXPERIMENTS[args.exp](link_bw=args.link_bw), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
