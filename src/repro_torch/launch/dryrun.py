"""Multi-pod dry run (``repro/launch/dryrun.py``): build and run one step of
every (arch x input shape x mesh) against the production mesh on torch's
``fake`` process group (256 or 512 ranks in one process) and record its
collectives, FLOPs and memory. No array is allocated: parameters, caches
and inputs are meta tensors distributed as DTensors; this shows that the
distribution config is coherent.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(never the reference's ``experiments/dryrun/``), with the reference's keys.

Device-free by design, as the reference's is (it compiles with
``JAX_PLATFORMS=cpu``): the step runs on meta tensors, so no value is ever
computed and no kernel launched. It is not a CPU fallback of a card path.
Meta tensors take the plain attention (``kernels/ops.py``), as the
reference's dry run traces its plain ``_sdpa``. The model runs under
``implicit_replication``, since it makes plain tensors of its own (RoPE
tables, scalars) beside the DTensors.

Per path:
- Train, non-FSDP archs (the paper's path): ``remat`` on (``arch_for``),
  Megatron-style tensor parallelism over ``model``, replicas over the DP
  dims. The gradients' local shards (unreduced over the DP dims, sharded
  as their parameters over ``model``) go through the port's ``sync_tree``
  over the DP ranks of their own model column, as the reference's
  ``shard_map`` over the DP axes does with ``model`` auto: torus2d,
  ``fuse=False``, fp32 comm (the reference's host comm dtype, so the JSON
  compares field for field), then LARS.
- Train, FSDP archs: placements shard over ``data`` too and DTensor issues
  the collectives (the gradients reduce-scatter to their parameters'
  placements); then LARS.
- Prefill and decode: the parameters as for training, the caches by
  ``cache_pspecs``.

What ``run_one`` records, under the reference's keys:
- ``collectives``: every collective of the step, from ``hlo_stats.Recorder``.
- ``bucket_audit``: the reference's audit at its floor (``_audit_floor``).
  On the manual path it reads the collectives the gradient sync issued,
  recorded apart from the model's: the reference's reads its whole
  compiled step, whose tensor-parallel reductions its floor does not drop.
  FSDP: the whole step at the 1 KiB floor, as the reference's.
- ``expected_exchanges``: ``len(bucket_layout(...))`` over the reference's
  stacked leaves at their global shapes, the reference's count.
- ``cost.flops``: ``FlopCounterMode`` over this rank's program. It counts
  every layer, where the reference's ``cost_analysis`` counts a scanned
  body once (``launch/cost_extrapolate.py`` fits that and, here, checks
  that the count is linear in the blocks).
- ``cost.bytes_accessed``: the traffic of this rank's eager program, op by
  op with no fusion credited (``hlo_stats.Recorder``): each op's local
  tensor inputs read once and outputs written once; views, allocations
  and the collectives (counted apart) left out, and DTensor's shape
  propagation too, as for the FLOPs. The attention counts as the flash
  kernels move it (q, k, v, o and lse; in backward also dO, dq, dk, dv),
  not as the plain attention that runs on meta tensors and writes the
  (B, H, S, S) scores; the loss (where the logits are whole) and LARS
  as their kernels too (``kernels/traffic.py``). ``cost.kernel_bytes``
  (not a reference key): those kernels' share, by kernel. XLA's
  ``bytes accessed``, the reference's, is of a fused program, so the two
  differ by the fusion.
- ``memory``: ``argument_bytes`` and ``output_bytes`` are the local shard
  bytes of a rank's inputs and outputs; ``temp_bytes`` the peak bytes of
  the storages the step made, followed by the recorder
  (``track_memory``); ``peak_bytes`` their sum with the arguments.
- ``gathered`` (not a reference key): the sites where this rank's program
  held whole what the placements shard, with their counts
  (``utils/dtensor.py:GATHERED``: the MoE dispatch's routing and gates and
  its combine's experts, the SSD scan's heads, the kv cache layout's heads,
  a head split whose heads do not divide over the ranks (musicgen's 24
  heads, Qwen3's 8 kv heads on 16), the attention's heads where a kv
  group straddles two ranks, the loss's vocab where it is not evenly
  sharded). Each raises ``flops``,
  ``collectives`` and ``memory`` above those of the tensor-parallel
  program; an empty dict means none did. The attention runs on each
  rank's batch and head shards, the loss on its vocab shards (all-reduces
  of a row's max, sum of exponentials, label logit and sum), the
  embedding on its vocab rows (``dtensor.vocab_lookup``: an all-reduce
  of the looked-up rows; under FSDP the table's d shards gathered and
  the gradient reduce-scattered), the RG-LRU gates on their columns of
  an input made whole along its width, and the RG-LRU scan on each
  rank's batch and width shards; the norms make their input whole along
  d (pending sums reduced) before scaling it, and their gradient on the
  way back, as Megatron's tensor parallelism does. The MoE dispatch's
  row gather adds its gradient rows locally (``dtensor.take_rows``).
- ``lower_s``: seconds to build the step's inputs (meta init, placements);
  ``compile_s`` is null (nothing compiles) and ``run_s`` the wall seconds
  of the step on meta tensors.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import convert, obs
from repro_torch.configs import comm as comm_cfg
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, ShapeConfig, long_context_variant
from repro_torch.core import autotune, collectives, lars, losses
from repro_torch.core import grad_sync as grad_sync_lib
from repro_torch.core.autotune import HardwareModel
from repro_torch.core.grad_sync import GradSyncConfig, sync_tree
from repro_torch.core.topology import H_AXIS, V_AXIS, select_grid
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import (cache_pspecs, dp_axes_of, make_production_mesh,
                                     mesh_sizes, param_pspecs, with_shardings)
from repro_torch.models import transformer as T
from repro_torch.testing.chaos import FaultPlan
from repro_torch.utils import dtensor

# archs whose params cannot be data-replicated even at TP=16: FSDP
# placements (ZeRO-style). The rest use the paper's explicit gradient sync.
FSDP_ARCHS = {"llama-3.2-vision-90b", "kimi-k2-1t-a32b", "llama3-405b",
              "gemma2-27b"}

OUT_DIR = "experiments/dryrun_torch"
# the reference's hand-set bucket size before the autotuner (its autotune.py)
LEGACY_BUCKET_BYTES = 4 << 20


def _bucket_bytes_arg(s: str):
    """--bucket-bytes parser: an int, or the literal "auto" sentinel."""
    return s if s == grad_sync_lib.AUTO else int(s)


@contextlib.contextmanager
def fake_world(world: int):
    """torch's ``fake`` process group of ``world`` ranks in this process
    (this process is rank 0; collectives move no data), destroyed on exit.
    An initialised group of that size is used as it is."""
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"initialised; the dry run needs {world}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        # DTensor caches op shardings by mesh layout; an entry holds its mesh,
        # and so the groups of this world, which a later world of the same
        # layout must not reach
        _clear_sharding_prop_cache()
        dist.destroy_process_group()


def world_of(multi_pod: bool, mesh_shape: dict | None) -> int:
    """The ranks of a combination's mesh: ``mesh_shape``'s, else the
    production mesh's."""
    return math.prod(mesh_shape.values()) if mesh_shape else (512 if multi_pod else 256)


def _mesh(multi_pod: bool, mesh_shape: dict | None):
    if mesh_shape is None:
        return (make_production_mesh(multi_pod=multi_pod),
                "pod2x16x16" if multi_pod else "pod16x16")
    from torch.distributed.device_mesh import init_device_mesh
    name = "x".join(f"{k}{v}" for k, v in mesh_shape.items())
    return init_device_mesh("cpu", tuple(mesh_shape.values()),
                            mesh_dim_names=tuple(mesh_shape)), name


def _replica(mesh, batch: int):
    """(the mesh a step's DTensors live on, the batch rows they hold). The
    rules shard parameters over ``data`` and ``model`` only, so ``pod`` is
    pure data parallelism: each pod runs its rows on its (data, model)
    sub-mesh, the per-rank program of the reference's 3-D one, without a
    tensor dim sharded over two mesh dims (which DTensor's rules refuse on
    some versions). A batch the pods do not divide (long_500k's 1) is
    every pod's whole."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh, batch
    pods = mesh_sizes(mesh)["pod"]
    inner = mesh[tuple(a for a in mesh.mesh_dim_names if a != "pod")]
    return inner, (batch // pods if batch % pods == 0 else batch)


def batch_spec(batch: int, mesh) -> tuple:
    """Shard the batch over DP dims only when divisible (long_500k has B=1)."""
    dp = dp_axes_of(mesh)
    dp_size = math.prod(mesh_sizes(mesh)[a] for a in dp)
    return ((dp[0] if len(dp) == 1 else dp),) if batch % dp_size == 0 else ()


def arch_for(arch_id: str, shape: ShapeConfig, smoke: bool = False) -> T.ArchConfig:
    cfg = registry.get_smoke(arch_id) if smoke else registry.get(arch_id)
    if shape.name == "long_500k":
        cfg = long_context_variant(cfg)
    if shape.step == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def _meta(shape, dtype, mesh, spec) -> DTensor:
    return with_shardings({"x": torch.empty(shape, dtype=dtype, device="meta")}, mesh,
                          {"x": spec})["x"]


def _vision(cfg, batch: int, mesh):
    if not cfg.vision_tokens:
        return None
    return _meta((batch, cfg.vision_tokens, cfg.cross_kv_dim), torch.bfloat16, mesh,
                 batch_spec(batch, mesh))


def _params(cfg, mesh, fsdp: bool, sizes: dict | None = None) -> tuple[dict, dict]:
    """(the parameters as meta DTensors on ``mesh`` by the reference's
    rules, their global meta tensors). ``sizes``: the whole mesh's, whose
    divisibility the rules follow, when ``mesh`` is its ``model`` sub-mesh."""
    flat = dict(T.init(cfg, device="meta").named_parameters())
    flat = {n: p.detach() for n, p in flat.items()}
    specs = param_pspecs(flat, cfg, fsdp=fsdp, mesh=mesh, sizes=sizes)
    return with_shardings(flat, mesh, specs), flat


def _dp_grid(mesh, dp: tuple[str, ...]):
    """The built torus grid of this rank's model column: the DP ranks that
    hold the same model shard, (dy, dx) in row-major order of the DP dims
    (the reference's ``select_grid(dp)``: the last DP dim horizontal)."""
    names = mesh.mesh_dim_names
    ranks = mesh.mesh.permute(*[names.index(a) for a in dp],
                              *[i for i, a in enumerate(names) if a not in dp])
    columns = ranks.reshape(math.prod(ranks.shape[:len(dp)]), -1).T.tolist()
    return select_grid(tuple(mesh_sizes(mesh)[a] for a in dp)).build(members=columns)


def _local_bytes(tree) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# step builders: return (step_fn, args)
# ---------------------------------------------------------------------------

def build_train(arch_id, cfg, shape, mesh, sync_strategy="torus2d", fuse=None,
                bucket_bytes=0, down_axes=(), hw: HardwareModel | None = None):
    """(step, args, sync_info): ``step(*args)`` runs one train step.

    FSDP archs run on the whole mesh. The others run as the reference's
    ``shard_map`` over the DP dims with ``model`` auto: each rank holds its
    rows of the batch as plain local tensors, the parameters are DTensors
    on the ``model`` sub-mesh (tensor parallelism), and the loss, its
    gradients and their local shards are this rank's, which ``sync_tree``
    then averages over the rank's model column."""
    sync_info: dict = {"effective": None, "events": [], "config": None}
    dp = dp_axes_of(mesh)
    fsdp = arch_id in FSDP_ARCHS
    B = shape.global_batch
    if fsdp:
        inner, rows = _replica(mesh, B)
        params, global_params = _params(cfg, inner, fsdp)
        tokens = _meta((rows, shape.seq_len), torch.long, inner, batch_spec(rows, inner))
        vision = _vision(cfg, rows, inner)
    else:
        tp = mesh["model"]
        params, global_params = _params(cfg, tp, fsdp, sizes=mesh_sizes(mesh))
        rows = B // math.prod(mesh_sizes(mesh)[a] for a in dp)
        tokens = _meta((rows, shape.seq_len), torch.long, tp, ())
        vision = _vision(cfg, rows, tp)
    params = {n: p.requires_grad_(True) for n, p in params.items()}
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    groups = convert.leaf_groups(params, cfg)
    labels = tokens

    grid = gcfg = None
    if not fsdp:
        grid = _dp_grid(mesh, dp)
        # the grid's axes: the last DP dim is horizontal, the others vertical
        down = tuple(H_AXIS if a == dp[-1] else V_AXIS for a in down_axes if a in dp)
        gcfg = GradSyncConfig(strategy=sync_strategy, fuse=False if fuse is None else fuse,
                              comm_dtype=torch.float32, bucket_bytes=bucket_bytes)
        gcfg, sync_events = grad_sync_lib.resolve_sync_config(
            gcfg, grid, down_axes=down, params_like=global_params, probe=False,
            hw=(comm_cfg.hw_for_mesh(mesh, hw=hw)
                if bucket_bytes == grad_sync_lib.AUTO else None))
        layout = grad_sync_lib.bucket_layout(global_params, gcfg, groups)
        sync_info = {"effective": gcfg.strategy, "events": sync_events,
                     "config": {k: (v if isinstance(v, (int, float, bool, str, type(None)))
                                    else str(v))
                                for k, v in dataclasses.asdict(gcfg).items()},
                     "expected_exchanges": len(layout),
                     "min_exchange_bytes": (min(b["nbytes"] for b in layout)
                                            if layout else None),
                     "recorder": hlo_stats.Recorder()}

    def step(params, mom, tokens, labels, vision):
        with implicit_replication():
            tree = T.compute_params(T.params_tree(params), cfg.compute_dtype)
            logits, aux = T.forward(tree, tokens, cfg, vision=vision)
            loss = losses.label_smoothing_xent(logits, labels, 0.1) + 0.01 * aux
            names = list(params)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            # to each parameter's placement: FSDP's reduce-scatter over data,
            # the tensor-parallel reductions over model
            grads = {n: dtensor.normalized(g).redistribute(placements=params[n].placements)
                     for n, g in grads.items()}
            if fsdp and "pod" in mesh.mesh_dim_names:
                for g in grads.values():       # the pods' sum of the FSDP shards
                    dist.all_reduce(g.to_local(), group=mesh.get_group("pod"))
            if not fsdp:
                # planned on the global shapes, the local shards exchanged
                with sync_info["recorder"]:
                    grads = sync_tree(grads, grid, gcfg, groups)
                # the reference's pmean of the loss over the DP dims
                loss = loss.to_local().detach().clone()
                dist.all_reduce(loss, group=grid.world.group)
            new_p, new_m = lars.update(params, grads, {"momentum": mom}, lr=1.0,
                                       momentum=0.9, groups=groups)
        return loss, new_p, new_m["momentum"]

    return step, (params, mom, tokens, labels, vision), sync_info


def build_prefill(arch_id, cfg, shape, mesh):
    mesh, B = _replica(mesh, shape.global_batch)
    params, _ = _params(cfg, mesh, arch_id in FSDP_ARCHS)
    tokens = _meta((B, shape.seq_len), torch.long, mesh, batch_spec(B, mesh))
    vision = _vision(cfg, B, mesh)

    @torch.no_grad()
    def step(params, tokens, vision):
        with implicit_replication():
            tree = T.compute_params(T.params_tree(params), cfg.compute_dtype)
            return T.prefill(tree, tokens, cfg, vision=vision)

    return step, (params, tokens, vision)


def build_decode(arch_id, cfg, shape, mesh):
    mesh, B = _replica(mesh, shape.global_batch)
    dp = dp_axes_of(mesh)
    params, _ = _params(cfg, mesh, arch_id in FSDP_ARCHS)
    cache = T.init_cache(cfg, B, shape.seq_len, device="meta")
    specs = cache_pspecs(cache, dp, mesh)
    cache = [with_shardings(c, mesh, s) for c, s in zip(cache, specs)]
    token = _meta((B, 1), torch.long, mesh, batch_spec(B, mesh))

    @torch.no_grad()
    def step(params, token, cache, index):
        with implicit_replication():
            tree = T.compute_params(T.params_tree(params), cfg.compute_dtype)
            return T.decode_step(tree, token, cache, index, cfg)

    return step, (params, token, cache, shape.seq_len - 1)


def measure(fn, args) -> dict:
    """Run ``fn(*args)`` once under ``hlo_stats.Recorder`` (collectives,
    ops, the bytes they move, the storages' peak) and ``FlopCounterMode``:
    its record, FLOPs, bytes accessed (and the kernels' share of them),
    wall seconds, the local bytes of its arguments and outputs, and the
    sites that held whole what the placements shard (``dtensor.GATHERED``)."""
    rec = hlo_stats.Recorder(track_memory=True)
    flops = FlopCounterMode(display=False)
    dtensor.GATHERED.clear()
    t0 = time.time()
    with flops, rec:
        out = fn(*args)
    return {"recorder": rec, "flops": flops.get_total_flops(), "run_s": time.time() - t0,
            "bytes_accessed": rec.bytes_accessed, "kernel_bytes": dict(rec.kernel_bytes),
            "argument_bytes": _local_bytes(args), "output_bytes": _local_bytes(out),
            "gathered": dict(dtensor.GATHERED)}


def _audit_floor(sync_info: dict) -> int:
    """min_bytes floor for the bucket audit, derived from the resolved
    schedule: low enough to keep the smallest intended exchange, high
    enough (>= 16 B) to drop scalar loss/metric reductions. FSDP runs have
    no manual schedule and keep the historical 1 KiB floor."""
    smallest = sync_info.get("min_exchange_bytes")
    if smallest is None:
        return 1024
    return max(16, min(1024, int(smallest)))


def _audit_summary(recorded, sync_info: dict) -> dict:
    audit = hlo_stats.bucket_audit(recorded, min_bytes=_audit_floor(sync_info))
    return {"num_exchanges": audit["num_exchanges"],
            "min_bytes": audit["dropped"]["min_bytes"],
            "by_kind": audit["by_kind"],
            "dropped": {k: audit["dropped"][k] for k in ("count", "bytes", "by_kind")}}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def run_one(arch_id: str, shape_name: str, multi_pod: bool,
            sync_strategy: str = "torus2d", out_dir: str = OUT_DIR,
            save: bool = True, quiet: bool = False,
            bucket_bytes: int | str = 0, fault_plan: FaultPlan | None = None,
            hw: HardwareModel | None = None, mesh_shape: dict | None = None,
            smoke_arch: bool = False) -> dict:
    """One combination; the reference's ``run_one``. ``mesh_shape``
    ({dim: size}, model last) replaces the production mesh and
    ``smoke_arch`` takes the arch's smoke config (the tests' small runs);
    ``hw`` is the fabric that ``bucket_bytes="auto"`` needs."""
    shape = SHAPES[shape_name]
    with fake_world(world_of(multi_pod, mesh_shape)):
        mesh, mesh_name = _mesh(multi_pod, mesh_shape)
        cfg = arch_for(arch_id, shape, smoke_arch)
        down_axes = tuple(fault_plan.down_axes) if fault_plan is not None else ()
        sync_info: dict = {"effective": None, "events": [], "config": None}
        t0 = time.time()
        if shape.step == "train":
            fn, args, sync_info = build_train(arch_id, cfg, shape, mesh, sync_strategy,
                                              bucket_bytes=bucket_bytes,
                                              down_axes=down_axes, hw=hw)
        elif shape.step == "prefill":
            fn, args = build_prefill(arch_id, cfg, shape, mesh)
        else:
            fn, args = build_decode(arch_id, cfg, shape, mesh)
        t_build = time.time() - t0
        m = measure(fn, args)
        rec, t_run = m["recorder"], m["run_s"]
        arg_bytes, out_bytes = m["argument_bytes"], m["output_bytes"]
        coll = hlo_stats.collective_stats(rec)
        n_chips = mesh.size()
        mesh_summary = mesh_sizes(mesh)
        if shape.step == "train":
            audited = sync_info.get("recorder", rec)
            audit = _audit_summary(audited, sync_info)
        result = {
            "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
            "run_id": obs.new_run_id(),
            "config_fingerprint": obs.fingerprint({
                "arch": arch_id, "shape": shape_name, "mesh": mesh_summary,
                "grad_sync": sync_info["config"], "fsdp": arch_id in FSDP_ARCHS}),
            "mesh_summary": mesh_summary,
            "grad_sync_config": sync_info["config"],
            "step": shape.step, "chips": int(n_chips),
            "fsdp": arch_id in FSDP_ARCHS,
            "sync_strategy": sync_strategy if shape.step == "train" else None,
            "sync_strategy_effective": sync_info["effective"],
            "sync_downgrade_events": sync_info["events"] or None,
            "fault_injection": {"down_axes": list(down_axes)} if down_axes else None,
            "bucket_bytes": bucket_bytes if shape.step == "train" else None,
            "bucket_bytes_resolved": ((sync_info["config"] or {}).get("bucket_bytes")
                                      if shape.step == "train" else None),
            "expected_exchanges": sync_info.get("expected_exchanges"),
            "bucket_audit": audit if shape.step == "train" else None,
            "lower_s": round(t_build, 1), "compile_s": None, "run_s": round(t_run, 1),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": rec.peak_bytes,
                "peak_bytes": arg_bytes + rec.peak_bytes,
            },
            "cost": {"flops": m["flops"], "bytes_accessed": m["bytes_accessed"],
                     "kernel_bytes": m["kernel_bytes"]},
            "collectives": coll,
            "op_histogram": hlo_stats.op_histogram(rec),
            "gathered": m["gathered"],
            "model_params": cfg.num_params(),
            "active_params": cfg.active_params(),
            "grad_comm_dtype": ("f32 (the reference's host comm dtype)"
                                if shape.step == "train" else None),
        }
    if save:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    if not quiet:
        mb = (result["memory"]["temp_bytes"] or 0) / 2**30
        ex = (f" exchanges {result['bucket_audit']['num_exchanges']}/"
              f"{result['expected_exchanges']}" if shape.step == "train" else "")
        print(f"[OK] {arch_id:22s} {shape_name:12s} {mesh_name:10s} "
              f"build {t_build:5.1f}s run {t_run:6.1f}s "
              f"flops {result['cost']['flops']:.3e} "
              f"coll {coll['total_bytes'] / 2**30:.2f}GiB "
              f"temp/chip {mb:.2f}GiB{ex}")
    return result


def sweep_bucket_bytes(arch_id: str, hw: HardwareModel, multi_pod: bool = False,
                       sync_strategy: str = "torus2d", out_dir: str = OUT_DIR,
                       save: bool = True, smoke_arch: bool = False,
                       candidates: list[int] | None = None,
                       max_sync_buckets: int = 256, slack: float = 0.05) -> dict:
    """Empirical bucket-size sweep, as the reference's: run the sync alone
    (``sync_tree`` with ``fuse=True`` over replicated gradients, on meta
    tensors over this rank's DP grid) at production scale for each
    candidate ``bucket_bytes``, audit its recorded exchanges, and pair
    every row with the alpha-beta cost model of ``hw``. The autotuner's
    pick (``autotune.recommend_bucket_bytes`` over the union of the
    sweep's candidates) is then gated against the sweep: its cost-model
    ``exposed_seconds`` within 10% of the sweep's best, strictly better
    than ``bucket_bytes=0`` and than the reference's legacy 4 MiB, and
    inside the sweep's optimum bracket.

    ``hw`` is required: the reference's fabric constants are a TPU pod's,
    and no fabric of the port has been measured (``configs/comm.py``).
    Writes ``bucket_sweep__<arch>__<mesh>.json``; raises ``SystemExit``
    when a gate fails. Candidates whose schedule exceeds
    ``max_sync_buckets`` keep the cost-model row only, with the skip
    recorded.
    """
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh, mesh_name = _mesh(multi_pod, None)
        cfg = registry.get_smoke(arch_id) if smoke_arch else registry.get(arch_id)
        dp = dp_axes_of(mesh)
        grid = _dp_grid(mesh, dp)
        x, y = grid.sizes()
        gcfg0 = GradSyncConfig(strategy=sync_strategy, fuse=True,
                               comm_dtype=torch.float32, bucket_bytes=0)
        gcfg0, resolve_events = grad_sync_lib.resolve_sync_config(gcfg0, grid, probe=False)
        strategy = gcfg0.strategy
        grads = {n: p.detach() for n, p in T.init(cfg, device="meta").named_parameters()}
        groups = convert.leaf_groups(grads, cfg)
        layout0 = grad_sync_lib.bucket_layout(grads, gcfg0, groups)
        total_bytes = sum(b["nbytes"] for b in layout0)
        knee = autotune.analytic_knee_bytes(strategy, x, y, hw)
        default_grid = autotune.candidate_bucket_bytes(knee, total_bytes)
        cand = sorted(set(candidates)) if candidates else default_grid

        rows = []
        for b in cand:
            gcfg = dataclasses.replace(gcfg0, bucket_bytes=b)
            layout = grad_sync_lib.bucket_layout(grads, gcfg, groups)
            floor = max(16, min(1024, min(e["nbytes"] for e in layout)))
            m = collectives.bucketed_comm_cost_model(
                strategy, total_bytes, b, x, y, hw.link_bw, hw.latency_s,
                backward_seconds=hw.backward_seconds)
            row = {"bucket_bytes": b, "num_buckets": len(layout),
                   "exposed_seconds": m["exposed_seconds"],
                   "serial_seconds": m["serial_seconds"]}
            if len(layout) <= max_sync_buckets:
                t0 = time.time()
                rec = hlo_stats.Recorder()
                with rec:
                    sync_tree(grads, grid, gcfg, groups)
                audit = hlo_stats.bucket_audit(rec, min_bytes=floor)
                row.update({
                    "num_exchanges": audit["num_exchanges"],
                    "audit_by_kind": audit["by_kind"],
                    "audit_dropped": {k: audit["dropped"][k]
                                      for k in ("count", "bytes", "min_bytes")},
                    "recorded_matches_schedule": audit["num_exchanges"] == len(layout),
                    "run_s": round(time.time() - t0, 1),
                })
            else:
                row["sync_skipped"] = (f"{len(layout)} buckets > max_sync_buckets="
                                       f"{max_sync_buckets}; cost-model row only")
            rows.append(row)
            print(f"[sweep] bucket_bytes={b:>12d}  buckets={len(layout):>5d}  "
                  f"exposed={m['exposed_seconds'] * 1e6:9.1f}us  "
                  f"recorded_exchanges={row.get('num_exchanges', '-')}")
        chips = mesh.size()

    union = sorted(set(cand) | set(default_grid))
    rec_pick = autotune.recommend_bucket_bytes(strategy, x, y, hw, total_bytes=total_bytes,
                                               candidates=union, slack=slack)
    refined = autotune.refine_from_sweep(rows, strategy, x, y, hw, total_bytes=total_bytes,
                                         slack=slack)

    def exposed_at(b):
        return collectives.bucketed_comm_cost_model(
            strategy, total_bytes, b, x, y, hw.link_bw, hw.latency_s,
            backward_seconds=hw.backward_seconds)["exposed_seconds"]

    best_row = min(rows, key=lambda r: r["exposed_seconds"])
    checks = {
        "auto_within_10pct_of_sweep_best":
            rec_pick["exposed_seconds"] <= 1.10 * best_row["exposed_seconds"],
        "auto_beats_fused": rec_pick["exposed_seconds"] < exposed_at(0),
        "auto_beats_legacy_4mib":
            rec_pick["exposed_seconds"] < exposed_at(LEGACY_BUCKET_BYTES),
        "auto_within_sweep_bracket":
            autotune.pick_within_bracket(rec_pick["bucket_bytes"], refined["bracket"]),
    }
    result = {
        "mode": "bucket_sweep", "arch": arch_id,
        "arch_variant": "smoke" if smoke_arch else "full",
        "mesh": mesh_name, "chips": int(chips),
        "strategy_requested": sync_strategy, "strategy": strategy,
        "resolve_events": resolve_events or None,
        "comm_dtype": "float32", "total_bytes": total_bytes,
        "hw": dataclasses.asdict(hw), "analytic_knee_bytes": knee,
        "rows": rows,
        "auto": {"bucket_bytes": rec_pick["bucket_bytes"],
                 "num_buckets": rec_pick["num_buckets"],
                 "exposed_seconds": rec_pick["exposed_seconds"]},
        "refined": refined, "checks": checks,
    }
    if save:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"bucket_sweep__{arch_id}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        print(f"[sweep] wrote {path}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(
            f"[sweep] FAILED gates: {failed}; auto pick {rec_pick['bucket_bytes']} "
            f"(exposed {rec_pick['exposed_seconds'] * 1e6:.1f}us) vs sweep best "
            f"{best_row['bucket_bytes']} ({best_row['exposed_seconds'] * 1e6:.1f}us)")
    print(f"[sweep] OK: auto bucket_bytes={rec_pick['bucket_bytes']} "
          f"({rec_pick['num_buckets']} buckets, exposed "
          f"{rec_pick['exposed_seconds'] * 1e6:.1f}us) within bracket "
          f"[{refined['bracket']['low']}, {refined['bracket']['high']}] of sweep best "
          f"{refined['bracket']['best_bucket_bytes']}")
    return result


def _chaos_rank(rank: int, world: int, store_path: str, fault_step: int, max_steps: int,
                metrics_out: str | None, trace_out: str | None, ckpt_dir: str,
                result_path: str) -> None:
    """One gloo rank of ``chaos_train``: the port's supervised ``Trainer`` on
    ResNet-tiny over the 2 x 4 grid; rank 0 writes its history."""
    import pickle

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        from repro_torch.core.batch_control import build_plan
        from repro_torch.core.schedules import BatchSchedule, BatchStage
        from repro_torch.data.synthetic import SyntheticImageNet
        from repro_torch.models import resnet
        from repro_torch.obs import Telemetry
        from repro_torch.train.state import TrainState
        from repro_torch.train.trainer import Trainer, TrainerConfig

        faulty = fault_step >= 0
        grid = select_grid((2, 4)).build()
        cfg = resnet.ResNetConfig.tiny(num_classes=4, compute_dtype=torch.float32)
        model = resnet.init(cfg, seed=0, device="cpu")
        data = SyntheticImageNet(num_classes=4, image_size=32, noise=0.3, device="cpu")

        def loss_fn(params, batch, grid):
            images, labels = batch
            logits = resnet.apply(model, images, params=params, grid=grid)
            return losses.label_smoothing_xent(logits, labels, 0.1), torch.zeros(())

        plan = build_plan(BatchSchedule((BatchStage(0, 1.0, 2),)), dataset_size=256,
                          n_workers=world, max_steps=max_steps)
        obs_cfg = obs.ObsConfig(metrics_path=metrics_out, trace_path=trace_out)
        tcfg = TrainerConfig(grad_sync=GradSyncConfig(strategy="torus2d"), log_every=1,
                             ckpt_every_steps=2, ckpt_keep_last=10, retry_backoff_s=1e-4,
                             obs=obs_cfg)
        tel = Telemetry(obs_cfg, rank=rank, meta={
            "source": "chaos-train" if faulty else "train-smoke",
            "fault_step": fault_step, "planned_steps": max_steps})
        trainer = Trainer(loss_fn=loss_fn, cfg=tcfg, plan=plan,
                          data_fn=lambda i, gb: data.batch(i, gb), grid=grid,
                          checkpoint_dir=ckpt_dir,
                          fault_plan=(FaultPlan(axis_down_events=((V_AXIS, fault_step),))
                                      if faulty else None),
                          telemetry=tel)
        completed, error, history, steps = False, None, [], 0
        try:
            state, history = trainer.run(TrainState.create(dict(model.named_parameters())),
                                         log=lambda s: None)
            completed, steps = True, int(state.step)
        except RuntimeError as e:     # an aborted run is the result under test
            error = repr(e)
        finally:
            tel.close()
        snap = tel.registry.snapshot()
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump({"completed": completed, "error": error, "history": history,
                             "steps": steps, "run_id": tel.run_id, "counters": {
                                 k: int(snap.get(k, {}).get("value", 0))
                                 for k in ("elastic/recoveries", "elastic/permanent_failures",
                                           "events/elastic_recovery")}}, f)
        # every rank done before any tears its group down: gloo can abort a
        # rank whose peers close their sockets first
        dist.barrier()
    finally:
        dist.destroy_process_group()


def chaos_train(fault_step: int, out_dir: str = OUT_DIR, max_steps: int = 8,
                metrics_out: str | None = None, trace_out: str | None = None) -> dict:
    """Elastic-recovery smoke, as the reference's: train ResNet-tiny on 8
    gloo ranks (a 2 x 4 grid, the reference's 8-device mesh), kill the
    torus's vertical axis ("dy") permanently at ``fault_step``, and require
    the run to finish every planned step through a mid-run torus2d ->
    ring downgrade and a checkpoint rollback. Writes
    ``<out_dir>/chaos_train.json``; raises ``SystemExit`` if the run
    aborts or the recovery is missing from the events. ``fault_step < 0``
    runs the same loop fault-free with inverted gates and writes
    ``train_smoke.json``. ``metrics_out`` / ``trace_out`` route rank 0's
    telemetry (metrics JSONL, Chrome trace) to files."""
    import multiprocessing as mp
    import pickle
    import shutil
    import tempfile

    faulty = fault_step >= 0
    tag = "chaos-train" if faulty else "train-smoke"
    world = 8
    tmp = tempfile.mkdtemp(prefix="chaos_train_")
    result_path = os.path.join(tmp, "rank0.pkl")
    t0 = time.time()
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_chaos_rank,
                             args=(r, world, os.path.join(tmp, "store"), fault_step,
                                   max_steps, metrics_out, trace_out,
                                   os.path.join(tmp, "ckpt"), result_path))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        if hung or any(p.exitcode for p in procs):
            raise SystemExit(f"[{tag}] FAILED: ranks exited with "
                             f"{[p.exitcode for p in procs]} (still running: {hung})")
        with open(result_path, "rb") as f:
            run = pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    history = run["history"]
    events = [h for h in history if h.get("kind") != "metric"]
    downgrades = [e for e in events if e.get("event") == "grad_sync_downgrade"]
    recoveries = [e for e in events if e.get("event") == "elastic_recovery"]
    losses_seen = [h["loss"] for h in history if "loss" in h]
    counters = run["counters"]
    result = {
        "mode": "chaos_train" if faulty else "train_smoke",
        "mesh": "2x4", "chips": world, "run_id": run["run_id"],
        "fault": {"axis": "dy", "down_from_step": fault_step} if faulty else None,
        "planned_steps": max_steps, "steps": run["steps"],
        "completed": run["completed"], "error": run["error"],
        "wall_s": round(time.time() - t0, 1),
        "loss_finite": all(math.isfinite(v) for v in losses_seen),
        "metrics_out": metrics_out, "trace_out": trace_out,
        "recovery_counters": counters, "events": events,
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chaos_train.json" if faulty else "train_smoke.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(f"[{tag}] wrote {path}")

    problems = []
    if not run["completed"]:
        problems.append(f"run aborted: {run['error']}")
    elif run["steps"] != max_steps:
        problems.append(f"finished {run['steps']}/{max_steps} steps")
    if not result["loss_finite"]:
        problems.append("non-finite loss in history")
    if faulty:
        if not any(d.get("context") == "elastic" for d in downgrades):
            problems.append("no mid-run grad_sync_downgrade event")
        if not recoveries:
            problems.append("no elastic_recovery event")
        if counters["elastic/recoveries"] < 1:
            problems.append("elastic/recoveries counter is zero")
    else:
        if downgrades or recoveries:
            problems.append(f"fault-free run saw {len(downgrades)} downgrade / "
                            f"{len(recoveries)} recovery events")
        if counters["elastic/recoveries"] != 0:
            problems.append("fault-free run has nonzero elastic/recoveries")
    if problems:
        raise SystemExit(f"[{tag}] FAILED: " + "; ".join(problems))
    if faulty:
        print(f"[{tag}] OK: axis dy died at step {fault_step}, run finished "
              f"{run['steps']}/{max_steps} steps (downgrade {downgrades[0]['from']}->"
              f"{downgrades[0]['to']}, rollback to step {recoveries[0]['step']})")
    else:
        print(f"[{tag}] OK: fault-free run finished {run['steps']}/{max_steps} steps, "
              "zero recovery events")
    return result


def _hw_from(args) -> HardwareModel | None:
    given = (args.link_bw, args.latency_s, args.backward_seconds)
    if all(v is None for v in given):
        return None
    if any(v is None for v in given):
        raise SystemExit("--link-bw, --latency-s and --backward-seconds go together")
    return HardwareModel(link_bw=args.link_bw, latency_s=args.latency_s,
                         backward_seconds=args.backward_seconds, name="given")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sync", default="torus2d",
                    choices=["psum", "ring", "hierarchical", "torus2d"])
    ap.add_argument("--bucket-bytes", type=_bucket_bytes_arg, default=0,
                    help="gradient-sync bucket size target; 0 = single fused buffer; "
                         "'auto' = autotuned against the fabric flags")
    ap.add_argument("--sweep-bucket-bytes", action="store_true",
                    help="bucket-size sweep of the sync alone at production scale, "
                         "gating the autotuner's pick (needs the fabric flags)")
    ap.add_argument("--smoke-arch", action="store_true",
                    help="--sweep-bucket-bytes: the arch's smoke config")
    ap.add_argument("--link-bw", type=float, default=None, help="fabric: bytes/s a link")
    ap.add_argument("--latency-s", type=float, default=None, help="fabric: s a ring step")
    ap.add_argument("--backward-seconds", type=float, default=None,
                    help="fabric: the backward pass the exchange overlaps, s")
    ap.add_argument("--inject-faults", action="store_true",
                    help="mark the leading DP axis down: the sync must degrade along "
                         "the fallback chain; events land in the JSON")
    ap.add_argument("--chaos-train", action="store_true",
                    help="elastic-recovery smoke: ResNet-tiny on 8 gloo ranks, a torus "
                         "axis killed mid-run, completion through downgrade + rollback")
    ap.add_argument("--fault-step", type=int, default=3,
                    help="--chaos-train: step at which the axis dies; negative runs "
                         "fault-free (train_smoke.json, inverted gates)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.chaos_train:
        chaos_train(args.fault_step, args.out, metrics_out=args.metrics_out,
                    trace_out=args.trace_out)
        return 0
    hw = _hw_from(args)
    if args.sweep_bucket_bytes:
        if not args.arch:
            raise SystemExit("--sweep-bucket-bytes needs --arch")
        if hw is None:
            raise SystemExit("--sweep-bucket-bytes needs the fabric: --link-bw, "
                             "--latency-s and --backward-seconds (no fabric of the port "
                             "has been measured; the reference's are a TPU pod's)")
        sweep_bucket_bytes(args.arch, hw, multi_pod=args.multi_pod,
                           sync_strategy=args.sync, out_dir=args.out,
                           smoke_arch=args.smoke_arch)
        return 0

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = registry.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    failures = []
    t_all = time.time()
    for mp_ in meshes:
        for arch_id in archs:
            for shape_name in shapes:
                mesh_name = "pod2x16x16" if mp_ else "pod16x16"
                path = os.path.join(args.out, f"{arch_id}__{shape_name}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[SKIP] {arch_id} {shape_name} {mesh_name}")
                    continue
                fault_plan = None
                if args.inject_faults:
                    # down the leading DP axis: the inter-pod axis on the 2-pod
                    # mesh, the whole data ring otherwise
                    fault_plan = FaultPlan(down_axes=("pod" if mp_ else "data",))
                try:
                    run_one(arch_id, shape_name, mp_, args.sync, args.out,
                            bucket_bytes=args.bucket_bytes, fault_plan=fault_plan, hw=hw)
                except Exception as e:  # noqa: BLE001 -- recorded, then the run fails
                    failures.append((arch_id, shape_name, mp_, repr(e)))
                    print(f"[FAIL] {arch_id} {shape_name} multi_pod={mp_}: {e}")
                    traceback.print_exc()
    print(f"dry run: {len(archs) * len(shapes) * len(meshes)} combinations in "
          f"{time.time() - t_all:.1f} s, {len(failures)} failed")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("ALL DRY-RUNS PASSED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
