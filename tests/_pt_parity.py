"""Eight gloo ranks on the CPU, for the port's multi-rank parity tests.

``launch(body, tmp_path, *args)`` starts ``world`` processes (spawn), each
of which joins a gloo process group through a ``dist.FileStore`` under
``tmp_path`` (no port, so parallel test workers cannot collide), runs
``body(rank, world, *args)`` on one thread and pickles its result to a
file; the parent returns the results in rank order. Every process group
has a timeout and every launch a join deadline, so a hang fails its test.

The rank bodies live here, not in the test files: a spawned child imports
the module of its target, and this module imports torch and ``repro_torch``
only, never JAX. Each body runs many checks in one launch and returns
numpy arrays; the test compares them with the JAX package's results.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import pickle
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8
PG_TIMEOUT_S = 60      # any collective that waits longer raises
JOIN_DEADLINE_S = 90   # a launch that has not ended by then is killed


def _entry(rank: int, world: int, store_path: str, out_dir: str, body, args):
    out = Path(out_dir)
    try:
        torch.set_num_threads(1)
        # torch 2.13 renames the *_tensor collectives; the port keeps the
        # names that every torch it runs on has
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*_tensor` is deprecated")
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            result = body(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        (out / f"{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"{rank}.err").write_text(traceback.format_exc())
        raise


def launch(body, tmp_path: Path, *args, world: int = WORLD,
           deadline_s: float = JOIN_DEADLINE_S) -> list:
    """Run ``body(rank, world, *args)`` on ``world`` gloo ranks; returns the
    results in rank order. Raises with a rank's traceback if one failed, and
    kills every rank if the launch outlives ``deadline_s``."""
    ctx = mp.get_context("spawn")
    run_dir = Path(tmp_path) / f"pg_{body.__name__}"
    run_dir.mkdir(parents=True, exist_ok=False)
    procs = [ctx.Process(target=_entry, args=(r, world, str(run_dir / "store"),
                                              str(run_dir), body, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errs = sorted(run_dir.glob("*.err"))
    if errs:
        raise RuntimeError(f"rank {errs[0].stem} failed:\n{errs[0].read_text()}")
    if hung:
        raise TimeoutError(f"{body.__name__}: ranks {hung} still running after "
                           f"{deadline_s} s; killed")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"{body.__name__}: ranks exited with {bad}")
    return [pickle.loads((run_dir / f"{r}.pkl").read_bytes()) for r in range(world)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------------ rank bodies --

def collectives_body(rank: int, world: int, grids, inputs) -> dict:
    """Every strategy x lowering on each grid of ``grids`` ((Y, X) sizes) on
    this rank's slice of each input in ``inputs`` ({name: (array, dtype)},
    arrays of shape (world, ...)); plus the ring chunk convention on each
    grid's rows and on all ranks. Returns {(grid, strategy, lowering,
    name): array}, {(grid, ring, check): array}."""
    from repro_torch.core import collectives as C
    from repro_torch.core import topology

    out = {}
    for sizes in grids:
        grid = topology.select_grid(sizes).build()
        for strategy in C.STRATEGIES:
            for lowering in C.LOWERINGS:
                xs = {name: torch.from_numpy(a[rank].copy()).to(dtype)
                      for name, (a, dtype) in inputs.items()}
                # every input of one case in flight together, as sync_tree does
                got = C.run([C.exchange(x, grid, strategy, lowering) for x in xs.values()])
                for name, g in zip(xs, got):
                    out[sizes, strategy, lowering, name] = _np(g)
        for ring_name, ring in (("h", grid.h), ("world", grid.world)):
            x = torch.from_numpy(inputs["f32"][0][rank].copy())
            rs_ring, rs_xla = C.run([C._rs(x, ring, "ring"), C._rs(x, ring, "xla")])
            ag_ring, ag_xla = C.run([C._ag(rs_ring, ring, "ring"), C._ag(rs_xla, ring, "xla")])
            out[sizes, ring_name, "rs_ring"] = _np(rs_ring)
            out[sizes, ring_name, "rs_xla"] = _np(rs_xla)
            out[sizes, ring_name, "ag_ring"] = _np(ag_ring)
            out[sizes, ring_name, "ag_xla"] = _np(ag_xla)
    return out


def grad_sync_body(rank: int, world: int, sizes, grads, cases, resolve_cases) -> dict:
    """``sync_tree`` of this rank's gradients ({name: (world, ...) array})
    under each config in ``cases`` ({key: kwargs of GradSyncConfig}), and
    ``resolve_sync_config`` under each of ``resolve_cases`` ({key: (config
    kwargs, resolve kwargs)}). Returns {key: {name: array}} and
    {key: (resolved config kwargs, events)}."""
    from repro_torch.core import grad_sync, topology
    from repro_torch.core.autotune import HardwareModel

    grid = topology.select_grid(sizes).build()
    mine = {name: torch.from_numpy(a[rank].copy()) for name, a in grads.items()}
    synced = {}
    for key, kw in cases.items():
        out = grad_sync.sync_tree(mine, grid, grad_sync.GradSyncConfig(**kw))
        assert list(out) == list(mine)
        assert all(out[k].shape == mine[k].shape and out[k].dtype == mine[k].dtype
                   for k in mine)
        # the exchange works in buffers of its own: the input is untouched
        assert all(np.array_equal(mine[k].numpy(), grads[k][rank]) for k in mine), key
        synced[key] = {k: _np(v) for k, v in out.items()}
    resolved = {}
    for key, (kw, rkw) in resolve_cases.items():
        rkw = dict(rkw)
        if "hw" in rkw:
            rkw["hw"] = HardwareModel(**rkw["hw"])
        if rkw.pop("params_like", False):
            rkw["params_like"] = mine
        cfg, events = grad_sync.resolve_sync_config(grad_sync.GradSyncConfig(**kw), grid,
                                                    **rkw)
        resolved[key] = ({"strategy": cfg.strategy, "bucket_bytes": cfg.bucket_bytes},
                         events)
    return {"synced": synced, "resolved": resolved,
            "probe_fault": _resolve_with_a_wrong_probe_on(3, rank, grid)}


def _resolve_with_a_wrong_probe_on(bad_rank: int, rank: int, grid):
    """``resolve_sync_config`` of the default config where rank
    ``bad_rank`` alone reads a wrong sum from torus2d's probe; returns this
    rank's (strategy, events)."""
    from repro_torch.core import collectives, grad_sync

    real = collectives.all_reduce

    def all_reduce(x, grid, strategy="torus2d", lowering="xla"):
        out = real(x, grid, strategy, lowering)
        return out + 1 if rank == bad_rank and strategy == "torus2d" else out

    collectives.all_reduce = all_reduce
    try:
        cfg, events = grad_sync.resolve_sync_config(grad_sync.GradSyncConfig(), grid)
    finally:
        collectives.all_reduce = real
    return cfg.strategy, events


def _tiny_model(params: dict, num_classes: int):
    from repro_torch.convert import params_from_jax
    from repro_torch.models import resnet

    cfg = resnet.ResNetConfig.tiny(compute_dtype=torch.float32, num_classes=num_classes)
    model = resnet.init(cfg, seed=0, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


def synced_bn_body(rank: int, world: int, sizes, params, images, weights) -> dict:
    """ResNet-tiny with BN moments synced over the grid: this rank's logits,
    and the gradients of sum(logits * weights) summed over ranks, with
    respect to this rank's images and to the params, as the JAX package's
    ``jax.grad`` inside ``shard_map`` gives them."""
    from repro_torch.convert import params_to_jax
    from repro_torch.core import topology
    from repro_torch.models import resnet

    grid = topology.select_grid(sizes).build()
    model = _tiny_model(params, weights.shape[-1])
    x = torch.from_numpy(images[rank].copy()).requires_grad_(True)
    p = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
    logits = resnet.apply(model, x, params=p, grid=grid)
    (logits * torch.from_numpy(weights[rank].copy())).sum().backward()
    return {"logits": _np(logits), "dx": _np(x.grad),
            "grads": params_to_jax({k: v.grad for k, v in p.items()})}


def batchnorm_body(rank: int, world: int, sizes, cases) -> dict:
    """``ops.batchnorm`` on this rank's rows of each case's batch, the
    moments over the grid of ``sizes``: {key: y, mean, var and the
    gradients of sum(y * dy) with respect to x, scale, bias and the
    residual}. ``cases``: {key: (x, scale, bias, residual or None, dy) NHWC
    fp32 arrays, relu, dtype}, the batch divided evenly over the ranks."""
    from repro_torch.core import topology

    grid = topology.select_grid(sizes).build()
    out = {}
    for key, (arrays, relu, dtype) in cases.items():
        per = arrays[0].shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        out[key] = batchnorm_grads(*(None if a is None else a[rows] if a.ndim == 4 else a
                                     for a in arrays), relu=relu, dtype=dtype, grid=grid)
    return out


def batchnorm_grads(x, scale, bias, res, dy, *, relu: bool, dtype, grid=None) -> dict:
    """y, (mean, var) and the gradients of sum(y * dy) of ``ops.batchnorm``
    from NHWC fp32 arrays, activations channels-last in ``dtype``."""
    from repro_torch.kernels import ops

    def act(a):
        return torch.from_numpy(a.copy()).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)

    xt, rt = act(x), None if res is None else act(res)
    st, bt = (torch.from_numpy(a.copy()).to(dtype).requires_grad_(True) for a in (scale, bias))
    y, (mean, var) = ops.batchnorm(xt, st, bt, grid=grid, relu=relu, residual=rt,
                                   return_stats=True)
    leaves = [t for t in (xt, st, bt, rt) if t is not None]
    grads = torch.autograd.grad(y, leaves, act(dy).detach())
    out = {"y": _np(y), "mean": _np(mean), "var": _np(var)}
    out.update({k: _np(g) for k, g in zip(("dx", "dscale", "dbias", "dres"), grads)})
    return out


def synthetic_batch(step: int, global_batch: int, num_classes: int):
    """The global batch of a step: (images (gb, 32, 32, 3) fp32, labels
    (gb,) int32) from numpy seed ``step``, the same for both packages."""
    rng = np.random.RandomState(1000 + step)
    return (rng.randn(global_batch, 32, 32, 3).astype(np.float32),
            rng.randint(0, num_classes, (global_batch,)).astype(np.int32))


def trainer_body(rank: int, world: int, sizes, params, num_classes: int, runs) -> dict:
    """The port's ``Trainer`` on ResNet-tiny (fp32 compute) from ``params``
    for each run of ``runs`` ({key: (GradSyncConfig kwargs, stages as
    (start, end, per-worker batch), dataset size, max steps)}), every rank
    fed its rows of ``synthetic_batch``; returns {key: (per-step metric
    rows, final params in the JAX layout)}."""
    from repro_torch.convert import params_to_jax
    from repro_torch.core import losses, topology
    from repro_torch.core.batch_control import build_plan
    from repro_torch.core.grad_sync import GradSyncConfig
    from repro_torch.core.schedules import BatchSchedule, BatchStage
    from repro_torch.models import resnet
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    grid = topology.select_grid(sizes).build()
    model = _tiny_model(params, num_classes)

    def loss_fn(p, batch, grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=p, grid=grid)
        return losses.label_smoothing_xent(logits, labels, 0.1), torch.zeros(())

    def data_fn(i, gb):
        return tuple(torch.from_numpy(a) for a in synthetic_batch(i, gb, num_classes))

    out = {}
    for key, (sync_kw, stages, dataset_size, steps) in runs.items():
        plan = build_plan(BatchSchedule(tuple(BatchStage(*s) for s in stages)),
                          dataset_size=dataset_size, n_workers=world, max_steps=steps)
        cfg = TrainerConfig(schedule="B", log_every=1, grad_sync=GradSyncConfig(**sync_kw))
        state, history = Trainer(loss_fn, cfg, plan, data_fn, grid=grid).run(
            TrainState.create(dict(model.named_parameters())), log=lambda s: None)
        rows = [{k: h[k] for k in ("step", "loss", "global_batch", "skipped", "lr")}
                for h in history if h["kind"] == "metric"]
        out[key] = (rows, params_to_jax(state.params))
    return out


def lm_batch(step: int, global_batch: int, seq: int, vocab: int):
    """The global batch of an LM step: (tokens, labels) (gb, seq) int32
    from numpy seed ``step``, labels the tokens shifted by one, the same
    for both packages."""
    rng = np.random.RandomState(2000 + step)
    t = rng.randint(0, vocab, (global_batch, seq + 1)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def lm_trainer_body(rank: int, world: int, sizes, arch: str, params, seq: int,
                    runs) -> dict:
    """The port's ``Trainer`` on ``arch``'s smoke config (fp32 compute) from
    the JAX ``params``, with the launcher's loss and the reference's stacked
    leaves as LARS and sync groups, for each run of ``runs`` ({key:
    (GradSyncConfig kwargs, stages as (start, end, per-rank batch), dataset
    size[, checkpoint dir to resume from])}), every rank fed its rows of
    ``lm_batch``; returns {key: (per-step metric rows, final params {port
    name: array})}."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.core import topology
    from repro_torch.core.batch_control import build_plan
    from repro_torch.core.grad_sync import GradSyncConfig
    from repro_torch.core.schedules import BatchSchedule, BatchStage
    from repro_torch.launch.train import loss_fn_for
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    grid = topology.select_grid(sizes).build()
    cfg = dataclasses.replace(registry.get_smoke(arch), compute_dtype=torch.float32)
    start = convert.transformer_from_jax(params, cfg, device="cpu")
    groups = convert.leaf_groups(start, cfg)

    def data_fn(i, gb):
        return tuple(torch.from_numpy(a).long() for a in lm_batch(i, gb, seq, cfg.vocab))

    out = {}
    for key, (sync_kw, stages, dataset_size, *resume_dir) in runs.items():
        plan = build_plan(BatchSchedule(tuple(BatchStage(*s) for s in stages)),
                          dataset_size=dataset_size, n_workers=world)
        tcfg = TrainerConfig(schedule="B", log_every=1, grad_sync=GradSyncConfig(**sync_kw))
        trainer = Trainer(loss_fn_for(cfg, 0.1), tcfg, plan, data_fn, grid=grid,
                          leaf_groups=groups, checkpoint_dir=(resume_dir or [None])[0])
        state, history = trainer.run(TrainState.create(dict(start)), log=lambda s: None,
                                     resume=bool(resume_dir))
        rows = [{k: h[k] for k in ("step", "loss", "global_batch", "skipped", "lr")}
                for h in history if h["kind"] == "metric"]
        out[key] = (rows, {k: _np(v) for k, v in state.params.items()})
    return out


def dtensor_shards_body(rank: int, world: int, attn_cases, logits, labels, smoothing) -> dict:
    """``utils/dtensor.py``'s shard-wise ops on a 1-D ``model`` mesh of the
    world's gloo ranks, from whole inputs: ``headwise`` over the plain
    attention for each case of ``attn_cases`` ({name: (q, k, v, cotangent)},
    q's heads sharded, k and v's sharded where they divide, else whole) and
    ``ls_xent`` over vocab-sharded ``logits``. Returns each output and the
    gradients of its inputs (a cotangent's inner product), whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ref
    from repro_torch.utils import dtensor

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    out = {}

    def dist_leaf(a, placement):
        return distribute_tensor(torch.from_numpy(a.copy()), mesh, [placement]).requires_grad_()

    for name, (q, k, v, cot) in attn_cases.items():
        kv_pl = Shard(2) if k.shape[2] % world == 0 else Replicate()
        q, k, v = dist_leaf(q, Shard(2)), dist_leaf(k, kv_pl), dist_leaf(v, kv_pl)
        o = dtensor.headwise(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True),
                             q, k, v)
        (o * distribute_tensor(torch.from_numpy(cot.copy()), mesh, o.placements)).sum() \
            .backward()
        out[name] = {"o": o.placements, **{n: _np(t.full_tensor()) for n, t in
                                           (("out", o), ("dq", q.grad), ("dk", k.grad),
                                            ("dv", v.grad))}}
    x = dist_leaf(logits, Shard(1))
    per = dtensor.ls_xent(x, torch.from_numpy(labels.copy()), smoothing)
    per.sum().backward()
    out["ls_xent"] = {"out": _np(per.full_tensor()), "dx": _np(x.grad.full_tensor())}
    return out


def dtensor_rows_body(rank: int, world: int, table, ids, cot, rows, idx, rows_cot,
                      rg) -> dict:
    """``utils/dtensor.py``'s row gathers and the RG-LRU gates on a (data 2,
    model 2) mesh of four gloo ranks, from whole inputs: ``vocab_lookup``
    of ``ids`` (rows over ``data``) in ``table`` placed as FSDP (vocab
    over ``model``, d over ``data``), as tensor parallelism (vocab over
    ``model``) and with d over ``model``; ``take_rows`` of ``rows`` by a
    whole ``idx``, the gradient split over ``idx``'s first dim and the
    trailing one; ``nn/rglru.py``'s ``_gates`` and the scan through
    ``dtensor.elementwise`` with the placements of the dry run (x's width and
    the gate kernels' columns over ``model``). Returns each output and the
    gradients of its inputs (a cotangent's inner product), whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.nn import rglru
    from repro_torch.utils import dtensor

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def leaf(a, placements, grad=True):
        t = distribute_tensor(torch.from_numpy(a.copy()), mesh, placements)
        return t.requires_grad_() if grad else t

    out = {}
    for name, pl in (("fsdp", [Shard(1), Shard(0)]), ("tp", [Replicate(), Shard(0)]),
                     ("d_model", [Replicate(), Shard(1)])):
        t = leaf(table, pl)
        y = dtensor.vocab_lookup(t, leaf(ids, [Shard(0), Replicate()], grad=False))
        (y * leaf(cot, list(y.placements), grad=False)).sum().backward()
        out[f"lookup_{name}"] = {"out": _np(y.full_tensor()), "dtable": _np(t.grad.full_tensor()),
                                 "grad_placements": t.grad.placements}
    r = leaf(rows, [Shard(0), Replicate()])
    y = dtensor.take_rows(r, torch.from_numpy(idx.copy()))
    (y * leaf(rows_cot, [Shard(2), Shard(0)], grad=False)).sum().backward()
    out["take_rows"] = {"out": _np(y.full_tensor()), "drows": _np(r.grad.full_tensor())}
    cfg = rglru.RGLRUConfig(d_model=rg["x"].shape[-1])
    p = {"rg_kernel": leaf(rg["rg_kernel"], [Replicate(), Shard(1)]),
         "ig_kernel": leaf(rg["ig_kernel"], [Replicate(), Shard(1)]),
         "rg_bias": leaf(rg["rg_bias"], [Replicate(), Shard(0)]),
         "ig_bias": leaf(rg["ig_bias"], [Replicate(), Shard(0)]),
         "lambda_param": leaf(rg["lambda_param"], [Replicate(), Shard(0)])}
    x = leaf(rg["x"], [Shard(0), Shard(2)])
    a, bx = rglru._gates(p, x, cfg)
    h = dtensor.elementwise(rglru._scan, a, bx, whole=(1,))
    loss = sum((t * leaf(rg[f"cot_{n}"], list(t.placements), grad=False)).sum()
               for n, t in (("a", a), ("bx", bx), ("h", h)))
    loss.backward()
    out["rglru"] = {"a": _np(a.full_tensor()), "bx": _np(bx.full_tensor()),
                    "h": _np(h.full_tensor()), "dx": _np(x.grad.full_tensor()),
                    **{f"d{n}": _np(t.grad.full_tensor()) for n, t in p.items()}}
    return out
