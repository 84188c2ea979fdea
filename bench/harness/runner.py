"""One run of one cell: set-up, the checked first steps, the warm-up, the
measured window, the traced window (``--trace 1``), and the comparison
with the reference once the program's state is freed.

Every rank runs ``rank_main``. Rank 0 is the process that prints the
result; on more than one chip it spawns the others, which meet it through a
``FileStore`` in a fresh directory under ``TMPDIR``. What a run drives:

1. set-up: the process group, the program's trainer (``bench/systems``),
   the weights (``data.py``) and the traffic's ready batches
   (``bench/traffic/<kind>.py``) from the seed;
2. the first ``check_steps`` steps, each one ``Trainer.run`` of one step on
   that train state, the loss, the first gradient and the change read from
   it (``compare.py``);
3. a warm-up ``Trainer.run``, whose step periods size the window;
4. the window: one ``Trainer.run`` over a plan of one stage of that many
   steps; the harness's clock stamps each call of ``data_fn`` and the
   return of the run, after ``torch.cuda.synchronize()``;
5. with ``trace``, ``trace_steps`` more steps in one ``Trainer.run`` under
   ``torch.profiler``, reduced by ``trace.py`` for the per-layer metrics;
6. the peak memory over the ranks, the program's state freed, and on rank
   0 the reference's steps from the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from bench.harness import compare, data, spec
from bench.harness import trace as trace_lib
from bench.reference import train as ref_train

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names of ``modules`` (default ``sys.modules``) that the
    benchmark's processes may not load, compared whole: ``repro_torch`` is
    the program, ``repro`` the JAX package."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclasses.dataclass(frozen=True)
class Options:
    cell: str
    seeds: tuple
    seconds: float
    trace: bool = False
    device: str = "cuda"        # "cpu": gloo and the program's plain path (the CPU tests)
    overrides: dict | None = None   # {"model": {...}, "traffic": {...}, "chips": n}: other
                                    # sizes (tests)
    fault: str | None = None    # a fault of faults.py planted in the program (readings, tests)
    window: bool = True         # False: set-up, the checked steps and the reference only


def _in_turn(pool, call: int):
    return pool[call % len(pool)]


class Feed:
    """``data_fn``: the traffic's batches (by default the pool's in turn),
    the harness's clock stamped at each call."""

    def __init__(self, pool, fetch=_in_turn):
        self.pool, self.fetch, self.calls, self.stamps = pool, fetch, 0, []

    def __call__(self, step: int, global_batch: int):
        self.stamps.append(time.perf_counter())
        batch = self.fetch(self.pool, self.calls)
        self.calls += 1
        if batch[0].shape[0] != global_batch:
            raise ValueError(f"the pool holds {batch[0].shape[0]} rows, the plan asks "
                             f"for {global_batch}")
        return batch


def load_cell(opts: Options) -> spec.Cell:
    cell = spec.cell(opts.cell)
    if not opts.overrides:
        return cell
    config = {**cell.config, "model": {**cell.config["model"],
                                       **opts.overrides.get("model", {})}}
    return dataclasses.replace(cell, config=config, chips=opts.overrides.get("chips", cell.chips),
                               traffic={**cell.traffic, **opts.overrides.get("traffic", {})})


def check_recipe(cfg, config: dict) -> None:
    """Raise unless the program's trainer runs the configuration's recipe."""
    r = config["recipe"]
    lars, sync = r["lars"], r["grad_sync"]
    want = {"schedule": r["schedule"]["name"], "guard": r["guard"]["enabled"],
            "lars": (lars["eta"], lars["weight_decay"], lars["eps"],
                     tuple(lars["skip_tags"]), lars["nesterov"]),
            "sync": (sync["strategy"], spec.DTYPES[sync["comm_dtype"]], sync["fuse"],
                     sync["bucket_bytes"])}
    have = {"schedule": cfg.schedule, "guard": cfg.guard.enabled,
            "lars": (cfg.lars.eta, cfg.lars.weight_decay, cfg.lars.eps,
                     tuple(cfg.lars.skip_tags), cfg.lars.nesterov),
            "sync": (cfg.grad_sync.strategy, cfg.grad_sync.comm_dtype, cfg.grad_sync.fuse,
                     cfg.grad_sync.bucket_bytes)}
    if want != have:
        raise ValueError(f"the program's trainer departs from the configuration: {have} "
                         f"against {want}")


def _plan(cell: spec.Cell, steps: int, world: int):
    from repro_torch.core.batch_control import build_plan
    from repro_torch.core.schedules import BatchSchedule, BatchStage
    t = cell.traffic
    return build_plan(BatchSchedule((BatchStage(0.0, 1.0, t["per_rank_batch"]),)),
                      dataset_size=t["dataset_size"], n_workers=world, max_steps=steps)


def _run(trainer, state, cell, steps: int, world: int, telemetry=None):
    t = dataclasses.replace(trainer, plan=_plan(cell, steps, world), telemetry=telemetry)
    state, history = t.run(state, log=lambda line: None)
    return state, [h for h in history if h.get("kind") == "metric"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _periods(stamps, end: float) -> list[float]:
    marks = list(stamps) + [end]
    return [b - a for a, b in zip(marks, marks[1:])]


def _norm(t) -> float:
    return math.sqrt(float((t.double() * t.double()).sum()))


@dataclasses.dataclass
class Window:
    """What the end-to-end readers take (``bench/end_to_end``)."""
    kind: str              # the traffic's: images | tokens
    steps: int
    items_per_step: int    # images or tokens a step over all the ranks
    window_s: float
    periods: list
    setup_s: float
    chips: int


@dataclasses.dataclass
class Layers:
    """What the per-layer readers take (``bench/metrics``)."""
    trace: trace_lib.Trace
    step_s: float          # the untraced window's time a step
    config: dict
    traffic: dict
    device_name: str


def _seed_run(rank, world, opts, cell, seed, dev, grid, t0, workdir, log) -> dict:
    """One seed's run on this rank; rank 0's dict holds the result."""
    config, traffic = cell.config, cell.traffic
    refmod = ref_train.model(config)
    gb = traffic["per_rank_batch"] * world
    kind = spec.traffic(traffic["kind"])
    feed = Feed(kind.pool(cell, seed, dev, gb), getattr(kind, "fetch", _in_turn))
    trainer, shapes = spec.system(config).build(config, dev, grid, feed)
    if hasattr(kind, "trainer_fields"):
        trainer = dataclasses.replace(trainer, **kind.trainer_fields(traffic, workdir))
    want = refmod.param_shapes(config)
    if shapes != want:
        raise ValueError("the program's parameters differ from the configuration's: "
                         f"{sorted(set(shapes.items()) ^ set(want.items()))[:8]}")
    check_recipe(trainer.cfg, config)
    groups = refmod.lars_groups(list(want), config)
    recipe = config["recipe"]
    lr0 = ref_train.lr_at(recipe["schedule"], 0.0)

    def weights():
        return data.weights(want, refmod.init_rule, seed, dev)

    from repro_torch.train.state import TrainState
    state = TrainState.create(weights(), loss_scale=recipe["guard"]["loss_scale"])
    prog = {"loss": []}
    for k in range(traffic["check_steps"]):
        state, rows = _run(trainer, state, cell, 1, world)
        prog["loss"].append(rows[-1]["loss"])
        if k == 0 and rank == 0:
            prog["grad_norms"] = compare.first_grad_norms(
                weights(), state.opt_state["momentum"], groups, recipe["lars"], lr0)
            if "update_diff_median" in traffic["limits"]:
                prog["v1"] = {n: t.to("cpu", copy=True)
                              for n, t in state.opt_state["momentum"].items()}
    if rank == 0:
        p0 = weights()
        prog["change"] = {n: _norm(state.params[n] - p0[n]) for n in want}
        del p0
    out = {"seed": seed, "attempted": 0, "failed": 0}
    if opts.window:
        # the holder is the only reference: a train state held here would stay
        # beside the two that Trainer.run holds while it runs
        holder = [state]
        del state
        out.update(_windows(rank, world, opts, cell, trainer, holder, feed, dev, gb, t0,
                            kind.items(traffic, gb), log))
        del holder
    else:
        del state
    del trainer
    peak = torch.tensor([out.get("memory_peak_bytes", 0)], dtype=torch.int64, device=dev)
    if world > 1:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    out["memory_peak_bytes"] = int(peak)
    if rank != 0:
        return out
    pool = feed.pool[:traffic["check_steps"]]
    del feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ref_train.train(config, weights(), pool, epoch=0.0, global_batch=gb,
                          first_update="v1" in prog)
    out["numbers"] = compare.numbers(prog, ref)
    out["excluded"] = compare.excluded(ref)
    out["program_loss"], out["reference_loss"] = prog["loss"], ref["loss"]
    return out


def _windows(rank, world, opts, cell, trainer, holder, feed, dev, gb, t0, items,
             log) -> dict:
    from repro_torch.obs import ObsConfig, Telemetry
    traffic = cell.traffic
    feed.stamps.clear()
    state, _ = _run(trainer, holder.pop(), cell, traffic["warmup_steps"], world)
    _sync(dev)
    warm = _periods(feed.stamps, time.perf_counter())
    per = statistics.median(warm[len(warm) // 2:])
    n = torch.tensor([max(traffic["min_steps"], math.ceil(opts.seconds / per))], device=dev)
    if world > 1:
        dist.broadcast(n, src=0)
        dist.barrier()
    n = int(n)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tel = Telemetry(ObsConfig(), rank=rank)
    feed.stamps.clear()
    _sync(dev)
    start = time.perf_counter()
    state, rows = _run(trainer, state, cell, n, world, telemetry=tel)
    _sync(dev)
    end = time.perf_counter()
    periods = _periods(feed.stamps, end)
    span = tel.registry.histogram("step/wall_s").snapshot()
    log(f"cross-check: the trainer's step span, mean {1e3 * span['mean']:.3f} ms over "
        f"{span['count']} steps; the harness's step period, mean "
        f"{1e3 * statistics.mean(periods):.3f} ms over {len(periods)}")
    out = {"window": Window(traffic["kind"], n, items, end - start, periods, start - t0, world),
           "attempted": n, "failed": sum(int(r["skipped"]) for r in rows)}
    if opts.trace:
        # two profiled windows of trace_steps each: the device's activity
        # alone, which costs the host least, for every per-layer metric; then
        # the host's operators too, only to label the idle gaps by them
        k = traffic["trace_steps"]
        for host in (False, True):
            state, rows, tr = _traced(trainer, state, cell, k, world, dev, host)
            out["attempted"] += k
            out["failed"] += sum(int(r["skipped"]) for r in rows)
            if not host:
                out["trace"] = tr
        out["trace"].gaps = tr.gaps
        busy = torch.tensor([out["trace"].busy_s], dtype=torch.float64, device=dev)
        if world > 1:
            dist.all_reduce(busy)
        out["busy_s"] = float(busy) / world
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _traced(trainer, state, cell, steps: int, world: int, dev, host: bool):
    """``steps`` steps in one ``Trainer.run`` under ``torch.profiler``
    (the device's activity; with ``host`` the host's operators too):
    (state, metric rows, the reduced ``Trace``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        with record_function(trace_lib.WINDOW):
            state, rows = _run(trainer, state, cell, steps, world)
            _sync(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return state, rows, trace_lib.reduce(trace_lib.load(path), steps)
    finally:
        os.unlink(path)


def rank_main(rank: int, world: int, opts: Options, store_path: str, t0: float,
              log=print) -> list[dict]:
    """This rank's part of the run: one result a seed. The run's own
    directory (the store's) is the traffic's ``workdir``."""
    cell = load_cell(opts)
    if opts.device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world // 2))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        from repro_torch.core import topology

        from bench.harness import faults
        grid = topology.select_grid(tuple(cell.traffic["grid"])).build()
        results = []
        with faults.planted(opts.fault):
            for seed in opts.seeds:
                results.append(_seed_run(rank, world, opts, cell, seed, dev, grid, t0,
                                         os.path.dirname(store_path), log))
                if world > 1:
                    dist.barrier()
        return results
    finally:
        dist.destroy_process_group()


def _child(rank: int, world: int, opts: Options, store_path: str, t0: float) -> None:
    try:
        rank_main(rank, world, opts, store_path, t0, log=lambda line: None)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    found = forbidden_modules()
    if found:
        print(f"rank {rank}: the process loaded {found}", file=sys.stderr)
        sys.stderr.flush()
        os._exit(3)


def run(opts: Options, t0: float, log=print) -> list[dict]:
    """The run on every rank the cell asks for; rank 0's results."""
    cell = load_cell(opts)
    world = cell.chips
    store_dir = tempfile.mkdtemp(prefix="bench-store-")
    store = os.path.join(store_dir, "store")
    children = []
    try:
        if world > 1:
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
            for r in range(1, world):
                p = ctx.Process(target=_child, args=(r, world, opts, store, t0))
                p.start()
                children.append(p)
        results = rank_main(0, world, opts, store, t0, log)
        for p in children:
            p.join(timeout=120)
        bad = [(i + 1, p.exitcode) for i, p in enumerate(children) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks ended badly (rank, exit code): {bad}")
        return results
    finally:
        for p in children:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        shutil.rmtree(store_dir, ignore_errors=True)


def result(cell: spec.Cell, r: dict, opts: Options, device_name: str) -> tuple[dict, list]:
    """The result line's object and the comparisons' lines (name, value,
    limit) for rank 0's result ``r``."""
    limits = cell.traffic["limits"]
    checks = {k: {"value": r["numbers"][k], "limit": v} for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if opts.trace:
        tr = r["trace"]
        layers = Layers(tr, r["window"].window_s / r["window"].steps, cell.config,
                        cell.traffic, device_name)
        for m in cell.per_layer:
            value = spec.reader("metrics", m["name"])(layers)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = spec.reader("end_to_end", m["name"])(r["window"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if opts.device == "cuda" else opts.device, "kind": device_name,
              "count": cell.chips, "memory_peak_bytes": r["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": r["attempted"], "failed": r["failed"],
            "metrics": metrics, "device": device}
    if opts.trace:
        device.update(busy_s=r["busy_s"], window_s=r["trace"].window_s)
        line["breakdown"] = {"device_ops": r["trace"].top_ops(10),
                             "idle_gaps": r["trace"].idle_by_label(10)}
    line["checks"] = checks
    return line, [(k, c["value"], c["limit"]) for k, c in checks.items()]
