"""``launch/hlo_stats.py`` against ``repro/launch/hlo_stats.py``.

The reference parses collectives out of HLO text; the port records them as
a step dispatches. Here: the wire-byte formula equals the reference's for
every kind and group size; ``collective_stats`` and ``bucket_audit`` over a
recorded schedule equal the reference's over HLO text holding the same
ops; and the recorder, on torch's ``fake`` process group, sees the port's
``sync_tree`` issue exactly ``len(bucket_layout)`` exchanges, DTensor's
redistributions as functional collectives, and this rank's FLOPs alone.
"""

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_stats as jstats
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import grad_sync
from repro_torch.core.topology import select_grid
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.models import transformer as T

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


@pytest.mark.parametrize("n", [1, 2, 16, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_is_the_references(kind, n):
    for nbytes in (4, 1024, 3 * 2**20 + 12):
        assert hlo_stats._wire_bytes(kind, nbytes, n) == jstats._wire_bytes(kind, nbytes, n)


SCHEDULE = [  # (kind, dtype, dims, group size), in issue order
    ("reduce-scatter", "bf16", (4096, 16), 16), ("all-reduce", "f32", (65536,), 2),
    ("all-gather", "bf16", (65536, 16), 16), ("all-reduce", "f32", (64,), 16),
    ("all-reduce", "f32", (1,), 256), ("all-to-all", "bf16", (8, 128), 32),
    ("collective-permute", "f32", (8, 8), 2), ("reduce-scatter", "f32", (300,), 2),
]
_BYTES = {"f32": 4, "bf16": 2}


def _hlo(schedule) -> str:
    lines = []
    for i, (kind, dtype, dims, n) in enumerate(schedule):
        groups = "{{" + ",".join(str(r) for r in range(n)) + "}}"
        lines.append(f"  %op.{i} = {dtype}[{','.join(map(str, dims))}]{{0}} "
                     f"{kind}(%x.{i}), replica_groups={groups}")
    return "\n".join(lines)


def _recorded(schedule) -> list[dict]:
    out = []
    for kind, dtype, dims, n in schedule:
        nbytes = _BYTES[dtype]
        for d in dims:
            nbytes *= d
        out.append({"kind": kind, "dtype": dtype, "nbytes": nbytes, "group_size": n})
    return out


def test_collective_stats_and_schedule_are_the_references():
    text, rec = _hlo(SCHEDULE), _recorded(SCHEDULE)
    assert hlo_stats.collective_schedule(rec) == jstats.collective_schedule(text)
    assert hlo_stats.collective_stats(rec) == jstats.collective_stats(text)


@pytest.mark.parametrize("min_bytes", [0, 16, 1024, 1 << 20])
def test_bucket_audit_is_the_references(min_bytes):
    text, rec = _hlo(SCHEDULE), _recorded(SCHEDULE)
    assert hlo_stats.bucket_audit(rec, min_bytes) == jstats.bucket_audit(text, min_bytes)


@pytest.mark.parametrize("fuse,bucket_bytes", [(False, 0), (True, 0), (True, 4096)])
def test_recorder_sees_sync_tree_issue_its_exchanges(fuse, bucket_bytes):
    """On a 2 x 4 grid of the fake group each exchange opens with an
    all-reduce (the vertical phase of torus2d, or a grouped bucket's psum):
    ``num_exchanges`` is ``len(bucket_layout)``, with a reduce-scatter and
    an all-gather for each torus2d exchange."""
    cfg = registry.get_smoke("qwen3-1.7b")
    grads = {n: p.detach() for n, p in T.init(cfg, device="meta").named_parameters()}
    groups = convert.leaf_groups(grads, cfg)
    gcfg = grad_sync.GradSyncConfig(fuse=fuse, bucket_bytes=bucket_bytes,
                                    comm_dtype=torch.float32)
    layout = grad_sync.bucket_layout(grads, gcfg, groups)
    with dryrun.fake_world(8):
        grid = select_grid((2, 4)).build()
        rec = hlo_stats.Recorder()
        with rec:
            out = grad_sync.sync_tree(grads, grid, gcfg, groups)
    assert {n: t.shape for n, t in out.items()} == {n: t.shape for n, t in grads.items()}
    audit = hlo_stats.bucket_audit(rec)
    torus = sum(1 for b in layout if b["mode"] != "grouped")
    assert audit["num_exchanges"] == len(layout) > 1
    assert audit["by_kind"]["all-reduce"]["count"] == len(layout)
    assert audit["by_kind"]["reduce-scatter"]["count"] == torus
    assert audit["by_kind"]["all-gather"]["count"] == torus
    # torus2d's rows of 4 and columns of 2; a grouped psum over all 8
    want = ({2, 4} if torus else set()) | ({8} if len(layout) > torus else set())
    assert {op["group_size"] for op in rec.collectives} == want
    assert {op["dtype"] for op in rec.collectives} == {"f32"}
    assert hlo_stats.op_histogram(rec)[0][1] >= 1


def test_recorder_sees_dtensor_collectives_and_counts_local_flops():
    """A DTensor op desugars before the recorder sees it: the all-gathers
    its redistribution needs are recorded, and a ``FlopCounterMode``
    entered before the recorder counts the local products only, not
    DTensor's shape propagation on the global shapes."""
    with dryrun.fake_world(8):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Shard(1), Shard(0)])
        x = distribute_tensor(torch.empty(16, 64, device="meta"), mesh, [Shard(1), Shard(0)])
        flops = FlopCounterMode(display=False)
        rec = hlo_stats.Recorder(track_memory=True)
        with flops, rec:
            y = torch.mm(x, w)
            z = y.redistribute(placements=[Replicate(), Replicate()])
        assert z.to_local().shape == (16, 32)
    kinds = [op["kind"] for op in rec.collectives]
    assert "all-gather" in kinds
    assert all(op["group_size"] in (2, 4) for op in rec.collectives)
    # rank 0's share of the product; the shape propagation's global mm (2 *
    # 16 * 64 * 32 FLOPs on fake tensors) would count in full
    assert rec.ops["aten.mm"] == 1
    assert 0 < flops.get_total_flops() <= 2 * 16 * 64 * 32 // 2
    assert rec.peak_bytes > 0


def test_recorder_follows_live_storages():
    rec = hlo_stats.Recorder(track_memory=True)
    with rec:
        a = torch.empty(1000, device="meta")            # 4000 B
        b = a.view(10, 100)                              # the same storage
        c = torch.empty(500, dtype=torch.bfloat16, device="meta")   # 1000 B
        assert rec.live_bytes == 5000 and rec.peak_bytes == 5000
        del a, c
        assert rec.live_bytes == 4000                    # b keeps a's storage
        del b
        d = torch.empty(10, device="meta")
        assert rec.live_bytes == 40
    assert rec.peak_bytes == 5000 and d.numel() == 10
