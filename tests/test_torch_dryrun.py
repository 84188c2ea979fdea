"""``launch/dryrun.py`` against ``repro/launch/dryrun.py``, on torch's
``fake`` process group and meta tensors.

``run_one`` on the smoke configs of a dense, an MoE, an SSD and an FSDP
arch at two small meshes (data 4 x model 2; pod 2 x data 2 x model 2)
writes the reference's JSON keys; its ``expected_exchanges`` is the
reference's ``len(bucket_layout)`` over the reference's stacked tree, its
audit floor the reference's ``_audit_floor``, and the exchanges the
recorder saw the gradient sync issue are that schedule's. The FLOPs of a
train step on a 1 x 1 mesh equal ``FlopCounterMode`` of the same step on
real CPU tensors, and at data 1 x model m they are 1/m of that on each
rank. One full-width combination runs at world 256; the chaos run and the
bucket sweep run as the reference's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jregistry
from repro.core import grad_sync as jsync
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.core import grad_sync, lars, losses
from repro_torch.core.topology import TorusGrid
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T

# the keys of the reference's run_one result (src/repro/launch/dryrun.py:302-340)
REF_KEYS = {"arch", "shape", "mesh", "run_id", "config_fingerprint", "mesh_summary",
            "grad_sync_config", "step", "chips", "fsdp", "sync_strategy",
            "sync_strategy_effective", "sync_downgrade_events", "fault_injection",
            "bucket_bytes", "bucket_bytes_resolved", "expected_exchanges", "bucket_audit",
            "lower_s", "compile_s", "memory", "cost", "collectives", "model_params",
            "active_params", "grad_comm_dtype"}
MESHES = {"1d": {"data": 4, "model": 2}, "2d": {"pod": 2, "data": 2, "model": 2}}


def _reference():
    """The reference dry run's ``_audit_floor`` and ``FSDP_ARCHS``. Importing
    the module sets ``XLA_FLAGS`` for 512 devices, which the backend, up
    already, ignores; the variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def _ref_layout(arch, smoke=True):
    jcfg = jregistry.get_smoke(arch) if smoke else jregistry.get(arch)
    jcfg = dataclasses.replace(jcfg, remat=True)
    params = jax.eval_shape(lambda: jT.init(jax.random.key(0), jcfg))
    gcfg = jsync.GradSyncConfig(strategy="torus2d", fuse=False, comm_dtype=jnp.float32,
                                bucket_bytes=0)
    return jsync.bucket_layout(params, gcfg)


def test_fsdp_archs_are_the_references():
    assert dryrun.FSDP_ARCHS == _reference().FSDP_ARCHS


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-2.7b",
                                  "llama3-405b"])
def test_run_one_holds_the_references_schedule(arch, mesh, tmp_path):
    r = dryrun.run_one(arch, "train_4k", False, out_dir=str(tmp_path), quiet=True,
                       mesh_shape=MESHES[mesh], smoke_arch=True)
    saved = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert REF_KEYS <= set(saved) and saved["arch"] == arch
    assert r["chips"] == 8 and r["step"] == "train" and r["cost"]["flops"] > 0
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
    assert r["collectives"]["total_count"] > 0
    jd = _reference()
    audit = r["bucket_audit"]
    if arch in dryrun.FSDP_ARCHS:                 # no manual schedule: XLA's / DTensor's
        assert r["fsdp"] and r["expected_exchanges"] is None and r["grad_sync_config"] is None
        assert audit["min_bytes"] == jd._audit_floor({}) == 1024
        return
    layout = _ref_layout(arch)
    assert r["expected_exchanges"] == len(layout)
    assert audit["min_bytes"] == jd._audit_floor(
        {"min_exchange_bytes": min(b["nbytes"] for b in layout)})
    assert r["grad_sync_config"]["fuse"] is False
    assert r["grad_sync_config"]["comm_dtype"] == "torch.float32"
    per_leaf = sum(b["mode"] == "per_leaf" for b in layout)
    grouped = len(layout) - per_leaf
    kinds = audit["by_kind"]
    assert kinds["reduce-scatter"]["count"] == kinds["all-gather"]["count"] == per_leaf
    if mesh == "2d":
        # every exchange opens an all-reduce: torus2d's vertical phase, psum
        assert audit["num_exchanges"] == kinds["all-reduce"]["count"] == len(layout)
    else:
        # a 1-D grid has no vertical phase: the reference's max(#RS, #AR)
        assert kinds["all-reduce"]["count"] == grouped
        assert audit["num_exchanges"] == max(per_leaf, grouped)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama3-405b"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_run_one_serves(arch, shape):
    r = dryrun.run_one(arch, shape, False, save=False, quiet=True,
                       mesh_shape=MESHES["2d"], smoke_arch=True)
    assert r["step"] in ("prefill", "decode") and r["bucket_audit"] is None
    assert r["cost"]["flops"] > 0 and r["memory"]["output_bytes"] > 0


def test_train_flops_on_one_rank_equal_a_real_step():
    """At a 1 x 1 mesh each rank's program is the whole step: its FLOPs on
    meta DTensors equal ``FlopCounterMode`` over the same step (remat,
    loss, gradients, the sync, LARS) on real CPU tensors, within 0.1%."""
    arch = "qwen3-1.7b"
    shape = ShapeConfig("tiny", 32, 2, "train")
    cfg = dryrun.arch_for(arch, shape, smoke=True)
    with dryrun.fake_world(1):
        mesh, _ = dryrun._mesh(False, {"data": 1, "model": 1})
        fn, args, _ = dryrun.build_train(arch, cfg, shape, mesh)
        got = dryrun.measure(fn, args)["flops"]

    params = {n: p.detach().requires_grad_(True)
              for n, p in T.init(cfg, seed=0, device="cpu").named_parameters()}
    groups = convert.leaf_groups(params, cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 32))
    gcfg = grad_sync.GradSyncConfig(fuse=False, comm_dtype=torch.float32)
    flops = FlopCounterMode(display=False)
    with flops:
        tree = T.compute_params(T.params_tree(params), cfg.compute_dtype)
        logits, aux = T.forward(tree, tokens, cfg)
        loss = losses.label_smoothing_xent(logits, tokens, 0.1) + 0.01 * aux
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        grads = grad_sync.sync_tree(grads, TorusGrid(), gcfg, groups)
        lars.update(params, grads, lars.init(params), lr=1.0, momentum=0.9, groups=groups)
    want = flops.get_total_flops()
    assert want > 0 and abs(got - want) <= 1e-3 * want, (got, want)


@pytest.mark.parametrize("arch,model", [("gemma-7b", 2), ("qwen3-1.7b", 2), ("qwen3-1.7b", 4)])
def test_train_flops_split_over_the_model_ranks(arch, model):
    """A dense arch's train step at data 1 x model m: a rank's FLOPs are 1/m
    of the 1 x 1 step's, within 0.1%: the matmuls run on their weight
    shards, the attention on the rank's query heads and the loss on its
    vocab shard. Nothing is held whole (``gathered`` empty) but, for
    Qwen3's smoke config at 4 ranks, its 2 kv heads' projections: each
    rank then cuts the kv head its one query head reads."""
    shape = ShapeConfig("tiny", 64, 4, "train")
    cfg = dryrun.arch_for(arch, shape, smoke=True)
    got = {}
    for m in (1, model):
        with dryrun.fake_world(m):
            mesh, _ = dryrun._mesh(False, {"data": 1, "model": m})
            fn, args, _ = dryrun.build_train(arch, cfg, shape, mesh)
            got[m] = dryrun.measure(fn, args)
    held = {"head split: whole heads"} if model > cfg.n_kv_heads else set()
    assert set(got[model]["gathered"]) == held and got[1]["flops"] > 0
    assert abs(got[model]["flops"] * model / got[1]["flops"] - 1) <= 1e-3, (
        got[model]["flops"], got[1]["flops"])


def test_shardwise_attention_and_loss_equal_the_whole(tmp_path):
    """``dtensor.headwise`` and ``dtensor.ls_xent`` on two gloo ranks: the
    attention over each rank's query heads (kv heads sharded where they
    divide over the ranks; else cut from the whole, their gradients summed
    over the ranks) and the loss over each rank's vocab shard give the
    plain whole-tensor outputs and gradients (fp32, within 1e-5 + 1e-5|x|)."""
    from _pt_parity import dtensor_shards_body, launch

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(0)
    cases = {}
    for hkv in (2, 1):                 # 2: sharded with q's; 1: cut for each rank
        q, k, v = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 8, 4, 8), (2, 8, hkv, 8), (2, 8, hkv, 8)))
        cases[f"hkv{hkv}"] = (q, k, v, rng.standard_normal((2, 8, 4, 8)).astype(np.float32))
    logits = (3 * rng.standard_normal((6, 8))).astype(np.float32)
    labels = rng.integers(0, 8, 6)
    got = launch(dtensor_shards_body, tmp_path, cases, logits, labels, 0.1, world=2)[0]

    def close(a, b):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-5, atol=1e-5)

    for name, (q, k, v, cot) in cases.items():
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = ref.flash_attention_ref(q, k, v, causal=True)
        (o * torch.from_numpy(cot)).sum().backward()
        assert any(p.is_shard(2) for p in got[name]["o"]), got[name]["o"]
        for key, want in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            close(got[name][key], want)
    x = torch.from_numpy(logits).requires_grad_()
    per = ops.ls_xent(x, torch.from_numpy(labels), smoothing=0.1)
    per.sum().backward()
    close(got["ls_xent"]["out"], per)
    close(got["ls_xent"]["dx"], x.grad)


def test_full_width_train_at_world_256():
    """Qwen3-1.7B's train_4k on the 16 x 16 production mesh: 256 ranks, remat,
    the reference's exchange schedule of the full config, and a rank's
    FLOPs within 10% of a 256th of the step's matmuls: 8 N T for the
    layers (forward, its recompute, backward), 6 V d T for the tied
    head outside the recomputed blocks, 16 L S H Dh T for the attention's
    two products (the plain attention computes the whole S x S)."""
    r = dryrun.run_one("qwen3-1.7b", "train_4k", False, save=False, quiet=True)
    layout = _ref_layout("qwen3-1.7b", smoke=False)
    assert r["chips"] == 256 and r["mesh"] == "pod16x16"
    assert r["mesh_summary"] == {"data": 16, "model": 16}
    assert r["expected_exchanges"] == len(layout) == 13
    per_leaf = sum(b["mode"] == "per_leaf" for b in layout)
    audit = r["bucket_audit"]
    # a reduce-scatter's output is 1/16 of its leaf: the final norm's 512 B
    # fall under the floor, as they would in the reference's audit
    dropped = audit["dropped"]["by_kind"].get("reduce-scatter", {"count": 0})["count"]
    assert audit["by_kind"]["reduce-scatter"]["count"] + dropped == per_leaf
    assert audit["num_exchanges"] == per_leaf - dropped
    cfg, shape = dryrun.arch_for("qwen3-1.7b", SHAPES["train_4k"]), SHAPES["train_4k"]
    tokens, head = shape.global_batch * shape.seq_len, cfg.vocab * cfg.d_model
    want = (8 * (cfg.num_params() - head) * tokens + 6 * head * tokens
            + 16 * cfg.n_layers * shape.seq_len * cfg.n_heads * cfg.head_dim * tokens) / 256
    assert 0.9 <= r["cost"]["flops"] / want <= 1.1, (r["cost"]["flops"], want)


def test_chaos_train_recovers(tmp_path):
    r = dryrun.chaos_train(3, out_dir=str(tmp_path))
    assert r["completed"] and r["steps"] == 8 and r["loss_finite"]
    assert r["recovery_counters"]["elastic/recoveries"] >= 1
    assert (tmp_path / "chaos_train.json").exists()


def test_bucket_sweep_needs_a_fabric(tmp_path):
    with pytest.raises(SystemExit, match="needs the fabric"):
        dryrun.main(["--sweep-bucket-bytes", "--arch", "qwen3-1.7b", "--smoke-arch"])
    dryrun.main(["--sweep-bucket-bytes", "--arch", "qwen3-1.7b", "--smoke-arch",
                 "--link-bw", "5e10", "--latency-s", "1e-6", "--backward-seconds", "0.04",
                 "--out", str(tmp_path)])
    out = json.loads((tmp_path / "bucket_sweep__qwen3-1.7b__pod16x16.json").read_text())
    assert all(out["checks"].values()) and out["chips"] == 256


def test_train_bytes_on_one_rank_equal_a_real_step():
    """At a 1 x 1 mesh the bytes a rank's program moves (``measure``'s
    ``bytes_accessed``: each op's inputs and outputs, the kernels as they
    move theirs) on meta DTensors equal the same count over the same step
    on real CPU tensors, within 0.1%: DTensor's shape propagation adds
    nothing, and the attention, the loss and LARS count as their kernels
    on both."""
    from repro_torch.launch import hlo_stats

    arch = "qwen3-1.7b"
    shape = ShapeConfig("tiny", 32, 2, "train")
    cfg = dryrun.arch_for(arch, shape, smoke=True)
    with dryrun.fake_world(1):
        mesh, _ = dryrun._mesh(False, {"data": 1, "model": 1})
        fn, args, _ = dryrun.build_train(arch, cfg, shape, mesh)
        got = dryrun.measure(fn, args)

    params = {n: p.detach().requires_grad_(True)
              for n, p in T.init(cfg, seed=0, device="cpu").named_parameters()}
    groups = convert.leaf_groups(params, cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 32))
    gcfg = grad_sync.GradSyncConfig(fuse=False, comm_dtype=torch.float32)
    mom = lars.init(params)           # made before the step, as the dry run's arguments
    rec = hlo_stats.Recorder()
    with rec:
        tree = T.compute_params(T.params_tree(params), cfg.compute_dtype)
        logits, aux = T.forward(tree, tokens, cfg)
        loss = losses.label_smoothing_xent(logits, tokens, 0.1) + 0.01 * aux
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        grads = grad_sync.sync_tree(grads, TorusGrid(), gcfg, groups)
        lars.update(params, grads, mom, lr=1.0, momentum=0.9, groups=groups)
    want = rec.bytes_accessed
    assert set(got["kernel_bytes"]) == set(rec.kernel_bytes) == {
        "flash_attn", "flash_attn_bwd", "ls_xent_fwd", "ls_xent_bwd", "lars_update"}
    assert want > 0 and abs(got["bytes_accessed"] - want) <= 1e-3 * want, (
        got["bytes_accessed"], want)
    for name, n in rec.kernel_bytes.items():
        assert abs(got["kernel_bytes"][name] - n) <= 1e-3 * n, (name, got["kernel_bytes"], n)


def test_attention_counts_as_the_flash_kernels():
    """Under the recorder the plain attention's bytes are those the flash
    kernels move: forward q, k, v, o and each row's fp32 lse; backward q,
    k, v, o, dO and lse in, dq, dk, dv out. Its output, gradients and
    FLOPs are autograd's over the plain attention."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import hlo_stats

    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 2, 16, 4, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
               for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    do = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    rec, flops = hlo_stats.Recorder(), FlopCounterMode(display=False)
    with flops, rec:
        o = ops.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(o, (q, k, v), do)
    plain_flops = FlopCounterMode(display=False)
    with plain_flops:
        o_ref = ref.flash_attention_ref(q, k, v, causal=True)
        want = torch.autograd.grad(o_ref, (q, k, v), do)
    qb, kvb, lse = B * S * H * D * 4, B * S * Hkv * D * 4, B * H * S * 4
    assert rec.kernel_bytes == {"flash_attn": 2 * qb + 2 * kvb + lse,
                                "flash_attn_bwd": 4 * qb + 4 * kvb + lse}
    assert rec.bytes_accessed == sum(rec.kernel_bytes.values())
    assert flops.get_total_flops() == plain_flops.get_total_flops() > 0
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen3-1.7b"])
def test_embedding_gradient_takes_no_index_put(arch):
    """The table's gradient is added into each rank's vocab rows
    (``index_add``), not by ``index_put`` on DTensors, whose rule some
    torch versions refuse for the FSDP table (vocab over ``model``, d
    over ``data``)."""
    shape = SHAPES["train_4k"]
    cfg = dryrun.arch_for(arch, shape, smoke=True)
    with dryrun.fake_world(8):
        mesh, _ = dryrun._mesh(False, MESHES["1d"])
        fn, args, _ = dryrun.build_train(arch, cfg, shape, mesh)
        ops = dryrun.measure(fn, args)["recorder"].ops
    assert not {"aten.index_put", "aten.index_put_", "aten._index_put_impl_"} & set(ops), ops
    assert ops["aten.index_add_"] >= 1


def test_row_gathers_and_rglru_gates_equal_the_whole(tmp_path):
    """On a (data 2, model 2) mesh of four gloo ranks: ``vocab_lookup`` of
    rows split over ``data`` in a table placed as FSDP, as tensor
    parallelism and with d over ``model``; ``take_rows`` with its gradient
    split over the slots and the trailing dim; and the RG-LRU gates with
    the scan through ``dtensor.elementwise``, placed as the dry run places them,
    give the plain whole-tensor outputs and gradients (fp32, within 1e-5
    + 1e-5|x|)."""
    from _pt_parity import dtensor_rows_body, launch

    from repro_torch.nn import rglru

    rng = np.random.default_rng(1)
    f32 = np.float32
    table = rng.standard_normal((8, 6)).astype(f32)
    ids = rng.integers(0, 8, (4, 5))
    cot = rng.standard_normal((4, 5, 6)).astype(f32)
    rows = rng.standard_normal((6, 4)).astype(f32)
    idx = rng.integers(0, 6, (4, 3))
    rows_cot = rng.standard_normal((4, 3, 4)).astype(f32)
    w = 4
    rg = {"x": rng.standard_normal((2, 6, w)).astype(f32),
          "rg_kernel": (rng.standard_normal((w, w)) / 2).astype(f32),
          "ig_kernel": (rng.standard_normal((w, w)) / 2).astype(f32),
          "rg_bias": rng.standard_normal(w).astype(f32),
          "ig_bias": rng.standard_normal(w).astype(f32),
          "lambda_param": rng.standard_normal(w).astype(f32),
          **{f"cot_{n}": rng.standard_normal((2, 6, w)).astype(f32) for n in ("a", "bx", "h")}}
    got = launch(dtensor_rows_body, tmp_path, table, ids, cot, rows, idx, rows_cot, rg,
                 world=4)[0]

    def close(a, b):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-5, atol=1e-5)

    t = torch.from_numpy(table).requires_grad_()
    y = t[torch.from_numpy(ids)]
    (y * torch.from_numpy(cot)).sum().backward()
    for name in ("fsdp", "tp", "d_model"):
        close(got[f"lookup_{name}"]["out"], y)
        close(got[f"lookup_{name}"]["dtable"], t.grad)
    r = torch.from_numpy(rows).requires_grad_()
    y = r[torch.from_numpy(idx)]
    (y * torch.from_numpy(rows_cot)).sum().backward()
    close(got["take_rows"]["out"], y)
    close(got["take_rows"]["drows"], r.grad)
    p = {n: torch.from_numpy(rg[n]).requires_grad_()
         for n in ("rg_kernel", "ig_kernel", "rg_bias", "ig_bias", "lambda_param")}
    x = torch.from_numpy(rg["x"]).requires_grad_()
    a, bx = rglru._gates(p, x, rglru.RGLRUConfig(d_model=w))
    h = rglru._scan(a, bx)
    sum((t * torch.from_numpy(rg[f"cot_{n}"])).sum()
        for n, t in (("a", a), ("bx", bx), ("h", h))).backward()
    for key, want in (("a", a), ("bx", bx), ("h", h), ("dx", x.grad),
                      *((f"d{n}", t.grad) for n, t in p.items())):
        close(got["rglru"][key], want)
