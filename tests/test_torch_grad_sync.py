"""The port's gradient sync (``repro_torch/core/grad_sync.py``) and bucket
autotuning (``core/autotune.py``) against the JAX package's.

``bucket_layout`` must give the reference's exchanges, dict for dict, from
the port's ``{name: tensor}`` gradients (module paths, ``named_parameters``
order, OIHW kernels). ``sync_tree`` and ``resolve_sync_config`` run on 8
gloo ranks (``tests/_pt_parity.py``, one launch) and are compared with the
reference under ``shard_map`` on its 8 CPU devices, on the same per-rank
gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _pt_parity import grad_sync_body, launch
from repro.compat import shard_map
from repro.core import autotune as jautotune
from repro.core import grad_sync as jgs
from repro.core.topology import TorusGrid as JGrid
from repro.models import resnet as jresnet
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import autotune as tautotune
from repro_torch.core import collectives as tcollectives
from repro_torch.core import grad_sync as tgs
from repro_torch.core import topology as ttopo
from repro_torch.models import resnet as tresnet

STRATEGIES = ["psum", "ring", "hierarchical", "torus2d"]
LOWERINGS = ["xla", "ring"]
POD = dict(link_bw=jautotune.TPU_POD_HW.link_bw, latency_s=jautotune.TPU_POD_HW.latency_s,
           backward_seconds=jautotune.TPU_POD_HW.backward_seconds,
           name=jautotune.TPU_POD_HW.name)


# ------------------------------------------------------------ bucket layout --

def _meta_params(cfg):
    with torch.device("meta"):     # shapes only, no weights drawn
        return dict(tresnet.ResNet(cfg, torch.Generator(device="cpu")).named_parameters())


MODELS = {
    "resnet50": (jresnet.ResNetConfig.resnet50(), tresnet.ResNetConfig.resnet50()),
    "tiny": (jresnet.ResNetConfig.tiny(), tresnet.ResNetConfig.tiny()),
}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("bucket_bytes", [0, 1 << 20, 4 << 20])
@pytest.mark.parametrize("fuse", [True, False])
def test_bucket_layout_equals_the_reference(model, bucket_bytes, fuse):
    jcfg, tcfg = MODELS[model]
    jshapes = jax.eval_shape(lambda: jresnet.init(jax.random.key(0), jcfg))
    want = jgs.bucket_layout(jshapes, jgs.GradSyncConfig(bucket_bytes=bucket_bytes,
                                                         fuse=fuse))
    got = tgs.bucket_layout(_meta_params(tcfg),
                            tgs.GradSyncConfig(bucket_bytes=bucket_bytes, fuse=fuse))
    assert got == want


def test_resnet50_layout_at_4_mib_is_eleven_exchanges():
    layout = tgs.bucket_layout(_meta_params(tresnet.ResNetConfig.resnet50()),
                               tgs.GradSyncConfig(bucket_bytes=4 << 20))
    comm = [b for b in layout if b["group"] == "comm"]
    fp32 = [b for b in layout if b["group"] == "fp32"]
    assert (len(comm), len(fp32)) == (10, 1)
    assert sum(b["nbytes"] for b in comm) == 51_005_824
    assert sum(b["num_leaves"] for b in comm) == 54
    assert (fp32[0]["nbytes"], fp32[0]["num_leaves"]) == (216_480, 107)
    # reverse flatten order: the stem, whose gradient lands last in
    # backward, is issued first; the head closes the bf16 buckets
    assert layout[0]["paths"][0] == "stem/conv/kernel"
    assert comm[-1]["paths"][-1] == "head/kernel"


def _tree(rng, lead=()):
    """A gradient tree in the JAX layout with a list of 12 blocks (so
    "10" must sort after "9"), BN and bias leaves, and a dense head."""
    def r(*shape):
        return rng.randn(*lead, *shape).astype(np.float32)
    return {
        "stem": {"conv": {"kernel": r(3, 3, 3, 8)},
                 "bn": {"bn_scale": r(8), "bn_bias": r(8)}},
        "blocks": [{"conv": {"kernel": r(1, 1, 8, 8)}, "bn": {"bn_scale": r(8)}}
                   for _ in range(12)],
        "head": {"kernel": r(8, 10), "bias": r(10)},
    }


@pytest.mark.parametrize("fuse", [True, False])
def test_leaf_order_sorts_list_indices_by_number(fuse):
    tree = _tree(np.random.RandomState(0))
    cfg = dict(bucket_bytes=512, fuse=fuse, small_leaf_threshold=64)
    got = tgs.bucket_layout(params_from_jax(tree, device="cpu"), tgs.GradSyncConfig(**cfg))
    assert got == jgs.bucket_layout(tree, jgs.GradSyncConfig(**cfg))
    paths = [p for b in got for p in b["paths"]]
    assert paths.index("blocks/10/conv/kernel") < paths.index("blocks/9/conv/kernel")


def test_sync_on_one_rank_casts_and_returns_every_leaf():
    tree = _tree(np.random.RandomState(1))
    g = params_from_jax(tree, device="cpu")
    out = tgs.sync_tree(g, ttopo.TorusGrid(), tgs.GradSyncConfig(comm_dtype=torch.float32))
    assert list(out) == list(g) and all(torch.equal(out[k], g[k]) for k in g)
    out = tgs.sync_tree(g, ttopo.TorusGrid(), tgs.GradSyncConfig())
    for k in g:   # bf16 round trip on the comm group, fp32 on BN and biases
        want = g[k] if ("bn" in k or "bias" in k) else g[k].bfloat16().float()
        assert torch.equal(out[k], want), k


def test_unresolved_auto_is_refused():
    g = {"w": torch.ones(4, 4)}
    with pytest.raises(ValueError, match="not resolved"):
        tgs.sync_tree(g, ttopo.TorusGrid(), tgs.GradSyncConfig(bucket_bytes=tgs.AUTO))
    with pytest.raises(ValueError, match="HardwareModel"):
        tgs.resolve_sync_config(tgs.GradSyncConfig(bucket_bytes=tgs.AUTO), ttopo.TorusGrid())
    cfg, events = tgs.resolve_sync_config(tgs.GradSyncConfig(bucket_bytes=tgs.AUTO),
                                          ttopo.TorusGrid(),
                                          hw=tautotune.HardwareModel(**POD))
    assert cfg.bucket_bytes == 0 and events[0]["event"] == "bucket_autotune"


# ------------------------------------------------- sync_tree on 8 ranks --

SYNC_CASES = {(s, lo, fuse, "bf16"): dict(strategy=s, lowering=lo, fuse=fuse,
                                          bucket_bytes=512, small_leaf_threshold=64)
              for s in STRATEGIES for lo in LOWERINGS for fuse in (True, False)}
SYNC_CASES.update({(s, "xla", True, "fp32"): dict(strategy=s, comm_dtype=torch.float32,
                                                  bucket_bytes=512)
                   for s in STRATEGIES})

RESOLVE_CASES = {
    "torus2d_dx_down": (dict(), dict(down_axes=("dx",))),
    "torus2d_ring_dy_down": (dict(lowering="ring"), dict(down_axes=("dy",))),
    "hierarchical_up": (dict(strategy="hierarchical"), dict()),
    "auto_params": (dict(bucket_bytes="auto"), dict(hw=POD, params_like=True)),
    "auto_knee": (dict(bucket_bytes="auto"), dict(hw=POD)),
    "auto_dx_down": (dict(bucket_bytes="auto"), dict(hw=POD, params_like=True,
                                                    down_axes=("dx",))),
    # the trainer's re-resolve after a permanent failure mid-run
    "torus2d_dy_down_elastic": (dict(), dict(down_axes=("dy",), context="elastic")),
    "auto_dx_down_elastic": (dict(bucket_bytes="auto"),
                             dict(hw=POD, params_like=True, down_axes=("dx",),
                                  context="elastic")),
}


def _jax_cfg(kw):
    kw = dict(kw)
    if kw.get("comm_dtype") == torch.float32:
        kw["comm_dtype"] = jnp.float32
    return jgs.GradSyncConfig(**kw)


@pytest.fixture(scope="module")
def grads():
    return _tree(np.random.RandomState(2), lead=(8,))


@pytest.fixture(scope="module")
def port(grads, tmp_path_factory):
    per_rank = [params_from_jax(jax.tree.map(lambda a, r=r: a[r], grads), device="cpu")
                for r in range(8)]
    stacked = {k: np.stack([pr[k].numpy() for pr in per_rank]) for k in per_rank[0]}
    return launch(grad_sync_body, tmp_path_factory.mktemp("sync"), (2, 4), stacked,
                  SYNC_CASES, RESOLVE_CASES)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((2, 4), ("dy", "dx"))


GRID = JGrid(h_axes=("dx",), v_axes=("dy",))


@pytest.mark.multidevice
@pytest.mark.parametrize("key", list(SYNC_CASES), ids=lambda k: "-".join(map(str, k)))
def test_sync_tree_matches_the_reference_on_8_ranks(port, grads, mesh, key):
    cfg = _jax_cfg(SYNC_CASES[key])
    spec = P(("dy", "dx"))

    @functools.partial(shard_map, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    def f(tree):
        local = jax.tree.map(lambda a: a[0], tree)
        return jax.tree.map(lambda a: a[None], jgs.sync_tree(local, GRID, cfg))

    want = jax.tree.map(np.asarray, jax.jit(f)(grads))
    # |terms| of the sum: each rank's gradient, pre-scaled by 1/8
    mag = jax.tree.map(lambda a: np.abs(a).sum(0) / 8, grads)
    bf16 = key[-1] == "bf16"
    for r in range(8):
        got = params_to_jax({k: torch.from_numpy(v)
                             for k, v in port[r]["synced"][key].items()})

        def close(path, g, w, m):
            bn = any(t in jax.tree_util.keystr(path) for t in ("bn", "bias"))
            # two orders of 7 additions, each rounding by at most a unit of
            # its partial sum (bf16 2^-9, fp32 2^-24), differ by at most
            # 14 units of sum |terms|: < 2^-5 sum |terms| in bf16, 2^-20 in fp32
            tol = (2.0 ** -5 if bf16 and not bn else 2.0 ** -20) * m
            assert np.all(np.abs(g - w[r]) <= tol), (key, r, jax.tree_util.keystr(path))

        jax.tree_util.tree_map_with_path(close, got, want, mag)


@pytest.mark.multidevice
@pytest.mark.parametrize("key", list(RESOLVE_CASES))
def test_resolve_sync_config_events_equal_the_reference(port, grads, mesh, key):
    kw, rkw = RESOLVE_CASES[key]
    rkw = dict(rkw)
    if "hw" in rkw:
        rkw["hw"] = jautotune.TPU_POD_HW
    if rkw.pop("params_like", False):
        rkw["params_like"] = jax.tree.map(lambda a: a[0], grads)
    cfg, events = jgs.resolve_sync_config(_jax_cfg(kw), GRID, mesh, ("dy", "dx"), **rkw)
    for r in range(8):
        got_cfg, got_events = port[r]["resolved"][key]
        assert got_events == events, r
        assert got_cfg == {"strategy": cfg.strategy, "bucket_bytes": cfg.bucket_bytes}


def test_a_wrong_probe_on_one_rank_downgrades_every_rank_alike(port):
    """Rank 3 alone reads a wrong sum from torus2d's probe: the verdict is
    the world's, so all 8 ranks reject torus2d and pick hierarchical."""
    want_events = [
        {"event": "grad_sync_strategy_rejected", "strategy": "torus2d",
         "reason": "probe: the all-reduce of ones missed 8 on 1 of 8 ranks",
         "context": "startup"},
        {"event": "grad_sync_downgrade", "from": "torus2d", "to": "hierarchical",
         "context": "startup"}]
    for r in range(8):
        assert port[r]["probe_fault"] == ("hierarchical", want_events), r


def test_a_probe_that_raises_ends_the_run(monkeypatch):
    """A collective that fails leaves its group unusable: the fault
    propagates instead of degrading to the next strategy."""
    def broken(*args, **kwargs):
        raise RuntimeError("connection reset")

    monkeypatch.setattr(tcollectives, "all_reduce", broken)
    with pytest.raises(RuntimeError, match="connection reset"):
        tgs.resolve_sync_config(tgs.GradSyncConfig(), ttopo.TorusGrid())


def test_the_schedule_is_built_once_for_a_signature():
    g = params_from_jax(_tree(np.random.RandomState(3)), device="cpu")
    cfg = tgs.GradSyncConfig(bucket_bytes=512)
    tgs.sync_tree(g, ttopo.TorusGrid(), cfg)
    before = tgs._schedule.cache_info()
    out = tgs.sync_tree({k: v + 1 for k, v in g.items()}, ttopo.TorusGrid(), cfg)
    after = tgs._schedule.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)
    for k in g:   # bf16 round trip on the comm group, fp32 on BN and biases
        want = g[k] + 1 if ("bn" in k or "bias" in k) else (g[k] + 1).bfloat16().float()
        assert torch.equal(out[k], want), k
    tgs.sync_tree({k: v.double() for k, v in g.items()}, ttopo.TorusGrid(), cfg)
    assert tgs._schedule.cache_info().misses == after.misses + 1   # new dtypes


# ----------------------------------------------------------------- autotune --


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("x,y", [(1, 1), (4, 2), (16, 16)])
def test_autotune_equals_the_reference_given_its_hardware(strategy, x, y):
    thw, jhw = tautotune.HardwareModel(**POD), jautotune.TPU_POD_HW
    assert tautotune.analytic_knee_bytes(strategy, x, y, thw) == \
        jautotune.analytic_knee_bytes(strategy, x, y, jhw)
    for knee, total in ((1 << 20, None), (300_000, 51_005_824), (5, 100)):
        assert tautotune.candidate_bucket_bytes(knee, total) == \
            jautotune.candidate_bucket_bytes(knee, total)
    for total in (None, 0, 216_480, 51_005_824):
        assert tautotune.recommend_bucket_bytes(strategy, x, y, thw, total_bytes=total) == \
            jautotune.recommend_bucket_bytes(strategy, x, y, jhw, total_bytes=total)
    rows = [{"bucket_bytes": b, "exposed_seconds": e, "num_exchanges": n}
            for b, e, n in ((0, 3e-3, 1), (1 << 20, 1e-3, 12), (4 << 20, 1.02e-3, 3),
                            (16 << 20, 2e-3, 1))]
    assert tautotune.sweep_bracket(rows) == jautotune.sweep_bracket(rows)
    for pick in (0, 1 << 20, 8 << 20, 1 << 30):
        br = jautotune.sweep_bracket(rows)
        assert tautotune.pick_within_bracket(pick, br) == jautotune.pick_within_bracket(pick, br)
    assert tautotune.refine_from_sweep(rows, strategy, x, y, thw, total_bytes=51_005_824) == \
        jautotune.refine_from_sweep(rows, strategy, x, y, jhw, total_bytes=51_005_824)


def test_hardware_model_has_no_default_fabric():
    with pytest.raises(TypeError):
        tautotune.HardwareModel()
    assert not hasattr(tautotune, "TPU_POD_HW")
