"""``launch/mesh.py`` against ``repro/launch/mesh.py``.

For the ten full configs on both production meshes, FSDP off and on,
every port leaf's spec equals the reference's ``param_pspecs`` of its
stacked leaf (on ``jax.eval_shape`` of the reference's init and
``tests/test_launch.py``'s ``FakeMesh``) less the block dimension; the
same for ``cache_pspecs`` at ``decode_32k`` and ``long_500k``. The meshes
are built on torch's ``fake`` process group at 256 and 512 ranks, and the
specs become DTensor placements on them. Shapes only: nothing is
allocated on either side (meta tensors here, ShapeDtypeStructs there).
"""

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jregistry
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import long_context_variant as jlong
from repro.launch import mesh as jmesh
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, long_context_variant
from repro_torch.launch import dryrun, mesh
from repro_torch.models import transformer as T

ARCHS = tuple(registry.ARCH_IDS)
MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class SizedMesh:
    """The port's functions read ``mesh_dim_names`` and ``shape``; this
    stands in for a ``DeviceMesh`` of the same sizes without a process
    group."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def _at(tree, dotted):
    for key in dotted.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def _less_block(spec, stacked):
    spec = tuple(spec)
    if stacked and spec:
        assert spec[0] is None
        return spec[1:]
    return spec


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(arch, multi_pod, fsdp):
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    sizes = MESHES[multi_pod]
    want = jmesh.param_pspecs(jax.eval_shape(lambda: jT.init(jax.random.key(0), jcfg)),
                              fsdp=fsdp, mesh=FakeMesh(sizes))
    params = dict(T.init(cfg, device="meta").named_parameters())
    got = mesh.param_pspecs(params, cfg, fsdp=fsdp, mesh=SizedMesh(sizes))
    assert set(got) == set(params)
    n_ref = len(jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert len({convert.reference_name(n, cfg)[0] for n in params}) == n_ref
    sharded = 0
    for name, spec in got.items():
        jname, _ = convert.reference_name(name, cfg)
        assert spec == _less_block(_at(want, jname), jname.startswith("blocks.")), name
        sharded += bool(spec)
    assert sharded > 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_references(arch, shape, multi_pod):
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    jshape, tshape = JSHAPES[shape], SHAPES[shape]
    if shape == "long_500k":
        jcfg, cfg = jlong(jcfg), long_context_variant(cfg)
    sizes = MESHES[multi_pod]
    dp = tuple(a for a in sizes if a != "model")
    jcache = jax.eval_shape(lambda: jT.init_cache(jcfg, jshape.global_batch, jshape.seq_len))
    want = jmesh.cache_pspecs(jcache, dp, FakeMesh(sizes))
    cache = T.init_cache(cfg, tshape.global_batch, tshape.seq_len, device="meta")
    got = mesh.cache_pspecs(cache, dp, SizedMesh(sizes))
    assert len(got) == cfg.n_layers
    for i, layer in enumerate(got):
        for key, spec in layer.items():
            jname, _ = convert.reference_name(f"layers.{i}.{key}", cfg)
            stacked = jname.startswith("blocks.")
            assert spec == _less_block(_at(want, jname), stacked), (i, key)
            assert cache[i][key].shape == _at(jcache, jname).shape[1 if stacked else 0:]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_on_the_fake_group(multi_pod):
    world = 512 if multi_pod else 256
    with dryrun.fake_world(world):
        m = mesh.make_production_mesh(multi_pod=multi_pod)
        assert m.mesh_dim_names == tuple(MESHES[multi_pod])
        assert tuple(m.shape) == tuple(MESHES[multi_pod].values()) and m.size() == world
        assert mesh.dp_axes_of(m) == tuple(a for a in MESHES[multi_pod] if a != "model")
        assert mesh.mesh_sizes(m) == MESHES[multi_pod]
        cfg = registry.get("granite-moe-3b-a800m")
        params = dict(T.init(cfg, device="meta").named_parameters())
        specs = mesh.param_pspecs(params, cfg, mesh=m)
        up = "layers.1.mlp.experts.up"          # (40, d, f): 40 experts do not divide 16
        assert specs[up] == (None, "model", None)
        assert mesh.placements(specs[up], m)[-1] == Shard(1)
        assert all(p == Replicate() for p in mesh.placements(specs[up], m)[:-1])
        dt = mesh.with_shardings({up: params[up]}, m, specs)[up]
        assert dt.shape == params[up].shape and dt.to_local().shape[1] == cfg.d_model // 16
        assert dt.device.type == "meta"
    f = mesh.placements((("pod", "data"), None, "model"), SizedMesh(MESHES[True]))
    assert f == [Shard(0), Shard(0), Shard(2)]


def test_factorized_mesh_on_the_fake_group():
    with dryrun.fake_world(256):
        m = mesh.make_factorized_mesh()
        assert m.mesh_dim_names == ("data_y", "data_x", "model")
        assert tuple(m.shape) == (4, 4, 16)
        assert mesh.dp_axes_of(m) == ("data_y", "data_x")


def test_meta_init_has_the_reference_shapes():
    """``init(device="meta")`` (the reference's ``eval_shape``) allocates
    nothing and gives every leaf its per-layer shape of the stacked tree."""
    cfg = registry.get("recurrentgemma-9b")
    params = dict(T.init(cfg, device="meta").named_parameters())
    ref = jax.eval_shape(lambda: jT.init(jax.random.key(0), jregistry.get(cfg.name)))
    for name, t in params.items():
        jname, _ = convert.reference_name(name, cfg)
        want = _at(ref, jname)
        assert t.device.type == "meta" and t.dtype == torch.float32
        assert tuple(t.shape) == tuple(want.shape[1 if jname.startswith("blocks.") else 0:])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_each_model_column_gets_its_own_dp_grid(multi_pod):
    """The manual sync's grid is the DP ranks of this rank's model column,
    (dy, dx) in row-major order of the DP dims (the reference's
    ``select_grid(dp)``: the last DP dim horizontal); every rank builds the
    groups of every column (``TorusGrid.build(members=)``)."""
    with dryrun.fake_world(512 if multi_pod else 256):
        m = mesh.make_production_mesh(multi_pod=multi_pod)
        grid = dryrun._dp_grid(m, mesh.dp_axes_of(m))
    if multi_pod:
        assert (grid.y, grid.x) == (2, 16)
        assert grid.world.ranks == tuple(range(0, 512, 16))
        assert grid.h.ranks == tuple(range(0, 256, 16)) and grid.v.ranks == (0, 256)
    else:
        assert (grid.y, grid.x) == (1, 16)
        assert grid.world.ranks == grid.h.ranks == tuple(range(0, 256, 16))
        assert grid.v.ranks == (0,)
    assert grid.world.index == 0 and grid.world.group is not None
