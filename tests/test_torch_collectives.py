"""The port's all-reduce strategies (``repro_torch/core/collectives.py``) on
8 gloo ranks against the JAX package's on its 8 CPU devices.

One launch (``tests/_pt_parity.py``) runs every strategy x lowering on a
2 x 4 and a 1 x 8 grid of ranks; each test compares one case with
``repro.core.collectives.all_reduce`` under ``shard_map`` on the same
per-rank inputs. Integer-valued inputs sum exactly in any order, in fp32
and in bf16, so those cases must be equal; random fp32 inputs are summed
in another order by gloo than by XLA, so they are held to 8 ulps of the
sum of magnitudes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _pt_parity import collectives_body, launch
from repro.compat import shard_map
from repro.core import collectives as jC
from repro.core import topology as jtopo
from repro_torch.core import collectives as tC
from repro_torch.core import topology as ttopo

pytestmark = pytest.mark.multidevice

STRATEGIES = ["psum", "ring", "hierarchical", "torus2d"]
LOWERINGS = ["xla", "ring"]
GRIDS = {(2, 4): (("dy", "dx"), jtopo.TorusGrid(h_axes=("dx",), v_axes=("dy",))),
         (8,): (("data",), jtopo.select_grid(("data",)))}


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "f32": (rng.randn(8, 16, 3).astype(np.float32), torch.float32),
        "f32_int": ((np.arange(8 * 24).reshape(8, 24) % 7 - 3).astype(np.float32),
                    torch.float32),
        "bf16_int": ((np.arange(8 * 64).reshape(8, 8, 8) % 5).astype(np.float32),
                     torch.bfloat16),
    }


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return launch(collectives_body, tmp_path_factory.mktemp("coll"), list(GRIDS), _inputs())


def _jax_all_reduce(sizes, strategy, lowering, inputs):
    axes, grid = GRIDS[sizes]
    mesh = jax.make_mesh(sizes, axes)
    spec = P(grid.axes)

    @functools.partial(shard_map, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    def f(*xs):
        return tuple(jC.all_reduce(x[0], grid, strategy, lowering)[None] for x in xs)

    args = [jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
            for a, dtype in inputs.values()]
    return [np.asarray(o, np.float32) for o in jax.jit(f)(*args)]


@pytest.mark.parametrize("sizes", list(GRIDS), ids=["2x4", "1x8"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_strategy_matches_the_reference_on_every_rank(port, sizes, strategy, lowering):
    inputs = _inputs()
    want = _jax_all_reduce(sizes, strategy, lowering, inputs)
    for (name, (a, _)), w in zip(inputs.items(), want):
        for r in range(8):
            got = port[r][sizes, strategy, lowering, name]
            if name == "f32":
                # another summation order: 8 ulps of sum |x_r|
                tol = 8 * 2.0 ** -24 * np.abs(a).sum(0)
                assert np.all(np.abs(got - w[r]) <= tol), (name, r)
            else:
                np.testing.assert_array_equal(got, w[r], err_msg=f"{name} rank {r}")
                np.testing.assert_array_equal(got, a.sum(0), err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("sizes", list(GRIDS), ids=["2x4", "1x8"])
@pytest.mark.parametrize("ring", ["h", "world"])
def test_ring_lowering_keeps_the_library_chunk_convention(port, sizes, ring):
    """The ring reduce-scatter, re-aligned by one hop, leaves rank i with
    chunk i, as ``reduce_scatter_tensor`` does; its all-gather undoes it
    (``tests/test_collectives.py::test_ring_rs_ag_roundtrip_convention``)."""
    a = _inputs()["f32"][0]
    n = 8 if ring == "world" else sizes[-1]
    c = a.shape[1] // n
    for r in range(8):
        res = port[r]
        i = r if ring == "world" else r % sizes[-1]
        members = range(8) if ring == "world" else range(r - i, r - i + n)
        want = a[list(members)].sum(0)[i * c:(i + 1) * c]
        np.testing.assert_allclose(res[sizes, ring, "rs_ring"], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res[sizes, ring, "rs_ring"], res[sizes, ring, "rs_xla"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(res[sizes, ring, "ag_ring"], res[sizes, ring, "ag_xla"],
                                   rtol=0, atol=1e-5)


def test_groups_of_one_return_their_input():
    """A ring of one is the identity, as ``_axis_size(axis) == 1`` is there."""
    x = torch.arange(6.0)
    solo = ttopo.Ring((0,))
    for ex in (tC._rs(x, solo, "ring"), tC._ag(x, solo, "xla"), tC._ar(x, solo, "ring"),
               tC.ring_reduce_scatter(x, solo), tC.ring_all_gather(x, solo)):
        assert tC.run([ex])[0] is x
    for strategy in STRATEGIES:
        for lowering in LOWERINGS:
            assert tC.all_reduce(x, ttopo.TorusGrid(), strategy, lowering) is x
    with pytest.raises(ValueError, match="unknown strategy"):
        tC.all_reduce(x, ttopo.TorusGrid(), "tree")
    with pytest.raises(ValueError, match="unknown lowering"):
        tC.all_reduce(x, ttopo.TorusGrid(), "ring", "nccl")


@pytest.mark.parametrize("n", [1, 2, 7, 8, 12, 16, 36, 256, 1024, 2048, 2176, 3456, 4096])
def test_factorize_and_table4_equal_the_reference(n):
    assert ttopo.factorize(n) == jtopo.factorize(n)
    assert ttopo.paper_table4_grid(n) == jtopo.paper_table4_grid(n)


def test_select_grid_orients_as_the_reference():
    g = ttopo.select_grid((2, 4))
    assert (g.x, g.y, g.size, g.sizes()) == (4, 2, 8, (4, 2))
    assert [g.coords(r) for r in (0, 3, 4, 7)] == [(0, 0), (0, 3), (1, 0), (1, 3)]
    assert (ttopo.select_grid((8,)).x, ttopo.select_grid((8,)).y) == (8, 1)
    with pytest.raises(ValueError):
        ttopo.select_grid(())
    assert ttopo.world_grid().size == 1       # no process group here
    with pytest.raises(RuntimeError, match="torch.distributed"):
        ttopo.select_grid((2, 4)).build()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("x,y", [(1, 1), (4, 1), (4, 2), (16, 16), (64, 54)])
def test_cost_models_equal_the_reference(strategy, x, y):
    for nbytes in (1, 4096, 100e6, 51_005_824):
        for bw, lat in ((50e9, 1e-6), (450e9, 5e-6)):
            assert tC.comm_cost_model(strategy, nbytes, x, y, bw, lat) == \
                jC.comm_cost_model(strategy, nbytes, x, y, bw, lat)
            for bucket in (0, 1 << 20, 4 << 20, 1 << 30):
                for bwd in (0.0, 0.04):
                    assert tC.bucketed_comm_cost_model(strategy, nbytes, bucket, x, y, bw,
                                                       lat, bwd) == \
                        jC.bucketed_comm_cost_model(strategy, nbytes, bucket, x, y, bw,
                                                    lat, bwd)
    with pytest.raises(ValueError):
        tC.comm_cost_model("tree", 1, x, y, 1.0, 1.0)
