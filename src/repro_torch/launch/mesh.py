"""Production meshes and parameter placements (``repro/launch/mesh.py``), on
``torch.distributed.device_mesh``.

``make_production_mesh``: the fixed target, 16 x 16 = 256 ranks a pod
(``data`` x ``model``), or 2 pods = 512 ranks with ``pod`` leading.
``make_factorized_mesh``: one pod with the data dim split into the 2D
torus's (``data_y``, ``data_x``) rings. Each builds on the process group
that is initialised: NCCL ranks on cards, or torch's ``fake`` group, which
stands in for 256 or 512 ranks in one process (the dry run and the tests).

``param_pspecs``: the reference's path rules (Megatron-style tensor
parallelism over ``model``, optional FSDP over ``data``) for the port's
leaves. The reference's transformer stacks each repeated layer's leaf over
its blocks and right-aligns a rule against the stacked leaf; the port
keeps a leaf a layer. So a leaf is matched under its reference name
(``convert.reference_name``: ``blocks/<j>/...``, ``prefix/<i>/...``), the
rule is aligned and fixed up against the stacked shape, and the block
dimension, which no rule shards, is dropped. A spec is the reference's
``PartitionSpec`` as a tuple: an entry a dimension, each a mesh dim name,
a tuple of names, or None. ``placements`` turns it into DTensor
placements and ``with_shardings`` distributes tensors (meta ones in the
dry run) with them. ``cache_pspecs`` does the same for the per-layer
caches of ``models/transformer.py:init_cache``.
"""

from __future__ import annotations

import math
import re

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch import convert


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_factorized_mesh(*, data_y: int = 4, data_x: int = 4,
                         model: int = 16) -> DeviceMesh:
    """Single-pod mesh with the data dim factorized into the 2D torus."""
    return init_device_mesh(_device_type(), (data_y, data_x, model),
                            mesh_dim_names=("data_y", "data_x", "model"))


def dp_axes_of(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def mesh_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------------------
# Parameter sharding rules (the reference's, copied)
# ---------------------------------------------------------------------------

# (regex on the parameter path) -> spec for the *trailing* dims of the leaf.
# "F" is replaced by the fsdp axis ("data") when fsdp is on, else None.
_RULES: tuple[tuple[str, tuple | None], ...] = (
    (r"embedding$", ("model", "F")),              # (V, d) vocab-sharded
    (r"unembed/kernel$", ("F", "model")),         # (d, V)
    (r"(q|k|v|up|gate|in_x|in_gate)/kernel$", ("F", "model")),
    (r"(o|down|out|out_proj)/kernel$", ("model", "F")),
    (r"experts/(up|gate)$", ("model", "F", None)),  # (E, d, f) expert-parallel
    (r"experts/down$", ("model", None, "F")),       # (E, f, d)
    (r"router/kernel$", (None, None)),
    (r"in_proj/kernel$", ("model", None)),        # ssd packed proj: row-parallel
    (r"conv/kernel$", (None, None)),
    (r"(rg|ig)_kernel$", (None, "model")),
    (r"(rg|ig)_bias$", ("model",)),
    (r"lambda_param$", ("model",)),
    (r"(A_log|D|dt_bias)$", (None,)),
    (r"(norm_scale|norm_bias|bn_scale|bn_bias)$", (None,)),
    (r".*", None),                                # default: replicated
)


def _fixup(tr: tuple, shape: tuple, sizes: dict[str, int]) -> tuple:
    """Move a mesh dim off a tensor dim it does not divide, onto the next
    one it does, else drop it (granite's 40 experts on a model dim of 16,
    mamba's 50,280 vocab)."""
    tr = list(tr)
    for i, ax in enumerate(tr):
        if ax is None or not sizes:
            continue
        if shape[i] % sizes.get(ax, 1) == 0:
            continue
        tr[i] = None
        for j in range(len(tr)):
            if tr[j] is None and shape[j] % sizes.get(ax, 1) == 0:
                tr[j] = ax
                break
    return tuple(tr)


def _spec_for(path: str, shape: tuple, f: str | None, sizes: dict[str, int]) -> tuple:
    """The reference's spec of one leaf of its tree (``param_pspecs.spec_for``)."""
    for pat, trailing in _RULES:
        if re.search(pat, path):
            if trailing is None:
                return ()
            tr = tuple(f if t == "F" else t for t in trailing)
            lead = len(shape) - len(tr)      # right-align against the leaf
            if lead < 0:
                return ()
            tr = _fixup(tr, shape[lead:], sizes)
            if all(t is None for t in tr):
                return ()
            return (None,) * lead + tr
    return ()


def param_pspecs(params: dict[str, torch.Tensor], cfg=None, *, fsdp: bool = False,
                 mesh: DeviceMesh | None = None,
                 sizes: dict[str, int] | None = None) -> dict[str, tuple]:
    """``{name: spec}`` of the port's leaves (tensors or meta tensors; shapes
    only). ``cfg``: a transformer's config, whose ``n_prefix``/``n_blocks``
    say how the reference stacks the layers; without it every leaf is its
    own (the ResNet). Divisibility follows the mesh's sizes (``sizes``, or
    ``mesh``'s), as the reference's; without either no rule moves."""
    f = "data" if fsdp else None
    if sizes is None:
        sizes = mesh_sizes(mesh) if mesh is not None else {}
    out = {}
    for name, t in params.items():
        jname, _ = convert.reference_name(name, cfg)
        shape = tuple(t.shape)
        stacked = jname.startswith("blocks.")
        if stacked:
            shape = (cfg.n_blocks,) + shape
        spec = _spec_for(jname.replace(".", "/"), shape, f, sizes)
        if stacked and spec:
            if spec[0] is not None:
                raise ValueError(f"{name}: the reference shards the block dim ({spec})")
            spec = spec[1:]
        out[name] = spec
    return out


def placements(spec: tuple, mesh: DeviceMesh) -> list:
    """DTensor placements of a spec: ``Shard(i)`` on each mesh dim that the
    spec names at tensor dim i, ``Replicate()`` on the others. Mesh dims
    that share a tensor dim split it in mesh order, major first, as a
    tuple entry of a ``PartitionSpec`` does."""
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((i for i, s in enumerate(spec)
                    if s == name or (isinstance(s, tuple) and name in s)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def with_shardings(tensors: dict[str, torch.Tensor], mesh: DeviceMesh,
                   specs: dict[str, tuple]) -> dict[str, DTensor]:
    """Each tensor distributed over ``mesh`` by its spec. On meta tensors
    nothing is allocated or sent: the dry run's inputs."""
    return {name: distribute_tensor(t, mesh, placements(specs[name], mesh))
            for name, t in tensors.items()}


def cache_pspecs(cache: list[dict], dp_axes: tuple[str, ...],
                 mesh: DeviceMesh) -> list[dict[str, tuple]]:
    """Specs of the per-layer caches (``init_cache``: one dict a layer),
    divisibility-aware, as the reference's for a layer of its cache (whose
    scanned leaves lead with an unsharded block dim).

    kv cache (B, L, Hkv, D): batch over the DP dims (when divisible), model
    on Hkv if divisible, else on D (qwen/llama kv=8 < model=16: the head
    dim). Recurrent and conv states: batch over DP, model on the first
    trailing dim it divides.
    """
    sizes = mesh_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in dp_axes)
    model_size = sizes.get("model", 1)

    def spec(leaf) -> tuple:
        dims = tuple(leaf.shape)
        if not dims:
            return ()
        batch_ax = None
        if dims[0] % max(dp_size, 1) == 0:     # one axis by its name, as P() keeps it
            batch_ax = dp_axes[0] if len(dp_axes) == 1 else tuple(dp_axes)
        rest = [None] * (len(dims) - 1)
        if len(dims) == 4:                # (B, L, Hkv, D) kv cache
            if dims[2] % model_size == 0:
                rest[1] = "model"
            elif dims[3] % model_size == 0:
                rest[2] = "model"
        else:                             # recurrent / conv state
            for i, d in enumerate(dims[1:]):
                if d % model_size == 0:
                    rest[i] = "model"
                    break
        return (batch_ax, *rest)

    return [{k: spec(v) for k, v in layer.items()} for layer in cache]
