"""2D-Torus topology (paper §2.2, Table 4), as a grid of process-group ranks.

The paper arranges N GPUs in an X (horizontal) x Y (vertical) logical grid
and decomposes the gradient all-reduce into
    reduce-scatter along X  ->  all-reduce along Y (1/X volume)  ->  all-gather along X.

The JAX package names mesh axes (``repro/core/topology.py``); here the
grid is ranks of ``torch.distributed``. Rank r sits at
``(dy, dx) = divmod(r, X)``: the row-major order of the JAX mesh
``("dy", "dx")`` and of its batch sharding ``P(("dy", "dx"))``, so rank r
of the port holds what device r of the reference holds. ``build()`` makes
one horizontal group for each row and one vertical group for each column
(every rank makes every group, in the same order, as
``torch.distributed.new_group`` requires) and keeps this rank's two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

# the names the JAX mesh gives the two axes; down-axis sets use them
H_AXIS, V_AXIS = "dx", "dy"


def factorize(n: int) -> tuple[int, int]:
    """Split n into (Y, X), X >= Y, as square as possible (paper Table 4)."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    y = int(math.isqrt(n))
    while n % y != 0:
        y -= 1
    x = n // y
    # paper lists grids as (vertical, horizontal) with horizontal >= vertical
    if y > x:
        x, y = y, x
    return y, x


@dataclasses.dataclass(frozen=True)
class Ring:
    """One group of the grid as this rank sees it: its members' global
    ranks in ring order, this rank's place among them, and the process
    group (None without an initialised process group; a group of one
    issues no collective)."""

    ranks: tuple[int, ...]
    index: int = 0
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


_SOLO = Ring((0,))


@dataclasses.dataclass
class TorusGrid:
    """An X x Y grid of ranks. ``h`` is this rank's row (the reduce-scatter
    and all-gather phases), ``v`` its column (the middle all-reduce, on 1/X
    of the data), ``world`` every rank in row-major order; all three are
    filled by ``build()``."""

    x: int = 1
    y: int = 1
    h: Ring = _SOLO
    v: Ring = _SOLO
    world: Ring = _SOLO
    device: torch.device = torch.device("cpu")

    @property
    def size(self) -> int:
        return self.x * self.y

    @property
    def axes(self) -> tuple[str, ...]:
        """The JAX mesh's axis names for this grid, vertical first."""
        return (V_AXIS, H_AXIS)

    def sizes(self) -> tuple[int, int]:
        """(X, Y), as ``repro/core/topology.py:TorusGrid.sizes``."""
        return self.x, self.y

    def coords(self, rank: int) -> tuple[int, int]:
        """(dy, dx) of a global rank."""
        return divmod(rank, self.x)

    def build(self, members: Sequence[Sequence[int]] | None = None) -> "TorusGrid":
        """This grid with its process groups. Without an initialised
        process group only the 1 x 1 grid exists, and it has no groups.

        ``members``: when the world splits into several grids of this shape
        (the data-parallel ranks of each model coordinate of a mesh), their
        rank lists, each ``x * y`` global ranks in row-major (dy, dx) order.
        Every rank builds every grid's groups, in one order, as
        ``torch.distributed.new_group`` requires, and keeps the grid that
        holds it; ``world`` is then that grid's ranks. Default: one grid of
        every rank, whose ``world`` is the process group's."""
        if not (dist.is_available() and dist.is_initialized()):
            if self.size != 1:
                raise RuntimeError(f"a {self.y}x{self.x} grid needs torch.distributed "
                                   f"initialised with {self.size} ranks")
            return self
        world = dist.get_world_size()
        if members is None:
            if world != self.size:
                raise ValueError(f"grid {self.y}x{self.x} has {self.size} ranks, the "
                                 f"process group {world}")
            grids = [tuple(range(world))]
        else:
            grids = [tuple(int(r) for r in m) for m in members]
            if any(len(g) != self.size for g in grids) or \
                    sorted(r for g in grids for r in g) != list(range(world)):
                raise ValueError(f"members must split the {world} ranks into grids of "
                                 f"{self.y}x{self.x}")
        rank = dist.get_rank()
        mine = None
        for g in grids:
            rows = [tuple(g[r * self.x + c] for c in range(self.x)) for r in range(self.y)]
            cols = [tuple(g[r * self.x + c] for r in range(self.y)) for c in range(self.x)]
            # every rank creates every group, rows then columns, in one order
            row_groups = [dist.new_group(list(ranks)) for ranks in rows]
            col_groups = [dist.new_group(list(ranks)) for ranks in cols]
            whole = dist.group.WORLD if len(grids) == 1 else dist.new_group(list(g))
            if rank in g:
                mine = (g, rows, cols, row_groups, col_groups, whole)
        g, rows, cols, row_groups, col_groups, whole = mine
        index = g.index(rank)
        dy, dx = self.coords(index)
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
        return dataclasses.replace(
            self, device=device,
            h=Ring(rows[dy], dx, row_groups[dy]),
            v=Ring(cols[dx], dy, col_groups[dx]),
            world=Ring(g, index, whole))


def select_grid(dp_sizes: Sequence[int]) -> TorusGrid:
    """The grid of data-parallel sizes ``(Y, X)``: X horizontal, Y vertical,
    as ``repro/core/topology.py:select_grid`` orients ``("dy", "dx")``. A
    single size gives the degenerate grid, all horizontal. Call ``build()``
    on the result."""
    dp_sizes = tuple(int(s) for s in dp_sizes)
    if not dp_sizes:
        raise ValueError("at least one data-parallel size required")
    if len(dp_sizes) == 1:
        return TorusGrid(x=dp_sizes[0], y=1)
    if len(dp_sizes) != 2:
        raise ValueError(f"want (Y, X) or (N,), got {dp_sizes}")
    return TorusGrid(x=dp_sizes[1], y=dp_sizes[0])


def world_grid() -> TorusGrid:
    """The built grid of every rank, factorized as the paper's Table 4 does;
    the 1 x 1 grid without an initialised process group."""
    if dist.is_available() and dist.is_initialized():
        return select_grid(factorize(dist.get_world_size())).build()
    return TorusGrid()


def paper_table4_grid(n_gpus: int) -> tuple[int, int]:
    """The grid dimensions the paper used (Table 4), for the benchmark."""
    table = {1024: (32, 32), 2048: (32, 64), 2176: (34, 64), 3456: (48, 72), 4096: (64, 64)}
    if n_gpus in table:
        return table[n_gpus]
    return factorize(n_gpus)
