"""Where the model meets a DTensor op whose sharding rule it cannot use.

The dry run (``launch/dryrun.py``) runs the model on DTensors. For most ops
DTensor derives the output's placement and the collectives it needs; for a
few it has no rule, or a rule that fails. There the module that calls the
op either gathers the offending tensor dims first, or runs the op on each
rank's shards as the tensor-parallel program does (``headwise`` for the
attention, ``ls_xent`` for the loss over vocabulary shards,
``vocab_lookup`` for the embedding, ``elementwise`` for the RG-LRU
scan, ``take_rows`` for the gradient of the MoE dispatch's gather). On a
plain
tensor these helpers return their input or call the function as it is, so
the card and host paths are untouched.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

#: where the program held whole what its placements shard, by site: the
#: dry run writes it beside its FLOPs, collectives and memory, which such a
#: gather raises above those of the tensor-parallel program
GATHERED: Counter = Counter()


def _note(what: str, x, dims=None) -> None:
    """Count ``what`` in ``GATHERED`` if ``x`` is a DTensor sharded on one of
    ``dims`` (None: any dim)."""
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and n > 1 and (dims is None or p.dim % x.ndim in
                                               {d % x.ndim for d in dims})
            for p, n in zip(x.placements, x.device_mesh.shape)):
        GATHERED[what] += 1


def unshard(x: torch.Tensor, *dims: int, what: str | None = None) -> torch.Tensor:
    """``x`` with its shards of the tensor dims ``dims`` gathered and its
    pending sums reduced (every other shard kept), so that each rank holds
    whole values along ``dims``; a plain tensor as it is. ``what``: the
    site, counted in ``GATHERED`` if a shard is gathered."""
    if not isinstance(x, DTensor):
        return x
    if what is not None:
        _note(what, x, dims)
    dims = {d % x.ndim for d in dims}
    want = [p if isinstance(p, Shard) and p.dim % x.ndim not in dims
            else p if p.is_replicate() else Replicate() for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(placements=want)


class _GradUnsharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return unshard(g, *ctx.dims), None


def grad_unsharded(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x``, whose gradient has its pending sums reduced (and its shards of
    ``dims`` gathered) on the way back. Without ``dims`` it is Megatron's
    ``f`` at the input of a column-parallel layer: the gradient from the
    tensor-parallel matmuls that read ``x`` is a pending sum, which DTensor
    would otherwise carry into every matmul before it and gather each
    one's weight for. A plain tensor as it is."""
    return _GradUnsharded.apply(x, dims) if isinstance(x, DTensor) else x


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H*D). A DTensor whose heads are whole (they
    do not divide over the ranks: musicgen's 24 on 16) has its gradient's
    H*D gathered on the way back: the row-parallel projection after it
    gives that gradient sharded across head boundaries, which some DTensor
    versions cannot view back as (H, D)."""
    y = x.reshape(*x.shape[:2], -1)
    if isinstance(x, DTensor) and not any(isinstance(p, Shard) and p.dim == 2
                                          for p in x.placements):
        y = grad_unsharded(y, 2)
    return y


def replicate(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank of its mesh; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    want = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == want else x.redistribute(placements=want)


def whole(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` whole, as this rank's plain tensor: for an op that DTensor has
    no rule for at all (the MoE dispatch's ``searchsorted``), whose result
    then mixes with DTensors as a replicated value
    (``implicit_replication``); a plain tensor as it is. ``what``: the
    site, for ``GATHERED``."""
    if not isinstance(x, DTensor):
        return x
    _note(what, x)
    return replicate(x).to_local()


def elementwise(fn, *xs: torch.Tensor, whole: tuple[int, ...] = ()) -> torch.Tensor:
    """``fn(*xs)`` for an ``fn`` of same-shaped tensors whose result, one
    tensor of their shape, takes each element from the inputs' elements
    at its position, or along the tensor dims ``whole`` only: the
    elementwise ``log_sigmoid``, whose backward DTensor has no rule for,
    and the RG-LRU scan over the sequence, whose ``pad`` some DTensor
    versions fail on a tensor sharded on two mesh dims. DTensors run on
    each rank's shards under autograd: ``whole`` gathered, pending sums
    reduced, all in the first's placements, which the result takes. Plain
    tensors: ``fn(*xs)``."""
    if not any(isinstance(x, DTensor) for x in xs):
        return fn(*xs)
    ref = next(x for x in xs if isinstance(x, DTensor))
    lead = unshard(replicated_like(xs[0], ref), *whole)
    xs = [lead] + [replicated_like(x, ref).redistribute(placements=lead.placements)
                   for x in xs[1:]]
    return DTensor.from_local(fn(*(x.to_local() for x in xs)), lead.device_mesh,
                              lead.placements, run_check=False, shape=lead.shape,
                              stride=lead.stride())


def split_dim(x: torch.Tensor, dim: int, n: int, m: int) -> torch.Tensor:
    """``x`` with dim ``dim`` (of size n * m) reshaped to (n, m). A DTensor
    sharded on that dim over a mesh dim whose size does not divide ``n``
    (Qwen3's and Llama's 8 kv heads on a model dim of 16) has it gathered
    first: a shard cannot straddle the boundary of the outer dim."""
    dim %= x.ndim
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim % x.ndim == dim and n % size
            for p, size in zip(x.placements, x.device_mesh.shape)):
        x = unshard(x, dim, what="head split: whole heads")
    return x.reshape(*x.shape[:dim], n, m, *x.shape[dim + 1:])


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A plain ``t`` as a DTensor replicated over ``ref``'s mesh (under
    autograd), when ``ref`` is a DTensor; else ``t``. Mixing a plain tensor
    into a DTensor op by ``implicit_replication`` gives it no gradient path
    back to a plain tensor; this does."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def batchwise(fn, *rows, shared=(), what: str = "per batch shard"):
    """``fn(*rows, *shared)`` for a function whose rows (dim 0 of each of
    ``rows``) are independent, its result a tensor or a tuple of them with
    rows first. DTensors (the dry run) are made whole in every other dim,
    ``shared`` whole, ``fn`` runs on each rank's rows under autograd, and
    the results take the rows' placements: for the attention, whose
    einsums DTensor's rules expand slowly on a 3-D mesh, and the SSD scan,
    whose ``cumsum`` backward (``flip``) and head reshapes some DTensor
    versions have no rule for. ``None`` rows pass through; ``what`` names
    the site for ``GATHERED``. Plain tensors: ``fn(*rows, *shared)``."""
    if not any(isinstance(x, DTensor) for x in (*rows, *shared)):
        return fn(*rows, *shared)
    ref = next(x for x in (*rows, *shared) if isinstance(x, DTensor))
    for x in rows:
        if x is not None:
            _note(what, x, range(1, x.ndim))
    rows = [None if x is None else unshard(replicated_like(x, ref), *range(1, x.ndim))
            for x in rows]
    if len({tuple(x.placements) for x in rows if x is not None}) > 1:   # split differently
        rows = [None if x is None else replicate(x) for x in rows]
    lead = next(x for x in rows if x is not None)
    out = fn(*(None if x is None else x.to_local() for x in rows),
             *(whole(replicated_like(x, ref), what) for x in shared))

    def wrap(t):
        return DTensor.from_local(t, lead.device_mesh, lead.placements, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


class _VocabLookup(torch.autograd.Function):
    """``vocab_lookup`` on a DTensor table: see there."""

    @staticmethod
    def forward(ctx, table, ids):
        mesh = table.device_mesh
        # (the table's placement for the lookup, the output's, the local
        # gradient's) on each mesh dim
        plan = []
        for p, ip in zip(table.placements, ids.placements):
            rows_here = isinstance(ip, Shard)          # this mesh dim splits the ids' rows
            if isinstance(p, Shard) and p.dim == 0 and not rows_here:
                plan.append((p, Replicate(), p))       # vocab: the shards' sum, reduced
            elif isinstance(p, Shard) and p.dim == 1 and not rows_here:
                plan.append((p, Shard(ids.ndim), p))   # d split, the ids whole: d stays split
            else:                                      # d gathered, or a replica
                if isinstance(p, Shard) and p.dim == 0:
                    _note("embedding: whole vocab", table, (0,))
                plan.append((Replicate(), ip, Partial() if rows_here else Replicate()))
        table_pl, out_pl, grad_pl = (list(x) for x in zip(*plan))
        t = table.redistribute(placements=table_pl).to_local()
        idx, hit = ids.to_local().long(), None
        if t.shape[0] < table.shape[0]:                # this rank's rows of the vocab
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
            _, offset = compute_local_shape_and_global_offset(table.shape, mesh, table_pl)
            idx = idx - offset[0]
            hit = (idx >= 0) & (idx < t.shape[0])
            idx = torch.where(hit, idx, 0)
        out = t.index_select(0, idx.reshape(-1)).view(*idx.shape, t.shape[1])
        if hit is not None:
            out = out * hit[..., None].to(out.dtype)
        ctx.save_for_backward(idx, hit)
        ctx.plan = (mesh, t.shape, table.shape, table.stride(), table.placements, out_pl,
                    grad_pl)
        shape = (*ids.shape, table.shape[1])
        # the vocab shards' lookups are summed here, as Megatron's
        # vocab-parallel embedding does: a sum left pending would ride the
        # residual stream and be reduced again at every layer
        pending = [Partial() if isinstance(p, Replicate) and isinstance(tp, Shard)
                   and tp.dim == 0 else p for p, tp in zip(out_pl, table_pl)]
        return DTensor.from_local(out, mesh, pending, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride()
                                  ).redistribute(placements=out_pl)

    @staticmethod
    def backward(ctx, g):
        idx, hit = ctx.saved_tensors
        mesh, local_shape, shape, stride, placements, out_pl, grad_pl = ctx.plan
        # each vocab shard takes the whole gradient of its rows' lookups
        g = g.redistribute(placements=out_pl).to_local()
        if hit is not None:
            g = g * hit[..., None].to(g.dtype)
        dt = g.new_zeros(local_shape).index_add_(0, idx.reshape(-1),
                                                 g.reshape(-1, g.shape[-1]))
        grad = DTensor.from_local(dt, mesh, grad_pl, run_check=False, shape=shape,
                                  stride=stride)
        return grad.redistribute(placements=placements), None


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of a (V, d) table. A DTensor table (the dry run)
    is looked up as the tensor-parallel program does, not by DTensor's
    rule for the indexing (whose backward's ``index_put`` some versions
    refuse): a d split over a mesh dim that splits the ids' rows (FSDP's
    ``data``) is gathered; each rank looks up its own ids in its own vocab
    rows and zeroes the ids outside them, and the vocab shards' results
    are summed (an all-reduce over the vocab's mesh dim). The backward
    adds the rows' gradients into the local rows (``index_add``) and sends
    them to the table's placement (a reduce-scatter over ``data`` under
    FSDP). A plain table: ``table[ids]``."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    return _VocabLookup.apply(table, replicated_like(ids, table))


class _TakeRows(torch.autograd.Function):
    """``take_rows`` on DTensors: see there."""

    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.rows = (rows.shape, rows.stride(), rows.placements)
        return rows[idx]

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        (idx,) = ctx.saved_tensors
        shape, stride, placements = ctx.rows
        k, gl = idx.ndim, g.to_local()
        # the slots of this rank's gradient rows, and the buffer's placement:
        # a pending sum where the slots are split, the trailing dims' shards
        _, offset = compute_local_shape_and_global_offset(g.shape, g.device_mesh, g.placements)
        il = idx.to_local()[tuple(slice(o, o + n) for o, n in zip(offset[:k], gl.shape[:k]))]
        dx = gl.new_zeros(shape[0], *gl.shape[k:]).index_add_(
            0, il.reshape(-1), gl.reshape(-1, *gl.shape[k:]))
        pl = [p if not isinstance(p, Shard) else
              Partial() if p.dim % g.ndim < k else Shard(p.dim % g.ndim - k + 1)
              for p in g.placements]
        return DTensor.from_local(dx, g.device_mesh, pl, run_check=False, shape=shape,
                                  stride=stride).redistribute(placements=placements), None


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[idx]`` for an integer ``idx`` whole on every rank (the MoE
    dispatch's slots). A DTensor ``rows`` (the dry run) takes DTensor's
    rule forward; backward, each rank adds its local gradient rows into a
    local (N, ...) buffer (``index_add``), sharded as the gradient's
    trailing dims and a pending sum where the gradient splits idx's dims
    (the experts), which then goes to ``rows``' placement: some DTensor
    versions' rule for the ``index_put`` that autograd would use refuses a
    gradient sharded along a trailing dim (FSDP's d). A plain ``rows``:
    ``rows[idx]``."""
    if not isinstance(rows, DTensor):
        return rows[idx]
    return _TakeRows.apply(rows, replicate(replicated_like(idx, rows)))


def normalized(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each ``Shard`` naming its dim from the front: some DTensor
    versions leave a ``Shard(-1)`` in a gradient's placements and then
    refuse to redistribute it."""
    if not isinstance(x, DTensor) or all(
            not isinstance(p, Shard) or p.dim >= 0 for p in x.placements):
        return x
    want = [Shard(p.dim % x.ndim) if isinstance(p, Shard) else p for p in x.placements]
    return DTensor.from_local(x.to_local(), x.device_mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def headwise(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` for attention: q (B, Sq, H, D), k and v
    (B, Skv, Hkv, D), ``rows`` (the mask) (B, ...) or None, the result
    (B, Sq, H, D') in q's heads. DTensors (the dry run): each rank runs its
    sequences and its query heads, as the tensor-parallel program does.
    Its kv heads are a shard of them where Hkv divides over the mesh dim;
    else the one or few its query heads read (Qwen3's 8 on 16 ranks), cut
    from the whole kv heads, their gradient summed over that mesh dim.
    Whole heads where the split does not fit: q's heads over two mesh dims,
    or a kv head's group of query heads straddling two ranks. Plain
    tensors: ``fn(q, k, v, *rows)``."""
    if not any(isinstance(x, DTensor) for x in (q, k, v, *rows)):
        return fn(q, k, v, *rows)
    ref = next(x for x in (q, k, v, *rows) if isinstance(x, DTensor))
    q, k, v = (replicated_like(t, ref) for t in (q, k, v))
    q = unshard(q, 1, 3)
    mesh, (H, Hkv) = q.device_mesh, (q.shape[2], k.shape[2])
    heads = [i for i, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 2]
    cut = [i for i in heads if Hkv % mesh.shape[i]]
    if len(heads) > 1 or any((H // mesh.shape[i]) % (H // Hkv)
                             and (H // Hkv) % (H // mesh.shape[i]) for i in cut):
        q, heads, cut = unshard(q, 2, what="attention: whole heads"), [], []
    # a mesh dim that splits k's sequences but not q's (a decode's cache):
    # q's are cut to match, which moves no data, rather than k gathered
    q = q.redistribute(placements=[
        Shard(0) if p.is_replicate() and kp == Shard(0) else p
        for p, kp in zip(q.placements, k.placements)])
    kv_pl = [Replicate() if i in cut else p for i, p in enumerate(q.placements)]
    row_pl = [Replicate() if i in heads else p for i, p in enumerate(q.placements)]
    k, v = (t.redistribute(placements=kv_pl) for t in (k, v))
    grad_pl = [Partial() if i in cut else p for i, p in enumerate(kv_pl)]
    kl, vl = (t.to_local(grad_placements=grad_pl) for t in (k, v))
    for i in cut:                     # the kv heads this rank's query heads read
        local_h, group = H // mesh.shape[i], H // Hkv
        lo = mesh.get_local_rank(i) * local_h
        kl, vl = (t[:, :, lo // group:(lo + local_h - 1) // group + 1] for t in (kl, vl))
    rows = [None if x is None else
            replicated_like(x, ref).redistribute(placements=row_pl).to_local() for x in rows]
    out = fn(q.to_local(), kl, vl, *rows)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def ls_xent(logits: torch.Tensor, labels: torch.Tensor, smoothing: float):
    """The smoothed NLL of ``kernels/ref.py:ls_xent_fwd_ref`` for DTensor
    logits (R, V) whose vocab dim is sharded over one mesh dim, as
    Megatron's vocab-parallel cross entropy computes it: each rank's
    shards, then the rows' max, sum of exponentials, label logit and sum
    over the vocab as all-reduces of R values (differentiable: each rank
    gets its shard's gradient). Returns (R,) fp32 DTensor rows, or None
    where the vocab is not so sharded (over one mesh dim of more than one
    rank): the caller then gathers it. Labels
    outside [0, V) are not flagged (the dry run computes no value)."""
    logits = unshard(logits)
    mesh, V = logits.device_mesh, logits.shape[1]
    vocab = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == 1 and mesh.shape[i] > 1]
    if len(vocab) != 1 or V % mesh.shape[vocab[0]]:
        _note("loss: whole vocab", logits, (1,))
        return None
    (i,) = vocab
    row_pl = [Replicate() if j == i else p for j, p in enumerate(logits.placements)]

    def over_vocab(t, op="sum"):
        part = [Partial(op) if j == i else p for j, p in enumerate(row_pl)]
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
            placements=row_pl)

    x = logits.to_local().float()
    lo = mesh.get_local_rank(i) * x.shape[1]
    y = replicated_like(labels, logits).redistribute(placements=row_pl).to_local().long() - lo
    hit = (y >= 0) & (y < x.shape[1])
    x_y = torch.where(hit, x.gather(1, y.clamp(0, x.shape[1] - 1)[:, None])[:, 0], 0.0)
    m = over_vocab(x.detach().amax(1), "max")
    lse = torch.log(over_vocab(torch.exp(x - m.to_local()[:, None]).sum(1))) + m
    mean = over_vocab(x.sum(1)) / V
    return (1.0 - smoothing) * (lse - over_vocab(x_y)) - smoothing * (mean - lse)
