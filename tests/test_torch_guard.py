"""The train step's non-finite guard: its plain version on the CPU and its
two kernels (``csrc/guard.cu``) on the card.

The CPU tests hold ``kernels/ref.py``'s plain version, with the flag and
``train/trainer.py:next_loss_scale`` as ``make_train_step`` composes them,
against the guard's per-leaf code as ``make_train_step`` wrote it inline, and
check that the launch tables cover every element once. The card tests
(marker ``cuda``, skipped without an NVIDIA GPU) hold the kernels against
the plain version bit for bit. The file imports nothing of JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_guard.py
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import guard as kguard
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lars_update import CHUNK, MAX_LEAVES, block_ranges
from repro_torch.train.trainer import GuardConfig, next_loss_scale

SCALES = (1.0, 2.0 ** -3, 2.0 ** 15)
FAULTS = ("clean", "nan_first", "inf_last", "ninf_past_split", "loss_only")
CFG = GuardConfig()


def _today(grads, loss, scale, good_steps, old_p, new_p, old_v, new_v, guard=CFG):
    """The guard as ``make_train_step`` wrote it, leaf by leaf, before the
    kernels: the unscale, the count and the flag, then the selects and the
    loss scale's rules."""
    inv = 1.0 / scale
    grads = [g * inv.to(g.dtype) for g in grads]
    nonfinite = torch.stack([(~torch.isfinite(g)).sum() for g in grads]).sum()
    finite = torch.isfinite(loss) & (nonfinite == 0)
    new_p = [torch.where(finite, p, o) for p, o in zip(new_p, old_p)]
    new_v = [torch.where(finite, v, o) for v, o in zip(new_v, old_v)]
    good = torch.where(finite, good_steps + 1, torch.zeros_like(good_steps))
    grow = finite & (good >= guard.growth_interval)
    new_scale = torch.where(
        finite,
        torch.where(grow, (scale * guard.growth_factor).clamp(max=guard.max_scale), scale),
        (scale * guard.backoff_factor).clamp(min=guard.min_scale))
    good = torch.where(grow, torch.zeros_like(good), good).to(torch.int32)
    return (grads, nonfinite, new_p, new_v, (~finite).to(torch.int32),
            nonfinite.to(torch.int32), new_scale, good)


def _leaves(sizes, gen, device, scale=1.0):
    """Views of one flat fp32 buffer, as ``sync_tree`` and LARS return
    leaves: the offsets need not lie on a 16-byte boundary."""
    flat = torch.randn(sum(sizes), generator=gen, device=device) * scale
    return list(torch.split(flat, list(sizes)))


def _case(sizes, fault, scale, device, seed=0):
    """The guard's inputs over leaves of ``sizes`` with ``fault`` planted:
    (grads, loss, scale, good_steps, old_p, new_p, old_v, new_v)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    grads = _leaves(sizes, gen, device, 1e-2 * scale)
    old_p, new_p, old_v, new_v = (_leaves(sizes, gen, device) for _ in range(4))
    past = min(len(sizes) - 1, MAX_LEAVES + 3)       # a leaf of the second table, if any
    if fault == "nan_first":
        grads[len(sizes) // 3][0] = float("nan")
    elif fault == "inf_last":
        grads[len(sizes) // 2][-1] = float("inf")
    elif fault == "ninf_past_split":
        grads[past][sizes[past] // 2] = float("-inf")
    loss = torch.tensor(float("nan") if fault == "loss_only" else 2.5, device=device)
    # grows on a clean step at scales 1 and 2^15 (the clamp), not at 2^-3
    good = torch.tensor(CFG.growth_interval - 1 if scale != 2.0 ** -3 else 5,
                        dtype=torch.int32, device=device)
    return (grads, loss, torch.tensor(scale, device=device), good, old_p, new_p, old_v,
            new_v)


def _guard(args, unscale_count, commit):
    """The guard as ``make_train_step`` composes it from ``unscale_count``
    and ``commit``: the outputs of ``_today``."""
    grads, loss, scale, good, old_p, new_p, old_v, new_v = args
    unscaled, count = unscale_count(grads, scale)
    finite = torch.isfinite(loss) & (count == 0)
    new_p, new_v = commit(finite, old_p, new_p, old_v, new_v)
    return (unscaled, count, new_p, new_v, (~finite).to(torch.int32),
            count.to(torch.int32), *next_loss_scale(finite, scale, good, CFG))


def _plain(*args):
    return _guard(args, ops.guard_unscale_count, ops.guard_commit)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    """Equal bit for bit: leaves, counts, flags, scales."""
    for a, b in zip(got, want):
        for x, y in zip(a, b) if isinstance(a, list) else [(a, b)]:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(_bits(x), _bits(y))


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("scale", SCALES)
def test_plain_version_equals_the_per_leaf_code(scale, fault):
    sizes = (7, 64, 3, 129, 1, 250)
    args = _case(sizes, fault, scale, "cpu")
    clones = [[t.clone() for t in a] if isinstance(a, list) else a.clone() for a in args]
    ops.reset_launch_counts()
    got = _plain(*clones)
    assert sum(ops.launch_counts().values()) == 0          # CPU: the plain version
    want = _today(*args)
    _assert_same(got, want)
    finite = fault == "clean"
    assert int(got[4]) == (not finite) and (int(got[5]) > 0) == (fault not in ("clean",
                                                                                "loss_only"))
    # the rules: growth clamped at 2^15, backoff clamped at 1
    want_scale = {True: {1.0: 2.0, 2.0 ** -3: 2.0 ** -3, 2.0 ** 15: 2.0 ** 15},
                  False: {1.0: 1.0, 2.0 ** -3: 1.0, 2.0 ** 15: 2.0 ** 14}}[finite][scale]
    assert float(got[6]) == want_scale
    for got_leaves, new, old in ((got[2], args[5], args[4]), (got[3], args[7], args[6])):
        for g, n, o in zip(got_leaves, new, old):
            assert torch.equal(g, n if finite else o)


def test_plain_count_without_a_scale_leaves_the_gradients():
    """The guard off: the count alone, of the gradients as they are."""
    grads, *_ = _case((5, 9, 2), "inf_last", 1.0, "cpu")
    before = [g.clone() for g in grads]
    out, count = ops.guard_unscale_count(grads, None)
    assert int(count) == 1
    assert all(torch.equal(a, b) for a, b in zip(out, before))


def _numels(tree: str) -> list[int]:
    if tree == "resnet50":
        from repro_torch.models import resnet
        model = resnet.init(resnet.ResNetConfig.resnet50(num_classes=1000, image_size=224),
                            seed=0, device="cpu")
    elif tree == "qwen3-1.7b":
        from repro_torch.configs import registry
        from repro_torch.models import transformer as T
        model = T.init(registry.get("qwen3-1.7b"), device="meta")
    else:
        return [int(n) for n in np.random.RandomState(5).randint(1, 3 * CHUNK, size=600)]
    return [p.numel() for _, p in model.named_parameters()]


@pytest.mark.parametrize("tree,n_leaves", [("resnet50", 161), ("qwen3-1.7b", 310),
                                           ("600 leaves", 600)])
def test_tables_cover_every_element_once(tree, n_leaves):
    """The unscale's blocks and the commit's strided walk over them each
    reach every element of every leaf once; past 512 leaves a second table."""
    numels = _numels(tree)
    assert len(numels) == n_leaves
    for kind in (kguard._UnscaleTable, kguard._CommitTable):
        tabs = kguard.tables(kind, tuple(numels))
        assert len(tabs) == -(-n_leaves // MAX_LEAVES)
        spans = [[] for _ in numels]
        for launch, t in tabs:
            k = t.n_leaves
            assert k == len(launch.offsets) <= MAX_LEAVES and t.chunk == CHUNK
            assert list(t.n[:k]) == numels[launch.first:launch.first + k]
            assert list(t.chunk0[:k + 1]) == list(launch.chunk0)
            ranges = block_ranges(launch, numels, CHUNK)
            # the commit: a grid of 4 CTAs an SM (132) striding over the blocks
            grid = min(launch.blocks, kguard.CTAS_PER_SM * 132)
            walk = sorted(b for x in range(grid) for b in range(x, launch.blocks, grid))
            assert walk == list(range(launch.blocks))
            for leaf, start, end in ranges:
                spans[leaf].append((start, end))
        # each leaf's blocks tile it: no element twice, none left out
        for n, leaf_spans in zip(numels, spans):
            ends = [0] + [end for _, end in sorted(leaf_spans)]
            assert [start for start, _ in sorted(leaf_spans)] == ends[:-1] and ends[-1] == n


def test_tables_fit_the_kernel_parameters():
    """The tables go by value in a launch's parameters (32,764 bytes on
    CUDA 12.1+), beside the commit's 4 other arguments."""
    # sizeof of csrc/guard.cu's structs: pointers, sizes, first blocks, then
    # the ints, padded to 8 bytes
    assert ctypes.sizeof(kguard._UnscaleTable) == 8208
    assert ctypes.sizeof(kguard._CommitTable) == 20496
    assert ctypes.sizeof(kguard._CommitTable) + 4 * 8 <= 32764


# -- the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


_SIZES = {}


def _card_sizes(tree: str) -> tuple[int, ...]:
    """ResNet-50's 161 leaf sizes, or 600 small ones (two tables), odd
    sizes among them so that leaves start off 16-byte boundaries."""
    if tree not in _SIZES:
        if tree == "resnet50":
            from repro_torch.models import resnet
            cfg = resnet.ResNetConfig.resnet50(num_classes=1000, image_size=224)
            _SIZES[tree] = tuple(p.numel() for _, p in resnet.init(
                cfg, seed=0, device="cuda").named_parameters())
        else:
            _SIZES[tree] = tuple(int(n) for n in
                                 np.random.RandomState(7).randint(1, 5000, size=600))
    return _SIZES[tree]


def _run_kernels(args):
    return _guard(args, kguard.guard_unscale_count_cuda, kguard.guard_commit_cuda)


def _clone(args):
    return [[t.clone() for t in a] if isinstance(a, list) else a.clone() for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("scale", (*SCALES, 3.0))
@pytest.mark.parametrize("tree", ["resnet50", "600 leaves"])
def test_kernels_match_plain_bit_for_bit(cuda, tree, scale, fault):
    """Unscaled gradients, the count, the flag, the scale, the good steps
    and the kept or restored leaves, as the plain version gives them on the
    card; a fault in a leaf's first or last element, past the table split,
    or in the loss alone. At 3.0 the reciprocal is rounded, as torch's."""
    sizes = _card_sizes(tree)
    args = _case(sizes, fault, scale, cuda, seed=11)
    want = _guard(_clone(args), ref.guard_unscale_count_ref, ref.guard_commit_ref)
    ops.reset_launch_counts()
    got = _run_kernels(kargs := _clone(args))
    torch.cuda.synchronize()
    tables = -(-len(sizes) // MAX_LEAVES)
    assert ops.launch_counts()["guard_unscale_count"] == tables
    assert ops.launch_counts()["guard_commit"] == tables
    _assert_same(got, want)
    # in place: the step's own tensors come back
    assert all(a is b for a, b in zip(got[0], kargs[0]))
    assert all(a is b for a, b in zip(got[2], kargs[5]))
    assert int(got[4]) == (fault != "clean")


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda):
    for fault in ("clean", "ninf_past_split"):
        args = _case(_card_sizes("600 leaves"), fault, 2.0 ** -3, cuda, seed=3)
        _assert_same(_run_kernels(_clone(args)), _run_kernels(_clone(args)))


@pytest.mark.cuda
def test_a_finite_commit_moves_no_parameter_byte(cuda):
    """On a finite step LARS's output stands as it was written, and the
    count without a scale leaves the gradients as they are."""
    args = _case(_card_sizes("resnet50"), "clean", 1.0, cuda, seed=4)
    new_p, new_v = _clone(args[5:6])[0], _clone(args[7:8])[0]
    grads = _clone(args[:1])[0]
    _, count = kguard.guard_unscale_count_cuda(grads, None)
    finite = torch.isfinite(args[1]) & (count == 0)
    kguard.guard_commit_cuda(finite, args[4], new_p, args[6], new_v)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(new_p + new_v + grads,
                                                                 args[5] + args[7] + args[0]))
    assert int(count) == 0


@pytest.mark.cuda
def test_channels_last_gradient_is_unscaled_in_place(cuda):
    """cuDNN gives a convolution's kernel gradient channels-last: the unscale
    is elementwise, so it goes as it is."""
    g = torch.randn(64, 32, 3, 3, device=cuda).to(memory_format=torch.channels_last)
    g[1, 2, 0, 1] = float("nan")
    scale = torch.tensor(2.0 ** -3, device=cuda)
    want, count = ref.guard_unscale_count_ref([g.clone()], scale)
    got, kcount = kguard.guard_unscale_count_cuda([g], scale)
    assert got[0] is g and g.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(g.contiguous()), _bits(want[0].contiguous()))
    assert int(kcount) == int(count) == 1


@pytest.mark.cuda
def test_resnet50_step_launches_each_guard_kernel_once(cuda):
    """One ResNet-50 step at 256 images through ``Trainer.run``: the guard
    is one unscale launch and one commit launch, and nothing is skipped."""
    from repro_torch.core.batch_control import build_plan
    from repro_torch.core.schedules import BatchSchedule, BatchStage
    from repro_torch.launch import profile_trainer
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model, data_fn, loss_fn, _ = profile_trainer.resnet50_path(cuda)
    plan = build_plan(BatchSchedule((BatchStage(0, 1, 256),)), dataset_size=256,
                      n_workers=1, max_steps=1)
    ops.reset_launch_counts()
    _, history = Trainer(loss_fn, TrainerConfig(log_every=1), plan, data_fn).run(
        TrainState.create(dict(model.named_parameters())), log=lambda s: None)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["guard_unscale_count"] == 1 and counts["guard_commit"] == 1, counts
    assert [h["skipped"] for h in history if h["kind"] == "metric"] == [0]


@pytest.mark.cuda
def test_guard_kernel_names_are_classed_outside_matmul_nccl_and_port(cuda):
    """The benchmark classes device ops by name (``bench/harness/classes.py``,
    first match wins): the guard's kernels, template arguments and
    namespace included, must fall in none of the convolution / matmul, NCCL
    or port classes, so that their time counts where the guard's ops did."""
    from bench.harness import classes

    args = _case(_card_sizes("600 leaves"), "clean", 1.0, cuda)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _run_kernels(_clone(args))
        kguard.guard_unscale_count_cuda(_clone(args[:1])[0], None)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if "guard_" in e.name}
    assert len(names) == 3, names        # the unscale with and without a scale, the commit
    assert {s for s in ("guard_unscale_count_kernel", "guard_commit_kernel")
            if any(s in n for n in names)} == {"guard_unscale_count_kernel",
                                               "guard_commit_kernel"}
    bad = {classes.MATMUL, classes.NCCL, *classes.PORT}
    assert not {n: classes.classify(n) for n in names if classes.classify(n) in bad}


@pytest.mark.cuda
def test_guard_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = _case((8, 4), "clean", 1.0, cuda)
    grads, loss, scale, good, old_p, new_p, old_v, new_v = args
    with pytest.raises(ValueError, match="CUDA"):
        kguard.guard_unscale_count_cuda([torch.ones(3)], None)
    with pytest.raises(ValueError, match="on cpu"):
        kguard.guard_unscale_count_cuda([grads[0], torch.ones(3)], None)
    with pytest.raises(TypeError, match="float32"):
        kguard.guard_unscale_count_cuda([grads[0].bfloat16()], None)
    with pytest.raises(ValueError, match="contiguous"):
        kguard.guard_unscale_count_cuda([torch.ones(4, 1, device=cuda).expand(4, 6)], None)
    with pytest.raises(TypeError, match="float32"):
        kguard.guard_unscale_count_cuda(grads, scale.double())
    _, count = kguard.guard_unscale_count_cuda(grads, scale)
    finite = count == 0
    with pytest.raises(TypeError, match="one bool"):
        kguard.guard_commit_cuda(count, old_p, new_p, old_v, new_v)
    with pytest.raises(TypeError, match="one bool"):
        kguard.guard_commit_cuda(finite.expand(2), old_p, new_p, old_v, new_v)
    with pytest.raises(ValueError, match="CUDA"):
        kguard.guard_commit_cuda(finite.cpu(), old_p, new_p, old_v, new_v)
    with pytest.raises(ValueError, match="sizes"):
        kguard.guard_commit_cuda(finite, old_p, new_p[::-1], old_v, new_v)
    with pytest.raises(ValueError, match="contiguous"):
        kguard.guard_commit_cuda(finite, old_p, [new_p[0], torch.ones(2, 2, device=cuda).t()],
                                 old_v, new_v)
