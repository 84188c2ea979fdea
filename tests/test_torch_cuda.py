"""The port's CUDA kernels against their plain versions, on the card.

Every test here takes the ``cuda`` fixture, which skips without an NVIDIA
GPU (the kernels have no CPU mode). The file imports nothing of JAX, so it
runs on a machine that has none:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import losses
from repro_torch.core.batch_control import build_plan
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.data.synthetic import SyntheticImageNet
from repro_torch.kernels import batchnorm as bn_kernels
from repro_torch.kernels import ls_xent, ops, ref
from repro_torch.kernels.flash_attn import (flash_attention_bwd_cuda, flash_attention_cuda,
                                            flash_attention_f32, flash_attention_tc)
from repro_torch.kernels.lars_update import MAX_LEAVES, lars_update_cuda
from repro_torch.kernels.ls_xent import ls_xent_bwd_cuda, ls_xent_fwd_cuda
from repro_torch.launch import profile_bn, profile_trainer
from repro_torch.models import resnet
from repro_torch.models import transformer as T
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_flash_data import SCALE, low_bit_qkv

pytestmark = pytest.mark.cuda

LARS_KW = dict(lr=0.5, mom=0.9, eta=0.01, weight_decay=5e-5, eps=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # fp32 comparisons on the card run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("shape", [(7,), (300, 129), (64, 64, 3, 3), (2048, 1000)])
@pytest.mark.parametrize("nesterov", [False, True])
def test_lars_kernel_matches_plain(cuda, shape, nesterov):
    g_ = _gen(cuda, 0)
    p, g, v = (s * torch.randn(shape, generator=g_, device=cuda) for s in (1.0, 0.1, 0.01))
    before = lars_update_cuda.launches
    got = ops.lars_update(p, g, v, **LARS_KW, nesterov=nesterov)
    want = ref.lars_update_ref(p, g, v, **LARS_KW, nesterov=nesterov)
    torch.cuda.synchronize()
    assert lars_update_cuda.launches == before + 2     # the norms, the update
    # fp32 both ways; the kernel contracts multiply-adds
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _pin_labels(x, y):
    """Labels at 0, at V-1, in row 2's scalar tail and in row 3's scalar head
    (the columns before and after csrc/ls_xent.cu's 16-byte vectors), as far
    as there are rows."""
    rows, vocab = x.shape
    es = x.element_size()
    splits = []
    for r in range(min(rows, 4)):
        head = min(vocab, (-(x.data_ptr() + r * vocab * es) % 16) // es)
        splits.append((head, head + (vocab - head) // (16 // es) * (16 // es)))
    pins = [0, vocab - 1]
    if rows > 2:
        pins.append(min(splits[2][1], vocab - 1))
    if rows > 3:
        pins.append(max(splits[3][0] - 1, 0))
    y[:min(rows, len(pins))] = torch.tensor(pins[:rows], device=y.device)
    return y


def _assert_xent_kernels_match_plain(x, y, gout, fwd, bwd):
    loss, lse = fwd(x, y, 0.1)
    loss_r, lse_r = ref.ls_xent_fwd_ref(x, y, 0.1)
    # fp32 sums over the row in another order
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-4)
    d = bwd(x, y, lse_r, gout, 0.1)
    assert d.dtype == x.dtype and d.shape == x.shape
    d_r = ref.ls_xent_bwd_ref(x, y, lse_r, gout, 0.1)
    # fp32 1e-5|ref|, bf16 2^-7|ref| (one bf16 rounding), plus an atol of 1e-6
    # cut to 2^-10 gout a/V a row, under the -gout a/V of most columns
    tol = ref.ls_xent_bwd_tol(d_r, gout, 0.1)
    err = (d.float() - d_r.float()).abs()
    assert bool((err <= tol).all()), (
        f"{int((err > tol).sum())} of {err.numel()} gradients off, worst "
        f"err/tol {(err / tol).max().item():.3g} at "
        f"{divmod(int((err / tol).argmax()), x.shape[1])}")


@pytest.mark.parametrize("rows,vocab", [(32, 1000), (64, 1000), (5, 2049), (256, 32768),
                                        (3, 7), (3, 1001), (7, 8191), (2, 151936),
                                        (4, 32003)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ls_xent_kernels_match_plain(cuda, rows, vocab, dtype):
    g_ = _gen(cuda, 1)
    x = (4 * torch.randn(rows, vocab, generator=g_, device=cuda)).to(dtype)
    y = _pin_labels(x, torch.randint(0, vocab, (rows,), generator=g_, device=cuda))
    gout = torch.rand(rows, generator=g_, device=cuda)
    _assert_xent_kernels_match_plain(x, y, gout, ls_xent_fwd_cuda, ls_xent_bwd_cuda)


@pytest.mark.parametrize("threads", ls_xent.ROW_THREADS)
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ls_xent_every_row_mapping_matches_plain(cuda, threads, offset, dtype):
    """Each row mapping the kernels take, on logits that start ``offset``
    elements past a 16-byte boundary (every row then has a scalar head)."""
    g_ = _gen(cuda, 4)
    rows, vocab = 9, 4099
    flat = (4 * torch.randn(rows * vocab + offset, generator=g_, device=cuda)).to(dtype)
    x = flat[offset:].view(rows, vocab)
    y = _pin_labels(x, torch.randint(0, vocab, (rows,), generator=g_, device=cuda))
    gout = torch.rand(rows, generator=g_, device=cuda)
    _assert_xent_kernels_match_plain(
        x, y, gout,
        lambda *a: ls_xent._fwd_launch(*a, threads),
        lambda *a: ls_xent._bwd_launch(*a, threads))


def test_ls_xent_kernels_repeat_bit_for_bit(cuda):
    g_ = _gen(cuda, 5)
    x = 4 * torch.randn(64, 151936, generator=g_, device=cuda)
    y = torch.randint(0, 151936, (64,), generator=g_, device=cuda)
    gout = torch.rand(64, generator=g_, device=cuda)
    a, b = ls_xent_fwd_cuda(x, y, 0.1), ls_xent_fwd_cuda(x, y, 0.1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(ls_xent_bwd_cuda(x, y, a[1], gout, 0.1),
                       ls_xent_bwd_cuda(x, y, a[1], gout, 0.1))


@pytest.mark.parametrize("vocab", [1000, 151936])
def test_ls_xent_label_outside_the_vocab_gives_nan(cuda, vocab):
    x = torch.randn(3, vocab, device=cuda)
    y = torch.tensor([1, vocab, -1], device=cuda)
    loss, lse = ls_xent_fwd_cuda(x, y, 0.1)
    d = ls_xent_bwd_cuda(x, y, lse, torch.ones(3, device=cuda), 0.1)
    assert torch.isfinite(loss[0]) and torch.isnan(loss[1:]).all()
    assert torch.isfinite(lse).all()
    assert torch.isfinite(d[0]).all() and torch.isnan(d[1:]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [-1, 10])
def test_masked_pad_label_gives_a_finite_loss_and_zero_gradient(cuda, dtype, pad):
    """A row masked by ``where`` may carry a pad label outside [0, V): the
    loss and gradients equal the host's, finite, and 0 on that row."""
    g_ = _gen(torch.device("cpu"), 0)
    x = torch.randn(4, 10, generator=g_).to(dtype)
    y = torch.tensor([1, 2, pad, 3])
    where = torch.tensor([True, True, False, True])
    out = []
    for dev in ("cpu", cuda):
        xd = x.to(dev, copy=True).requires_grad_(True)
        loss = losses.label_smoothing_xent(xd, y.to(dev), 0.1, where=where.to(dev))
        loss.backward()
        out.append((loss.detach().cpu(), xd.grad.float().cpu()))
    (l_host, g_host), (l_card, g_card) = out
    assert torch.isfinite(l_card) and torch.isfinite(g_card).all()
    assert torch.equal(g_card[2], torch.zeros(10))
    torch.testing.assert_close(l_card, l_host, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_card, g_host, rtol=2 ** -7 if dtype == torch.bfloat16
                               else 1e-5, atol=1e-6)


@pytest.mark.parametrize("vocab,dtype", [(1000, torch.float32), (151936, torch.bfloat16)])
def test_label_smoothing_xent_launches_each_kernel_once(cuda, vocab, dtype):
    x = torch.randn(2, 8, vocab, device=cuda).to(dtype).requires_grad_(True)
    y = torch.randint(0, vocab, (2, 8), device=cuda)
    ops.reset_launch_counts()
    losses.label_smoothing_xent(x, y, 0.1).backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ls_xent_fwd"] == 1 and counts["ls_xent_bwd"] == 1
    assert torch.isfinite(x.grad).all()


def test_ls_xent_autograd_on_the_card_matches_the_host(cuda):
    g_ = _gen(torch.device("cpu"), 2)
    x = 3 * torch.randn(2, 6, 1000, generator=g_)
    y = torch.randint(0, 1000, (2, 6), generator=g_)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev, copy=True).requires_grad_(True)
        loss = losses.label_smoothing_xent(xd, y.to(dev), 0.1)
        loss.backward()
        grads.append((loss.detach().cpu(), xd.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-5, atol=1e-7)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 10, device=cuda)
    y = torch.tensor([1, 2, 3, 4], device=cuda)
    with pytest.raises(TypeError):
        ls_xent_fwd_cuda(x.half(), y, 0.1)
    with pytest.raises(ValueError):      # (4, 10), not contiguous
        ls_xent_fwd_cuda(torch.randn(10, 4, device=cuda).t(), y, 0.1)
    with pytest.raises(ValueError):
        ls_xent_fwd_cuda(x, y.cpu(), 0.1)
    with pytest.raises(ValueError):      # no kernel takes 48 threads a row
        ls_xent._fwd_launch(x, y, 0.1, 48)
    with pytest.raises(TypeError):
        lars_update_cuda([x.double()], [x.double()], [x.double()], [True], **LARS_KW)


def test_tiny_resnet_trains_the_same_on_the_card_and_the_host(cuda):
    cfg = resnet.ResNetConfig.tiny(compute_dtype=torch.float32)
    models = {d: resnet.init(cfg, seed=3, device=d) for d in ("cpu", "cuda")}
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    data = SyntheticImageNet(num_classes=10, image_size=32, seed=2, device="cpu")
    plan = build_plan(BatchSchedule((BatchStage(0, 1, 8),)), dataset_size=24,
                      n_workers=1)
    ops.reset_launch_counts()
    out = {}
    for d, m in models.items():
        def loss_fn(params, batch, grid, m=m):
            logits = resnet.apply(m, batch[0], params=params, grid=grid)
            return losses.label_smoothing_xent(logits, batch[1], 0.1), torch.zeros(())
        # fp32 comm: at one rank the sync is then the identity on both devices
        cfg = TrainerConfig(log_every=1, grad_sync=GradSyncConfig(comm_dtype=torch.float32))
        trainer = Trainer(loss_fn, cfg, plan,
                          lambda i, gb, d=d: tuple(t.to(d) for t in data.batch(i, gb)))
        state, hist = trainer.run(TrainState.create(dict(m.named_parameters())),
                                  log=lambda s: None)
        out[d] = (state, [h["loss"] for h in hist])
    n_lars = sum(1 for n in out["cpu"][0].params if "kernel" in n)
    assert n_lars > 0
    # every leaf, LARS and skip, in two launches a step
    # and each of the 9 BNs (stem, 2 blocks x 3, 2 projections) through the
    # BN kernels, two launches forward and two backward a step
    assert ops.launch_counts() == {"lars_update": 2 * 3, "ls_xent_fwd": 3,
                                   "ls_xent_bwd": 3, "flash_attn": 0,
                                   "flash_attn_f32": 0, "flash_attn_bwd": 0,
                                   "flash_attn_bwd_f32": 0, "bn_fwd_stats": 9 * 3,
                                   "bn_fwd_apply": 9 * 3, "bn_bwd_sums": 9 * 3,
                                   "bn_bwd_dx": 9 * 3}
    # cuDNN and the host sum convolutions in different orders
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
    for k, p in out["cpu"][0].params.items():
        torch.testing.assert_close(out["cuda"][0].params[k].cpu(), p, rtol=1e-4, atol=1e-4)


def assert_flash_close(got, q, k, v, **kw):
    """The kernel's output within ``ref.flash_attention_tol`` of the plain
    version: fp32 1e-5 + 1e-5|ref| of the exact answer (the plain version
    in fp64; an fp32 one lies up to 3.4x that bound from it where the
    logits are large); bf16 adds one bf16 rounding of the output (2^-7|ref|)
    and of each probability before P . V (2^-8 P.|v|)."""
    if q.dtype == torch.float32:
        want = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    else:
        want = ref.flash_attention_ref(q, k, v, **kw).double()
    err = (got.double() - want).abs()
    bound = ref.flash_attention_tol(q, k, v, want, **kw)
    assert bool((err <= bound).all()), (
        f"max err {err.max().item():.3e}, worst err/bound {(err / bound).max().item():.3f}")


FLASH_WRAPPER = {torch.float32: flash_attention_f32, torch.bfloat16: flash_attention_tc}


@pytest.mark.parametrize("b,s,skv,h,hkv,d", [
    (2, 64, 64, 2, 2, 32), (1, 200, 200, 4, 2, 64), (2, 128, 128, 4, 1, 128),
    (1, 96, 96, 2, 1, 256), (1, 1000, 1000, 2, 1, 128), (1, 64, 130, 2, 2, 64),
    (1, 77, 300, 8, 2, 256), (2, 300, 77, 4, 4, 32), (1, 129, 257, 4, 1, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, s, skv, h, hkv, d, causal, dtype):
    g_ = _gen(cuda, s + d)
    q = torch.randn(b, s, h, d, generator=g_, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, d, generator=g_, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, d, generator=g_, device=cuda).to(dtype)
    before = FLASH_WRAPPER[dtype].launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_WRAPPER[dtype].launches == before + 1
    assert_flash_close(got, q, k, v, causal=causal)


@pytest.mark.parametrize("window,softcap,scale", [(16, None, None), (256, 50.0, None),
                                                  (48, 30.0, 0.1), (None, 50.0, 0.05)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window_softcap_scale(cuda, window, softcap, scale, dtype):
    g_ = _gen(cuda, 5)
    q = (3 * torch.randn(2, 300, 4, 128, generator=g_, device=cuda)).to(dtype)
    k = (3 * torch.randn(2, 300, 2, 128, generator=g_, device=cuda)).to(dtype)
    v = torch.randn(2, 300, 2, 128, generator=g_, device=cuda).to(dtype)
    kw = dict(causal=True, window=window, softcap=softcap, scale=scale)
    assert_flash_close(ops.flash_attention(q, k, v, **kw), q, k, v, **kw)
    if window is not None and window < 300:
        # fewer keys than queries: the last row keeps one key and agrees; one
        # key fewer leaves it none, which the wrapper refuses on both devices
        skv = 300 - window + 1
        kc, vc = k[:, :skv].contiguous(), v[:, :skv].contiguous()
        assert_flash_close(ops.flash_attention(q, kc, vc, **kw), q, kc, vc, **kw)
        for dev in (cuda, "cpu"):
            with pytest.raises(ValueError, match="no key"):
                ops.flash_attention(q.to(dev), kc[:, 1:].contiguous().to(dev),
                                    vc[:, 1:].contiguous().to(dev), **kw)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("causal,window,softcap,scale", [
    (True, 100, 50.0, 0.07), (False, None, 30.0, None), (False, 64, None, 0.2)])
@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_tc_kernel_features_at_every_head_dim(cuda, d, causal, window, softcap,
                                                    scale, hkv, dtype):
    """Both tensor-core kernels (bf16; fp32 in 3xTF32) with masks, softcap,
    scale, S = 333 and Skv = 290 (a multiple of no tile) and H/Hkv of 1, 2
    and 4, at each head dim. fp32 takes q and k at unit scale: at 2x the
    logits reach ~50 (scale 0.2 at D 256), where the fp32 plain version
    itself lies up to 3.5x the fp32 bound from the exact answer;
    ``test_flash_f32_kernel_beats_fp32_where_logits_are_large`` takes those."""
    g_ = _gen(cuda, d + hkv)
    s, skv = 333, 290
    mag = 2.0 if dtype == torch.bfloat16 else 1.0
    q = (mag * torch.randn(2, s, 4, d, generator=g_, device=cuda)).to(dtype)
    k = (mag * torch.randn(2, skv, hkv, d, generator=g_, device=cuda)).to(dtype)
    v = torch.randn(2, skv, hkv, d, generator=g_, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    before = FLASH_WRAPPER[dtype].launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH_WRAPPER[dtype].launches == before + 1
    assert_flash_close(got, q, k, v, **kw)


@pytest.mark.parametrize("s,skv,d,mag,kw", [
    (300, 300, 128, 3.0, dict(causal=True, window=16)),
    (333, 290, 256, 2.0, dict(causal=False, window=64, scale=0.2)),
    (333, 290, 256, 2.0, dict(causal=False, softcap=30.0))])
def test_flash_f32_kernel_beats_fp32_where_logits_are_large(cuda, s, skv, d, mag, kw):
    """Where the logits reach 10-50, fp32 arithmetic itself misses the fp32
    bound: the kernel lies no farther from the exact answer than the fp32
    plain version does."""
    g_ = _gen(cuda, d)
    q = mag * torch.randn(2, s, 4, d, generator=g_, device=cuda)
    k = mag * torch.randn(2, skv, 2, d, generator=g_, device=cuda)
    v = torch.randn(2, skv, 2, d, generator=g_, device=cuda)
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    bound = ref.flash_attention_tol(q, k, v, exact, **kw)
    got = ops.flash_attention(q, k, v, **kw).double()
    plain = ref.flash_attention_ref(q, k, v, **kw).double()
    worst = ((got - exact).abs() / bound).max().item()
    worst_plain = ((plain - exact).abs() / bound).max().item()
    assert worst <= worst_plain, (worst, worst_plain)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_f32_kernel_keeps_the_low_bits(cuda, d):
    """Inputs whose answer lives in the mantissa bits one TF32 product drops
    (tests/_torch_flash_data.py): the fp32 kernel holds the fp32 bound
    against the exact answer, which a kernel without the hi.lo or the lo.hi
    product of either matmul misses by 9x or more."""
    q, k, v = (x.to(cuda) for x in low_bit_qkv(d, d=d))
    before = flash_attention_f32.launches
    got = ops.flash_attention(q, k, v, causal=True, scale=SCALE)
    torch.cuda.synchronize()
    assert flash_attention_f32.launches == before + 1
    assert_flash_close(got, q, k, v, causal=True, scale=SCALE)


def _leaves(dev, shapes, seed):
    g_ = _gen(dev, seed)
    return [tuple((s * torch.randn(shape, generator=g_, device=dev)).contiguous()
                  for s in (0.05, 0.01, 1e-3)) for shape in shapes]


# LARS leaves and skip leaves from 7 to 2.4 M elements; the last leaf sits one
# float past a 16-byte boundary, which takes the kernels' scalar path
MIXED = [((7,), True), ((64,), False), ((1000,), False), ((2048, 1000), True),
         ((512, 512, 3, 3), True), ((256, 129), True), ((2048,), False),
         ((3, 3, 3, 64), True), ((1,), False)]


@pytest.mark.parametrize("nesterov", [False, True])
def test_lars_multi_tensor_step_matches_plain(cuda, nesterov):
    leaves = _leaves(cuda, [s for s, _ in MIXED], 7)
    bufs = [s * torch.randn(1000, generator=_gen(cuda, 3), device=cuda)
            for s in (0.05, 0.01, 1e-3)]
    leaves.append(tuple(b[1:] for b in bufs))   # 4-byte, not 16-byte aligned
    lars = [x for _, x in MIXED] + [True]
    ps, gs, vs = (list(t) for t in zip(*leaves))
    before = lars_update_cuda.launches
    got_p, got_v = ops.lars_update_leaves(ps, gs, vs, lars, **LARS_KW, nesterov=nesterov)
    torch.cuda.synchronize()
    assert lars_update_cuda.launches == before + 2
    want_p, want_v = ref.lars_update_leaves_ref(ps, gs, vs, lars, **LARS_KW,
                                                nesterov=nesterov)
    for a, b, p in zip(got_p + got_v, want_p + want_v, ps + ps):
        assert a.shape == p.shape and a.dtype == torch.float32
        # fp32 both ways; the norms sum in another order, the kernel contracts
        # multiply-adds
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_lars_multi_tensor_step_repeats_bit_for_bit(cuda):
    leaves = _leaves(cuda, [s for s, _ in MIXED], 8)
    ps, gs, vs = (list(t) for t in zip(*leaves))
    lars = [x for _, x in MIXED]
    runs = [ops.lars_update_leaves(ps, gs, vs, lars, **LARS_KW) for _ in range(2)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


def test_lars_multi_tensor_step_splits_a_long_table(cuda):
    """More leaves than one launch's table holds: a pair of launches a table."""
    n = 2 * MAX_LEAVES + 3
    leaves = _leaves(cuda, [(5 + i % 17,) for i in range(n)], 9)
    ps, gs, vs = (list(t) for t in zip(*leaves))
    lars = [i % 3 != 0 for i in range(n)]
    before = lars_update_cuda.launches
    got_p, got_v = ops.lars_update_leaves(ps, gs, vs, lars, **LARS_KW)
    torch.cuda.synchronize()
    assert lars_update_cuda.launches == before + 2 * 3
    want_p, want_v = ref.lars_update_leaves_ref(ps, gs, vs, lars, **LARS_KW)
    for a, b in zip(got_p + got_v, want_p + want_v):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_lars_wrapper_refuses_cpu_mixed_and_non_fp32_leaves(cuda):
    x = torch.randn(10, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        lars_update_cuda([x.cpu()], [x.cpu()], [x.cpu()], [True], **LARS_KW)
    with pytest.raises(ValueError, match="is on cpu"):
        lars_update_cuda([x, x], [x, x.cpu()], [x, x], [True, False], **LARS_KW)
    with pytest.raises(TypeError, match="float32"):
        lars_update_cuda([x], [x.bfloat16()], [x], [True], **LARS_KW)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.randn(4, 4, device=cuda).t()
        lars_update_cuda([y], [y], [y], [True], **LARS_KW)


# (B, S, Skv, H, Hkv, D, causal, window, softcap): causal, window, softcap,
# GQA and MQA, a ragged Skv, the unmasked cross layer, every head dim; D 256
# twice (bf16: the warpgroups split the head dim; fp32: the FMA kernels),
# the second MQA under a window and a softcap, S a multiple of no tile
BWD_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None),
    (2, 100, 100, 4, 2, 32, True, 16, 50.0),
    (1, 200, 137, 4, 1, 128, False, None, None),
    (1, 256, 256, 2, 1, 256, True, 100, None),
    (1, 256, 256, 4, 2, 128, True, None, 30.0),
    (2, 77, 77, 8, 8, 64, True, None, None),
    (2, 64, 1601, 8, 2, 128, False, None, None),
    (2, 300, 300, 4, 1, 256, True, 130, 30.0),
]


def _bwd_inputs(dev, case, dtype, seed=0, mag=1.0):
    """q, k, v, the forward kernel's o and lse, dO; q and k times ``mag``."""
    b, s, skv, h, hkv, d, causal, window, softcap = case
    g_ = _gen(dev, seed)
    q, do = (torch.randn(b, s, h, d, generator=g_, device=dev) for _ in range(2))
    k, v = (torch.randn(b, skv, hkv, d, generator=g_, device=dev) for _ in range(2))
    q, k = mag * q, mag * k
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, lse, do), kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    (q, k, v, o, lse, do), kw = _bwd_inputs(cuda, case, dtype)
    _, want_lse = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                          return_lse=True, **kw)
    # the forward's lse: the row sums in fp32
    torch.testing.assert_close(lse.double(), want_lse, rtol=1e-6, atol=1e-5)
    _check_bwd(q, k, v, o, lse, do, dtype, kw)


def _check_bwd(q, k, v, o, lse, do, dtype, kw):
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    if dtype == torch.float32:   # the exact answer (see flash_attention_bwd_tol)
        want = ref.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse, do)), **kw)
    else:
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
    for e in ref.flash_attention_bwd_errors(got, want, q, k, v, o, lse, do, **kw):
        assert e["err_over_tol"] <= 1 and e["norm_over_limit"] <= 1, e


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[-1]])
def test_flash_bwd_kernel_matches_plain_where_logits_reach_the_softcap(cuda, case, dtype):
    """q and k scaled x4, so that |s| reaches the cap and the backward's
    factor 1 - tanh^2(s / softcap) falls well under 1 (unscaled randn
    inputs keep it over 0.99, where a kernel without it would pass)."""
    (q, k, v, o, lse, do), kw = _bwd_inputs(cuda, case, dtype, seed=5, mag=4.0)
    _check_bwd(q, k, v, o, lse, do, dtype, kw)


def test_flash_bwd_repeats_bit_for_bit(cuda):
    for case in (BWD_CASES[4], BWD_CASES[7]):   # D 128 GQA, D 256 MQA
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = _bwd_inputs(cuda, case, dtype, seed=1)
            runs = [flash_attention_bwd_cuda(*args, **kw) for _ in range(2)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*runs)), (case, dtype)


def test_flash_attention_under_autograd_launches_the_backward(cuda):
    """On the card ``ops.flash_attention`` under autograd is the forward
    kernel with lse and the backward kernel as its gradient."""
    (q, k, v, _, _, do), kw = _bwd_inputs(cuda, BWD_CASES[1], torch.float32, seed=2)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), do)
    counts = ops.launch_counts()
    assert counts["flash_attn_f32"] == 1 and counts["flash_attn_bwd_f32"] == 1
    with torch.no_grad():
        o, lse = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                         return_lse=True, **kw)
        want = ref.flash_attention_bwd_ref(q.double(), k.double(), v.double(), o, lse,
                                           do.double(), **kw)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.double(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,remat", [
    pytest.param(a, r, id=a + ("-remat" if r else ""))
    for r in (False, True)
    for a in ("qwen3-1.7b", "gemma2-27b", "recurrentgemma-9b", "llama-3.2-vision-90b")])
def test_transformer_gradients_card_vs_host(cuda, arch, remat):
    """The smoke transformer's loss gradients, fp32, on the card (the flash
    forward and backward kernels) and on the host (the plain attention
    under autograd), from the same weights and batch. One forward and one
    backward launch an attention layer; with ``remat`` the forward runs
    again in backward, so two forwards."""
    import dataclasses

    from repro_torch.launch import train as launch_train
    cfg = dataclasses.replace(registry.get_smoke(arch), compute_dtype=torch.float32,
                              remat=remat)
    host = T.init(cfg, seed=0, device="cpu")
    g_ = torch.Generator().manual_seed(1)
    batch = [torch.randint(0, cfg.vocab, (2, 40), generator=g_) for _ in range(2)]
    if cfg.vision_tokens:
        batch.append(torch.randn(2, cfg.vision_tokens, cfg.cross_kv_dim, generator=g_))
    loss_fn = launch_train.loss_fn_for(cfg, 0.1)
    grads = {}
    for d in ("cpu", "cuda"):
        params = {k: p.detach().to(d).requires_grad_(True) for k, p in host.named_parameters()}
        ops.reset_launch_counts()
        loss, aux = loss_fn(params, tuple(t.to(d) for t in batch), None)
        names = list(params)
        grads[d] = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        if d == "cuda":
            n_attn = sum(k in ("attn", "local", "cross") for k in cfg.kinds())
            counts = ops.launch_counts()
            assert counts["flash_attn_bwd_f32"] == n_attn
            assert counts["flash_attn_f32"] == (2 if remat else 1) * n_attn
    for name, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][name].cpu(), g, rtol=1e-4, atol=1e-6,
                                   msg=name)


def test_grouped_lars_kernel_matches_plain_across_two_tables(cuda):
    """A group of leaves split over two launches' tables (more than
    MAX_LEAVES leaves) takes one trust ratio from the norms over all of
    them, as the plain version computes it."""
    g_ = _gen(cuda, 3)
    n = MAX_LEAVES + 40
    ps, gs, vs = ([s * torch.randn(257, generator=g_, device=cuda) for _ in range(n)]
                  for s in (1.0, 0.1, 0.01))
    lars = [True] * (n - 10) + [False] * 10
    groups = [1] * (MAX_LEAVES - 30) + [60] + [1] * (n - 10 - MAX_LEAVES - 30) + [10]
    before = lars_update_cuda.launches
    got = ops.lars_update_leaves(ps, gs, vs, lars, **LARS_KW, groups=groups)
    want = ref.lars_update_leaves_ref(ps, gs, vs, lars, **LARS_KW, groups=groups)
    torch.cuda.synchronize()
    assert lars_update_cuda.launches == before + 4     # two tables: 2 norms, 2 updates
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError):        # head dim 48 has no kernel
        x = torch.randn(1, 8, 2, 48, device=cuda)
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError):        # 3 query heads over 2 kv heads
        flash_attention_cuda(torch.randn(1, 8, 3, 64, device=cuda), q, q)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(1, 2), q, q)


def _moe_params(cfg, dev, seed):
    from repro_torch.nn import moe as M
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: dict(v.items()) for k, v in M.moe_init(gen, cfg).items()}


def test_moe_combine_repeats_bit_for_bit(cuda):
    """granite's MoE layer at its widths (d 1536, 40 experts of 512, top 8)
    on 4096 bf16 tokens: the combine gathers each token's k slots and adds
    them by ascending expert, so two runs give the same bits (a bf16
    ``index_add_`` would add in the order its atomics land)."""
    from repro_torch.nn import moe as M
    cfg = M.MoEConfig(d_model=1536, d_ff=512, n_experts=40, top_k=8)
    p = _moe_params(cfg, cuda, 0)
    x = torch.randn(2, 2048, 1536, generator=_gen(cuda, 1), device=cuda).bfloat16()
    with torch.inference_mode():
        a, aux_a = M.moe_apply(p, x, cfg)
        b, aux_b = M.moe_apply(p, x, cfg)
        _, topk_e, _ = M.route(p, x.reshape(-1, 1536), cfg)
        ye = torch.randn(40, cfg.capacity(4096), 1536, generator=_gen(cuda, 2),
                         device=cuda).bfloat16()
        _, slot_of = M.dispatch(topk_e, cfg.capacity(4096), 40)
        c1, c2 = M.combine(ye, slot_of, topk_e), M.combine(ye, slot_of, topk_e)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b) and torch.equal(c1, c2)
    assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())


def _smoke_card_vs_host(cuda, arch):
    """fp32 (TF32 off), the same weights (and vision input): forward logits
    and the MoE aux within fp32 summation noise (1e-4 relative to the
    largest logit), and prefill plus decode caches of the same shapes and
    dtypes."""
    import dataclasses
    cfg = dataclasses.replace(registry.get_smoke(arch), compute_dtype=torch.float32)
    host = T.init(cfg, seed=4, device="cpu")
    card = T.init(cfg, seed=4, device=cuda)
    card.load_state_dict(host.state_dict())
    cpu_gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(1, cfg.vocab, (2, 24), generator=cpu_gen)
    vision = (torch.randn(2, cfg.vision_tokens, cfg.cross_kv_dim, generator=cpu_gen)
              if cfg.vision_tokens else None)
    card_vision = None if vision is None else vision.to(cuda)
    with torch.inference_mode():
        want, want_aux = T.forward(host, tokens, cfg, vision=vision)
        got, aux = T.forward(card, tokens.to(cuda), cfg, vision=card_vision)
        _, hc = T.prefill(host, tokens, cfg, vision=vision, cache_len=28)
        _, cc = T.prefill(card, tokens.to(cuda), cfg, vision=card_vision, cache_len=28)
        _, cc = T.decode_step(card, tokens[:, :1].to(cuda), cc, 24, cfg)
    scale = want.abs().max().item()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=0.0)
    for h, c in zip(hc, cc):
        assert {k: (v.shape, v.dtype) for k, v in h.items()} == \
            {k: (v.shape, v.dtype) for k, v in c.items()}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "kimi-k2-1t-a32b", "mamba2-2.7b"])
def test_moe_and_ssd_smoke_configs_on_the_card_match_the_host(cuda, arch):
    _smoke_card_vs_host(cuda, arch)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "llama-3.2-vision-90b"])
def test_rglru_and_vlm_smoke_configs_on_the_card_match_the_host(cuda, arch):
    _smoke_card_vs_host(cuda, arch)


@pytest.mark.parametrize("b,s,skv,h,hkv,d,kw", [
    # recurrentgemma-9b's local layers (MQA at D 256) at twice the serve
    # length, so that the band of window 2048 skips key blocks
    (2, 4096, 4096, 16, 1, 256, dict(causal=True, window=2048)),
    # llama-3.2-vision-90b's cross layer at the serve shape: 1601 keys
    (8, 2048, 1601, 64, 8, 128, dict(causal=False)),
])
def test_flash_tc_kernel_at_the_rglru_and_vlm_serve_shapes(cuda, b, s, skv, h, hkv, d, kw):
    g_ = _gen(cuda, d + skv)
    q = torch.randn(b, s, h, d, generator=g_, device=cuda).bfloat16()
    k = torch.randn(b, skv, hkv, d, generator=g_, device=cuda).bfloat16()
    v = torch.randn(b, skv, hkv, d, generator=g_, device=cuda).bfloat16()
    before = flash_attention_tc.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_tc.launches == before + 1
    assert_flash_close(got, q, k, v, **kw)


# -- batch norm (csrc/batchnorm.cu) ------------------------------------------------

BN_CASES = ([(c, torch.bfloat16) for c, _ in profile_bn.distinct(
    profile_bn.calls(resnet.ResNetConfig.resnet50(), 256))]
    + [(c, torch.float32) for c, _ in profile_bn.distinct(
        profile_bn.calls(resnet.ResNetConfig.tiny(), 8))])


@pytest.mark.parametrize("case", BN_CASES, ids=lambda c: f"{c[0].name}-{str(c[1])[6:]}")
def test_bn_kernels_match_plain_at_every_resnet50_shape(cuda, case):
    """Every distinct BN of ResNet-50 at 256 images in bf16, and of the fp32
    tiny config (C 8 to 64): the two sums within 2^-14 of the sum of their
    terms' magnitudes (the same terms added in another order), every other
    output equal to the plain version's bit for bit given the kernels' own
    sums (the same uncontracted fp32 operations), and a second call the
    same bytes (``profile_bn.check``)."""
    c, dtype = case
    r = profile_bn.check(c, dtype, _gen(cuda, 0))
    assert r["stats_err_over_tol"] <= 1 and r["bwd_sums_err_over_tol"] <= 1, r
    assert all(r["bitwise"].values()) and r["repeats"], r


def test_bn_autograd_repeats_bit_for_bit(cuda):
    """Forward and backward through ``ops.batchnorm`` twice at the stem's
    shape (a ReLU) and at stage 4's ``bn3`` (residual and ReLU): the same
    bytes; no float atomics, every sum in an order that the shape fixes."""
    cs = profile_bn.calls(resnet.ResNetConfig.resnet50(), 256)
    for c in (cs[0], cs[-1]):
        x, scale, bias, res, dy = profile_bn.inputs(c, torch.bfloat16, _gen(cuda, 1))
        outs = []
        for _ in range(2):
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias, res)
                      if t is not None]
            y, stats = ops.batchnorm(*leaves[:3], relu=c.relu,
                                     residual=leaves[3] if c.residual else None,
                                     return_stats=True)
            outs.append([y, *stats, *torch.autograd.grad(y, leaves, dy)])
        assert all(torch.equal(a, b) for a, b in zip(*outs)), c.name


def test_resnet50_step_launches_each_bn_kernel_53_times(cuda):
    """One training step of ResNet-50 at 256 images through ``Trainer.run``:
    all 53 BNs through the kernels, forward and backward, and nothing else
    launched them."""
    model, data_fn, loss_fn, _ = profile_trainer.resnet50_path(cuda)
    plan = build_plan(BatchSchedule((BatchStage(0, 1, 256),)), dataset_size=256,
                      n_workers=1, max_steps=1)
    ops.reset_launch_counts()
    Trainer(loss_fn, TrainerConfig(log_every=1), plan, data_fn).run(
        TrainState.create(dict(model.named_parameters())), log=lambda s: None)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ls_xent_fwd"] == 1
    for name in ("bn_fwd_stats", "bn_fwd_apply", "bn_bwd_sums", "bn_bwd_dx"):
        assert counts[name] == 53, counts


def test_bn_kernel_names_are_classed_outside_matmul_nccl_and_port(cuda):
    """The benchmark classes device ops by name (``bench/harness/classes.py``,
    first match wins): the BN kernels' demangled names, template arguments
    and namespace included, must fall in none of the convolution / matmul,
    NCCL or port classes, so that their time counts where BN's did."""
    from bench.harness import classes

    c = profile_bn.calls(resnet.ResNetConfig.resnet50(), 8)[-1]     # bn3: all four
    names = set()
    for dtype in (torch.bfloat16, torch.float32):
        x, scale, bias, res, dy = profile_bn.inputs(c, dtype, _gen(cuda, 2))
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias, res)]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            y = ops.batchnorm(*leaves[:3], relu=True, residual=leaves[3])
            torch.autograd.grad(y, leaves, dy)
            torch.cuda.synchronize()
        names |= {e.name for e in prof.events() if "bn_" in e.name and "kernel" in e.name}
    stems = {"bn_fwd_stats_kernel", "bn_fwd_apply_kernel", "bn_bwd_sums_kernel",
             "bn_bwd_dx_kernel"}
    assert {s for s in stems if any(s in n for n in names)} == stems, names
    assert len(names) == 8, names       # four kernels x two types
    bad = {classes.MATMUL, classes.NCCL, *classes.PORT}
    assert not {n: classes.classify(n) for n in names if classes.classify(n) in bad}


def test_bn_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = _gen(cuda, 3)
    x = torch.randn(2, 16, 4, 4, generator=g, device=cuda)     # NCHW strides
    one = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        bn_kernels.bn_fwd_stats_cuda(x)
    with pytest.raises(ValueError, match="multiple of 8"):
        bn_kernels.bn_fwd_stats_cuda(torch.randn(2, 12, 4, 4, device=cuda).to(
            memory_format=torch.channels_last))
    with pytest.raises(TypeError):
        bn_kernels.bn_fwd_stats_cuda(x.half().to(memory_format=torch.channels_last))
    xc = x.to(memory_format=torch.channels_last)
    mv = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="scale"):     # the kernels load fp32 masters
        bn_kernels.bn_fwd_apply_cuda(xc, mv, one.bfloat16(), one, eps=1e-5)
    with pytest.raises(ValueError, match="channels-last"):
        ops.batchnorm(x, one, one)
