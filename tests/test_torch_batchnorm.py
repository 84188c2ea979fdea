"""The BN kernels' plain versions (``kernels/batchnorm.py:BatchNorm`` on the
host) against autograd through the port's earlier fp32 chain
(``kernels/ref.py:batchnorm_chain_ref``), which ``F.relu`` and the residual
add followed in the model; their launch plan; the model's BN calls; and the
grid's moments on four gloo ranks against one rank holding the whole batch.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``python3 -m repro_torch.launch.profile_bn``).
"""

import math

import numpy as np
import pytest
import torch

from _pt_parity import batchnorm_body, batchnorm_grads, launch
from repro_torch.kernels import batchnorm as K
from repro_torch.kernels import ops, ref
from repro_torch.launch import profile_bn
from repro_torch.models import resnet

EPS = 1e-5


def _arrays(seed: int, n=4, c=16, h=5, w=3, residual=True):
    """NHWC fp32 (x, scale, bias, residual or None, dy); x off zero mean, so
    that E[x²] - mean² differs from the centred variance's rounding."""
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(n, h, w, c) + 0.5).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (0.5 * rng.randn(c)).astype(np.float32)
    res = rng.randn(n, h, w, c).astype(np.float32) if residual else None
    return x, scale, bias, res, rng.randn(n, h, w, c).astype(np.float32)


def _chain(x, scale, bias, res, dy, *, relu, dtype, stats=None):
    """What ``_pt_parity.batchnorm_grads`` returns, from the earlier chain."""
    def act(a):
        return torch.from_numpy(a.copy()).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)

    xt, rt = act(x), None if res is None else act(res)
    st, bt = (torch.from_numpy(a.copy()).to(dtype).requires_grad_(True) for a in (scale, bias))
    y, (mean, var) = ref.batchnorm_chain_ref(xt, st, bt, stats=stats, eps=EPS, residual=rt,
                                            relu=relu)
    leaves = [t for t in (xt, st, bt, rt) if t is not None]
    grads = torch.autograd.grad(y, leaves, act(dy).detach())
    out = {"y": y, "mean": mean, "var": var}
    out.update(zip(("dx", "dscale", "dbias", "dres"), grads))
    return {k: v.detach().float().numpy() for k, v in out.items()}


def _grads(x, scale, bias, res, dy, *, relu, dtype, stats=None):
    if stats is None:
        return batchnorm_grads(x, scale, bias, res, dy, relu=relu, dtype=dtype)
    # eval: the Function with given (mean, var), differentiated as the chain is
    xt = torch.from_numpy(x.copy()).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)
    rt = None if res is None else torch.from_numpy(res.copy()).to(dtype).permute(
        0, 3, 1, 2).requires_grad_(True)
    st, bt = (torch.from_numpy(a.copy()).to(dtype).requires_grad_(True) for a in (scale, bias))
    y, (mean, var) = ops.batchnorm(xt, st, bt, stats=stats, relu=relu, residual=rt,
                                   return_stats=True)
    leaves = [t for t in (xt, st, bt, rt) if t is not None]
    d = torch.from_numpy(dy.copy()).to(dtype).permute(0, 3, 1, 2)
    grads = torch.autograd.grad(y, leaves, d)
    out = {"y": y, "mean": mean, "var": var}
    out.update(zip(("dx", "dscale", "dbias", "dres"), grads))
    return {k: v.detach().float().numpy() for k, v in out.items()}


# Tolerances of the plain versions against the chain. fp32: the same
# arithmetic in another order (moments as a sum times the fp32 reciprocal
# of the count, not mean(); the backward as its written-out formula, not
# autograd's graph), so a few units of fp32 rounding (2^-24 each) of each
# output's largest terms: 1e-6 of the output's largest magnitude (the
# largest reading, at 60 rows a channel, is a tenth of it). bf16: each side
# rounds its fp32 result to bf16 once (twice with a residual), so outputs
# may differ by an ulp, 2^-7 of their magnitude, plus the fp32 part.
def _tol(dtype, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    if dtype == torch.float32:
        return dict(rtol=1e-6, atol=1e-6 * scale)
    return dict(rtol=2.0 ** -7, atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_kernels_match_autograd_through_the_chain(relu, residual, train, dtype):
    x, scale, bias, res, dy = _arrays(7 + 2 * relu + residual, residual=residual)
    stats = None
    if not train:   # eval: given statistics, near the batch's but not them
        xf = torch.from_numpy(x).to(dtype).float()
        stats = (xf.mean((0, 1, 2)) + 0.1, xf.var((0, 1, 2)) * 1.5)
    got = _grads(x, scale, bias, res, dy, relu=relu, dtype=dtype, stats=stats)
    want = _chain(x, scale, bias, res, dy, relu=relu, dtype=dtype, stats=stats)
    assert set(got) == set(want)
    assert ("dres" in got) == residual
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **_tol(dtype, want[k]))
    if relu:   # the mask cut some gradients, and kept others
        assert 0 < np.count_nonzero(got["y"] == 0) < got["y"].size


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_relu_mask_recomputed_from_x_equals_the_stored_outputs(residual, dtype):
    """Without a residual the backward recomputes the ReLU's mask from x
    (``mask`` 1) and reads no output; it must equal threshold_backward's on
    the stored output bit for bit. With one the mask is read from the
    output (``mask`` 2), as autograd's F.relu(y + r) does."""
    x, scale, bias, res, dy = (None if a is None else torch.from_numpy(a).to(dtype)
                               for a in _arrays(3, c=8, residual=residual))
    x, dy = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    res = None if res is None else res.permute(0, 3, 1, 2)
    mv = ref.bn_moments_ref(ref.bn_stats_ref(x), x.numel() // x.shape[1])
    y = ref.bn_apply_ref(x, mv, scale, bias, eps=EPS, residual=res, relu=True)
    want = torch.ops.aten.threshold_backward(dy, y, 0)
    mask = 2 if residual else 1
    got = ref.bn_grad_in_ref(x, dy, y if residual else None, mv, scale, bias, eps=EPS,
                             mask=mask)
    assert torch.equal(got, want)
    if not residual:   # the recomputed value is the stored output before the ReLU
        v = ref.bn_apply_ref(x, mv, scale, bias, eps=EPS)
        assert torch.equal(torch.relu(v), y)


SHAPES = [(c.shape[0] * c.shape[2] * c.shape[3], c.shape[1]) for c, _ in profile_bn.distinct(
    profile_bn.calls(resnet.ResNetConfig.resnet50(), 256))] + [
    (1, 8), (7, 24), (100, 8), (31, 2056), (12544, 4096), (5, 64)]


@pytest.mark.parametrize("rows,channels", SHAPES)
def test_launch_plan_covers_every_row_and_channel_once(rows, channels):
    p = K.plan(rows, channels)
    assert p.lanes * p.rpp <= K.THREADS and p.lanes * K.VEC <= 64
    assert p.tiles * p.lanes * K.VEC >= channels > (p.tiles - 1) * p.lanes * K.VEC
    assert p.chunk_rows % p.rpp == 0
    assert p.chunks * p.chunk_rows >= rows > (p.chunks - 1) * p.chunk_rows
    assert p.chunks <= 65535 and p.tiles <= K.MAX_TILES
    # about CTAS CTAs where there are rows enough, and 4 rows a thread at least
    ctas = p.tiles * p.chunks
    assert ctas <= 2 * K.CTAS
    if rows >= 4 * p.rpp * K.CTAS:
        assert ctas >= K.CTAS // 2
    assert p.chunks == 1 or p.chunk_rows >= 4 * p.rpp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_fp32_masters_match_the_chain_on_their_cast(residual, dtype):
    """The model hands the BN its fp32 masters, which the Function rounds to
    x's dtype as the model's cast did: the outputs are the chain's on the
    cast parameters, and the masters' gradients are fp32, as the cast's
    backward gave them (values of x's dtype)."""
    x, scale, bias, res, dy = _arrays(5, residual=residual)
    scale = scale + 1e-3   # off the bf16 grid, so that the rounding shows

    def act(a):
        return torch.from_numpy(a.copy()).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)

    got, want = {}, {}
    for out, fn in ((got, ops.batchnorm), (want, None)):
        xt, rt = act(x), None if res is None else act(res)
        st, bt = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (scale, bias))
        if fn is None:
            y = ref.batchnorm_chain_ref(xt, st.to(dtype), bt.to(dtype), eps=EPS, residual=rt,
                                        relu=True)[0]
        else:
            y = fn(xt, st, bt, relu=True, residual=rt)
        leaves = [t for t in (xt, st, bt, rt) if t is not None]
        grads = torch.autograd.grad(y, leaves, act(dy).detach())
        out.update(zip(("y", "dx", "dscale", "dbias", "dres"), (y, *grads)))
    assert got["dscale"].dtype == got["dbias"].dtype == torch.float32
    assert torch.equal(got["dscale"], got["dscale"].to(dtype).float())
    for k in want:
        w = want[k].detach().float().numpy()
        np.testing.assert_allclose(got[k].detach().float().numpy(), w, err_msg=k,
                                   **_tol(dtype, w))


@pytest.mark.parametrize("bad", [(10, 12), (0, 64), (10, 0)])
def test_launch_plan_refuses_what_the_kernels_do_not_take(bad):
    with pytest.raises(ValueError):
        K.plan(*bad)


def test_resnet50_bn_calls_at_256_images():
    cs = profile_bn.calls(resnet.ResNetConfig.resnet50(), 256)
    assert len(cs) == 53 and len(profile_bn.distinct(cs)) == 16
    assert sum(math.prod(c.shape) for c in cs) == 256 * 11_113_984
    assert sum(c.relu and not c.residual for c in cs) == 1 + 2 * 16      # stem, bn1, bn2
    assert sum(c.residual for c in cs) == 16 and sum(not c.relu for c in cs) == 4
    fwd, bwd = (sum(profile_bn.call_bytes(c, 2)[i] for c in cs) for i in (0, 1))
    assert (fwd, bwd) == (19_896_991_744, 36_929_536_000)


def test_the_model_makes_the_calls_listed(monkeypatch):
    """``profile_bn.calls`` walks the model as it runs: every BN's input shape
    and epilogue, in order (ResNet-tiny)."""
    seen = []
    real = ops.batchnorm

    def record(x, scale, bias, **kw):
        seen.append((tuple(x.shape), kw["relu"], kw["residual"] is not None))
        assert x.is_contiguous(memory_format=torch.channels_last)
        # the fp32 masters, uncast: the BN rounds them itself
        assert scale.dtype == bias.dtype == torch.float32 and scale.is_leaf
        return real(x, scale, bias, **kw)

    monkeypatch.setattr(ops, "batchnorm", record)
    cfg = resnet.ResNetConfig.tiny(compute_dtype=torch.bfloat16)
    model = resnet.init(cfg, seed=0, device="cpu")
    model(torch.randn(2, 32, 32, 3))
    assert seen == [(c.shape, c.relu, c.residual) for c in profile_bn.calls(cfg, 2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {(relu, residual, str(dtype)): (_arrays(11 + 2 * relu + residual, n=8,
                                                     residual=residual), relu, dtype)
             for relu in (False, True) for residual in (False, True)
             for dtype in (torch.float32, torch.bfloat16)}
    port = launch(batchnorm_body, tmp_path_factory.mktemp("bn4"), (2, 2), cases, world=4)
    return cases, port


@pytest.mark.multidevice
@pytest.mark.parametrize("key", [(relu, residual, dt) for relu in (False, True)
                                 for residual in (False, True)
                                 for dt in ("torch.float32", "torch.bfloat16")])
def test_grid_moments_on_four_ranks_match_one_rank_with_the_whole_batch(ranks, key):
    """The forward's (Σx, Σx²) and the backward's (Σg, Σg·x̂) summed over a
    2 x 2 grid: each rank's rows of y, dx and the residual's gradient, and
    the statistics, as one rank computes them from the whole batch; the
    scale's and bias's gradients are each rank's own, and sum to the whole
    batch's. Tolerances as the chain's: the sums add in another order."""
    cases, port = ranks
    arrays, relu, dtype = cases[key]
    whole = batchnorm_grads(*arrays, relu=relu, dtype=dtype)
    per = arrays[0].shape[0] // 4
    for r, got in enumerate(port):
        got = got[key]
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], whole[k], rtol=1e-5, atol=1e-6, err_msg=k)
        for k in ("y", "dx", "dres"):
            if k in whole:
                want = whole[k][r * per:(r + 1) * per]
                np.testing.assert_allclose(got[k], want, err_msg=f"rank {r} {k}",
                                           **_tol(dtype, want))
    for k in ("dscale", "dbias"):
        total = sum(got[key][k] for got in port)
        # each rank's sum is rounded to the dtype once before the four are added
        slack = 0.0 if dtype == torch.float32 else 2.0 ** -8 * sum(
            np.abs(got[key][k]) for got in port)
        tol = _tol(dtype, whole[k])
        assert np.all(np.abs(total - whole[k])
                      <= tol["atol"] + tol["rtol"] * np.abs(whole[k]) + slack), k
