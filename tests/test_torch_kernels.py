"""The port's kernel modules against the JAX package's Pallas kernels.

The JAX side runs as tests/test_kernels.py runs it: through
``repro.kernels.ops`` in interpret mode. The port's side runs on CPU
tensors, which ``repro_torch.kernels.ops`` sends to the plain versions in
``repro_torch/kernels/ref.py``. Inputs come from numpy with a fixed seed and
go to both packages. tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on a card.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lars as jlars
from repro.core import losses as jlosses
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ls_xent, ops, ref
from repro_torch.kernels.batchnorm import (bn_bwd_dx_cuda, bn_bwd_sums_cuda, bn_fwd_apply_cuda,
                                           bn_fwd_stats_cuda)
from repro_torch.kernels.flash_attn import (flash_attention_cuda, flash_attention_f32,
                                            flash_attention_tc)
from repro_torch.kernels.lars_update import lars_update_cuda
from repro_torch.kernels.ls_xent import ls_xent_bwd_cuda, ls_xent_fwd_cuda

LARS_KW = dict(lr=0.5, mom=0.9, eta=0.01, weight_decay=5e-5, eps=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ ls_xent --

# rows of V % 8 != 0 end in a scalar tail after the kernel's 16-byte vectors;
# these cases put labels there: the tail's first column and its last (V - 1)
RAGGED = [(3, 1001), (5, 4099)]


def _pin_ragged(labels, vocab):
    flat = labels.reshape(-1)
    flat[0], flat[-1] = vocab - vocab % 8, vocab - 1
    return labels


@pytest.mark.parametrize("rows,vocab", [(4, 16), (3, 300), (130, 2048), (5, 2049), *RAGGED])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ls_xent_forward_matches_jax_kernel(rows, vocab, smoothing):
    rng = np.random.RandomState(rows * 1000 + vocab)
    logits = (rng.randn(rows, vocab) * 4).astype(np.float32)
    labels = rng.randint(0, vocab, (rows,))
    if (rows, vocab) in RAGGED:
        labels = _pin_ragged(labels, vocab)
    want = jops.ls_xent(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                        smoothing=smoothing, interpret=True)
    got = ops.ls_xent(_t(logits), _t(labels), smoothing=smoothing)
    assert got.dtype == torch.float32 and got.shape == (rows,)
    # fp32 on both sides; only the summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ls_xent_forward_bf16_logits():
    rng = np.random.RandomState(0)
    logits = (rng.randn(8, 512) * 3).astype(np.float32)
    labels = rng.randint(0, 512, (8,))
    jl = jnp.asarray(logits, jnp.bfloat16)
    want = jops.ls_xent(jl, jnp.asarray(labels, jnp.int32), smoothing=0.1,
                        interpret=True)
    got = ops.ls_xent(_t(logits).to(torch.bfloat16), _t(labels), smoothing=0.1)
    # both round the same fp32 values to bf16 (nearest even) and then
    # compute in fp32, so the fp32 tolerance holds
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 16), (3, 300), (8, 1000), (2, 6, 100), *RAGGED])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ls_xent_backward_matches_jax_grad(shape, smoothing):
    """The hand-written backward against jax.grad of core/losses.ls_xent_ref."""
    rng = np.random.RandomState(sum(shape))
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    labels = rng.randint(0, shape[-1], shape[:-1])
    if shape in RAGGED:
        labels = _pin_ragged(labels, shape[-1])
    gout = rng.rand(*shape[:-1]).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jlosses.ls_xent_ref(x, jnp.asarray(labels), smoothing),
                     jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(gout))
    x = _t(logits).requires_grad_(True)
    per = ops.ls_xent(x, _t(labels), smoothing=smoothing)
    per.backward(_t(gout))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ls_xent_backward_bf16_logits():
    rng = np.random.RandomState(5)
    logits = (rng.randn(6, 300) * 3).astype(np.float32)
    labels = rng.randint(0, 300, (6,))
    jl = jnp.asarray(logits, jnp.bfloat16)
    want = jax.grad(lambda x: jlosses.ls_xent_ref(x, jnp.asarray(labels), 0.1).mean())(jl)
    x = _t(logits).to(torch.bfloat16).requires_grad_(True)
    ops.ls_xent(x, _t(labels), smoothing=0.1).mean().backward()
    assert x.grad.dtype == torch.bfloat16
    # fp32 math on identical bf16 inputs; each side rounds its fp32 gradient
    # to bf16 once, so they may differ by one bf16 step (2^-8 relative)
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_ls_xent_int32_and_int64_labels_agree():
    rng = np.random.RandomState(3)
    logits = _t((rng.randn(5, 40)).astype(np.float32))
    labels = rng.randint(0, 40, (5,))
    a = ops.ls_xent(logits, _t(labels.astype(np.int32)), smoothing=0.1)
    b = ops.ls_xent(logits, _t(labels.astype(np.int64)), smoothing=0.1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ls_xent_row_mapping():
    """The threads a row that the wrappers pick, by row length, dtype and kernel."""
    # the ResNet-50 head, (32 | 64, 1000) fp32: a warp a row forward, 128 threads backward
    assert ls_xent.row_threads(1000, 4) == 32
    assert ls_xent.row_threads(1000, 4, backward=True) == 128
    # Qwen3-1.7B's vocab, 151,936
    assert ls_xent.row_threads(151936, 4) == ls_xent.row_threads(151936, 2) == 512
    assert ls_xent.row_threads(151936, 4, backward=True) == 512
    assert ls_xent.row_threads(151936, 2, backward=True) == 128
    picked = {ls_xent.row_threads(v, es, b) for v in range(1, 300000, 997)
              for es in (2, 4) for b in (False, True)}
    assert picked == set(ls_xent.ROW_THREADS)


@pytest.mark.parametrize("rows,vocab", [(2, 151936), (4, 32003)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ls_xent_bwd_tol_holds_every_gradient_at_long_rows(rows, vocab, dtype):
    """ref.ls_xent_bwd_tol passes the backward kernel's arithmetic (exponentials
    in the log2 domain) and fails a gradient with columns left at 0: those
    where softmax is under a/V (the label's aside), which a fixed atol of 1e-6
    let pass at Qwen3-1.7B's vocab, or only the row's last three."""
    g_ = torch.Generator().manual_seed(vocab)
    x = (4 * torch.randn(rows, vocab, generator=g_)).to(dtype)
    y = torch.randint(0, vocab, (rows,), generator=g_)
    gout = torch.rand(rows, generator=g_)
    lse = ref.ls_xent_fwd_ref(x, y, 0.1)[1]
    want = ref.ls_xent_bwd_ref(x, y, lse, gout, 0.1)
    tol = ref.ls_xent_bwd_tol(want, gout, 0.1)
    p = torch.exp2((x.float() - lse[:, None]) * 1.4426950408889634)
    hit = torch.nn.functional.one_hot(y, vocab).float()
    kernel_like = (gout[:, None] * (p - 0.1 / vocab - 0.9 * hit)).to(dtype).float()
    assert bool(((kernel_like - want.float()).abs() <= tol).all())
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    small = torch.where((p < 0.1 / vocab) & (hit == 0), 0.0, want.float())
    assert (small == 0).float().mean() > 0.5
    err = (small - want.float()).abs()
    assert not bool((err <= tol).all())
    if 0.1 / vocab < 1e-6:   # Qwen3-1.7B's vocab: every such column under 1e-6
        assert bool((err <= 1e-6 + rtol * want.float().abs()).all())
    no_tail = want.float().clone()
    no_tail[:, -3:] = 0
    assert not bool(((no_tail - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ls_xent_gradient_buffer_keeps_the_logits_offset(dtype):
    """The backward's output starts at the logits' offset from a 16-byte
    boundary, so the kernel's load and store vectors line up."""
    es = torch.tensor([], dtype=dtype).element_size()
    flat = torch.zeros(3 * 37 + 16 // es, dtype=dtype)
    for off in range(16 // es):
        x = flat[off:off + 3 * 37].view(3, 37)
        d = ls_xent._empty_at_offset_of(x)
        assert d.shape == x.shape and d.dtype == dtype and d.is_contiguous()
        assert d.data_ptr() % 16 == x.data_ptr() % 16


# --------------------------------------------------------------------- LARS --

SHAPES = [(7,), (128,), (64, 64), (33, 5), (8, 9, 10), (1, 1), (300, 129)]


@pytest.mark.parametrize("shape", SHAPES)
def test_lars_matches_jax_kernel_and_ref(shape):
    rng = np.random.RandomState(hash(shape) % 2**31)
    p = rng.randn(*shape).astype(np.float32)
    g = (rng.randn(*shape) * 0.1).astype(np.float32)
    v = (rng.randn(*shape) * 0.01).astype(np.float32)
    jp, jv = jops.lars_update(jnp.asarray(p), jnp.asarray(g), jnp.asarray(v),
                              **LARS_KW, interpret=True)
    rp, rv = jref.lars_update_ref(jnp.asarray(p), jnp.asarray(g), jnp.asarray(v),
                                  **LARS_KW)
    tp, tv = ops.lars_update(_t(p), _t(g), _t(v), **LARS_KW)
    for got, want in ((tp, jp), (tv, jv), (tp, rp), (tv, rv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nesterov", [False, True])
def test_lars_matches_jax_update_ref_path(nesterov):
    """The port's one path computes what update(use_kernel=False) computes,
    nesterov included (the JAX kernel path skips nesterov)."""
    rng = np.random.RandomState(11)
    p = rng.randn(32, 8).astype(np.float32)
    g = rng.randn(32, 8).astype(np.float32)
    v = (rng.randn(32, 8) * 0.01).astype(np.float32)
    cfg = jlars.LARSConfig(use_kernel=False, nesterov=nesterov)
    jp, jo = jlars.update({"w": {"kernel": jnp.asarray(p)}},
                          {"w": {"kernel": jnp.asarray(g)}},
                          {"momentum": {"w": {"kernel": jnp.asarray(v)}}},
                          lr=0.3, momentum=0.9, cfg=cfg)
    tp, tv = ops.lars_update(_t(p), _t(g), _t(v), lr=0.3, mom=0.9, eta=cfg.eta,
                             weight_decay=cfg.weight_decay, eps=cfg.eps,
                             nesterov=nesterov)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp["w"]["kernel"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jo["momentum"]["w"]["kernel"]),
                               rtol=1e-6, atol=1e-6)


def test_lars_zero_grad_trust_is_one():
    p, g, v = torch.ones(16), torch.zeros(16), torch.zeros(16)
    p_new, _ = ops.lars_update(p, g, v, lr=1.0, mom=0.9, eta=0.01,
                               weight_decay=0.0, eps=1e-6)
    torch.testing.assert_close(p_new, torch.ones(16), rtol=0, atol=0)
    assert ref.lars_trust(p, g, eta=0.01, weight_decay=0.0, eps=1e-6).item() == 1.0


# ---------------------------------------------------------- dispatch, build --

def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    x = torch.randn(4, 10, requires_grad=True)
    ops.ls_xent(x, torch.tensor([1, 2, 3, 4]), smoothing=0.1).sum().backward()
    ops.lars_update(torch.randn(8), torch.randn(8), torch.zeros(8), **LARS_KW)
    ops.flash_attention(torch.randn(1, 8, 2, 32), torch.randn(1, 8, 1, 32),
                        torch.randn(1, 8, 1, 32))
    h = torch.randn(2, 8, 3, 3, requires_grad=True).to(memory_format=torch.channels_last)
    ops.batchnorm(h, torch.ones(8), torch.zeros(8), relu=True).sum().backward()
    assert ops.launch_counts() == {"lars_update": 0, "ls_xent_fwd": 0,
                                   "ls_xent_bwd": 0, "flash_attn": 0,
                                   "flash_attn_f32": 0, "flash_attn_bwd": 0,
                                   "flash_attn_bwd_f32": 0, "bn_fwd_stats": 0,
                                   "bn_fwd_apply": 0, "bn_bwd_sums": 0, "bn_bwd_dx": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the host."""
    x = torch.randn(4, 10)
    y = torch.tensor([1, 2, 3, 4])
    with pytest.raises(ValueError):
        ls_xent_fwd_cuda(x, y, 0.1)
    with pytest.raises(ValueError):
        ls_xent_bwd_cuda(x, y, torch.zeros(4), torch.ones(4), 0.1)
    with pytest.raises(ValueError):
        lars_update_cuda([torch.ones(3)], [torch.ones(3)], [torch.ones(3)], [True],
                         **LARS_KW)
    q = torch.randn(1, 8, 2, 32)
    for fn in (flash_attention_cuda, flash_attention_tc, flash_attention_f32):
        with pytest.raises(ValueError):
            fn(q.to(torch.bfloat16) if fn is flash_attention_tc else q, q, q)
    h = torch.randn(2, 8, 3, 3).to(memory_format=torch.channels_last)
    mv, one = torch.zeros(2, 8), torch.ones(8)
    with pytest.raises(ValueError):
        bn_fwd_stats_cuda(h)
    with pytest.raises(ValueError):
        bn_fwd_apply_cuda(h, mv, one, one, eps=1e-5)
    with pytest.raises(ValueError):
        bn_bwd_sums_cuda(h, h, None, mv, one, one, eps=1e-5, mask=1)
    with pytest.raises(ValueError):
        bn_bwd_dx_cuda(h, h, None, mv, one, one, mv, eps=1e-5, count=18, mask=1)
    assert ops.launch_counts()["ls_xent_fwd"] == 0


def test_ctypes_signatures_match_the_c_sources():
    """Each function bound in build.SIGNATURES exists in csrc/ as extern "C"
    with the same number of parameters, and each extern "C" function there
    is bound (nvcc cannot check this here)."""
    src = "\n".join(p.read_text() for p in sorted(Path(build.CSRC).glob("*.cu")))
    for name, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    assert set(re.findall(r'extern "C" int (\w+)\(', src)) == set(build.SIGNATURES)


def test_library_is_built_into_the_checkouts_build_dir():
    path = build.library_path()
    repo = Path(__file__).resolve().parents[1]
    assert path.parent == repo / "build"
    assert path.name.startswith("repro_torch_kernels-") and path.suffix == ".so"
