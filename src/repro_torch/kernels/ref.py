"""Plain PyTorch versions of every kernel in ``csrc/``.

CPU tensors go here (``kernels/ops.py``); on the card these are what each
kernel is held against. They repeat the kernels' arithmetic in fp32 and are
no yardstick of speed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def lars_trust(p, g, *, eta: float, weight_decay: float, eps: float) -> torch.Tensor:
    """eta*||p|| / (||g|| + wd*||p|| + eps), or 1 when either norm is 0.

    ``p`` and ``g`` are tensors, or lists of the tensors of one LARS group,
    whose norms are the norms over all of them (the norm of the leaves'
    norms; one leaf's is its own norm, bit for bit). A 0-d fp32 tensor on
    the leaves' device: the value never visits the host.
    """
    ps, gs = (p, g) if isinstance(p, (list, tuple)) else ([p], [g])
    w_norm = _group_norm(ps)
    g_norm = _group_norm(gs)
    trust = eta * w_norm / (g_norm + weight_decay * w_norm + eps)
    return torch.where((w_norm > 0) & (g_norm > 0), trust,
                       torch.ones_like(trust))


def _group_norm(ts) -> torch.Tensor:
    norms = [torch.linalg.vector_norm(t.float()) for t in ts]
    return norms[0] if len(norms) == 1 else torch.linalg.vector_norm(torch.stack(norms))


def _lars_step(p, g, v, trust, *, lr, mom, weight_decay, nesterov):
    p, g, v = p.float(), g.float(), v.float()
    v_new = mom * v + (trust * lr) * (g + weight_decay * p)
    step = mom * v_new + (v_new - mom * v) if nesterov else v_new
    return p - step, v_new


def lars_update_ref(p, g, v, *, lr, mom, eta, weight_decay, eps,
                    nesterov: bool = False):
    """Fused LARS update, fp32 (``repro/kernels/ref.py::lars_update_ref``,
    plus the nesterov branch of ``core/lars.py::update``).

    trust = eta*||p|| / (||g|| + wd*||p|| + eps)  (1.0 when either norm is 0)
    v'    = mom*v + trust*lr*(g + wd*p)
    p'    = p - v'   (nesterov: p - (mom*v' + v' - mom*v))
    """
    trust = lars_trust(p, g, eta=eta, weight_decay=weight_decay, eps=eps)
    return _lars_step(p, g, v, trust, lr=lr, mom=mom, weight_decay=weight_decay,
                      nesterov=nesterov)


def momentum_sgd_ref(p, g, v, *, lr, mom, nesterov: bool = False):
    """A skip leaf's update (``core/lars.py``: bias and BN): no trust ratio,
    no weight decay. v' = mom*v + lr*g; p' = p - v' (nesterov as above)."""
    p, g = p.float(), g.float()
    v_new = mom * v + lr * g
    step = mom * v_new + (v_new - mom * v) if nesterov else v_new
    return p - step, v_new


def lars_update_leaves_ref(ps, gs, vs, lars, *, lr, mom, eta, weight_decay, eps,
                           nesterov: bool = False, groups=None):
    """The multi-tensor kernels' function: ``lars_update_ref`` on each leaf
    with ``lars[i]`` true, ``momentum_sgd_ref`` on the others. ``groups``
    counts the consecutive leaves that share one trust ratio, from the
    norms over all of them (None: one a leaf)."""
    if len({len(ps), len(gs), len(vs), len(lars)}) != 1:
        raise ValueError("lars_update_leaves_ref: ps, gs, vs and lars differ in length")
    out_p, out_v, leaf = [], [], 0
    for size in groups if groups is not None else [1] * len(ps):
        sl = slice(leaf, leaf + size)
        trust = (lars_trust(ps[sl], gs[sl], eta=eta, weight_decay=weight_decay, eps=eps)
                 if lars[leaf] else None)
        for p, g, v in zip(ps[sl], gs[sl], vs[sl]):
            if trust is None:
                p_new, v_new = momentum_sgd_ref(p, g, v, lr=lr, mom=mom, nesterov=nesterov)
            else:
                p_new, v_new = _lars_step(p, g, v, trust, lr=lr, mom=mom,
                                          weight_decay=weight_decay, nesterov=nesterov)
            out_p.append(p_new)
            out_v.append(v_new)
        leaf += size
    return out_p, out_v


def guard_unscale_count_ref(grads, scale):
    """The guard's first pass (``csrc/guard.cu``): each gradient times
    1 / ``scale`` (None: left as it is) and the int64 count of non-finite
    elements over all of them; returns ``(grads, count)``, new tensors."""
    if scale is not None:
        inv = 1.0 / scale   # exact for the power-of-two scales we use
        grads = [g * inv.to(g.dtype) for g in grads]
    return grads, torch.stack([(~torch.isfinite(g)).sum() for g in grads]).sum()


def guard_commit_ref(finite, old_p, new_p, old_v, new_v):
    """The guard's select (``csrc/guard.cu``): LARS's ``new_p``, ``new_v``
    where ``finite``, else the old leaves; returns ``(new_p, new_v)``, new
    tensors (``torch.where`` selects bit-exactly)."""
    return ([torch.where(finite, p, o) for p, o in zip(new_p, old_p)],
            [torch.where(finite, v, o) for v, o in zip(new_v, old_v)])


def ls_xent_fwd_ref(logits: torch.Tensor, labels: torch.Tensor,
                    smoothing: float):
    """The forward kernel's outputs: per-row (loss, lse), fp32.

    loss = (1-a)*(lse - x_y) - a*(mean(x) - lse): the smoothed NLL; NaN in
    a row whose label lies outside [0, V), as the kernel gives.
    """
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    bad = _bad_labels(labels, x.shape[-1])
    safe = torch.where(bad, torch.zeros_like(labels), labels).long()
    x_y = torch.gather(x, -1, safe.unsqueeze(-1)).squeeze(-1)
    loss = (1.0 - smoothing) * (lse - x_y) - smoothing * (x.mean(dim=-1) - lse)
    return torch.where(bad, float("nan"), loss), lse


def _bad_labels(labels: torch.Tensor, vocab: int) -> torch.Tensor:
    return (labels < 0) | (labels >= vocab)


def ls_xent_ref(logits: torch.Tensor, labels: torch.Tensor,
                smoothing: float) -> torch.Tensor:
    """Per-row label-smoothed NLL, fp32 (``repro/kernels/ref.py::ls_xent_ref``)."""
    return ls_xent_fwd_ref(logits, labels, smoothing)[0]


def ls_xent_bwd_ref(logits: torch.Tensor, labels: torch.Tensor,
                    lse: torch.Tensor, gout: torch.Tensor,
                    smoothing: float) -> torch.Tensor:
    """dlogits = gout * (softmax - (1-a)*onehot(y) - a/V), in logits' dtype;
    NaN over a row whose label lies outside [0, V), whatever its gout, as
    the kernel gives."""
    x = logits.float()
    vocab = x.shape[-1]
    p = torch.exp(x - lse.unsqueeze(-1))
    cols = torch.arange(vocab, device=x.device)
    hit = (cols == labels.long().unsqueeze(-1)).to(x.dtype)
    go = torch.where(_bad_labels(labels, vocab), float("nan"), gout.float())
    d = go.unsqueeze(-1) * (p - smoothing / vocab - (1.0 - smoothing) * hit)
    return d.to(logits.dtype)


def ls_xent_bwd_tol(want: torch.Tensor, gout: torch.Tensor,
                    smoothing: float) -> torch.Tensor:
    """Elementwise bound on |kernel - ls_xent_bwd_ref(...)|, where ``want``
    is ``ls_xent_bwd_ref``'s (R, V) output and ``gout`` its (R,) row grads.

    rtol |want|: fp32 1e-5 (the same math, the lse and exponentials rounded
    differently), bf16 2^-7 (each side rounds its fp32 gradient once). The
    atol is 1e-6, or less: 2^-10 |gout_r| a/V in row r. Most of a long row's
    gradients are about -gout_r a/V (softmax far under a/V), and that is
    under 1e-6 at Qwen3-1.7B's vocab, so a fixed 1e-6 would pass a kernel
    that wrote them as 0; a kernel's own error there is some 2^-18 of
    gout_r a/V.
    """
    rtol = 1e-5 if want.dtype == torch.float32 else 2.0 ** -7
    want = want.float()
    vocab = want.shape[-1]
    atol = (2.0 ** -10 * smoothing / vocab) * gout.float().abs().unsqueeze(-1)
    return atol.clamp(max=1e-6) + rtol * want.abs()


NEG_INF = -1e30   # the masked logit of repro/kernels/{ref,flash_attn}.py


def _flash_logits(q, k, *, causal, window, softcap, scale):
    """(masked logits t (B, H, S, Skv), softcap's tanh or None, mask, math
    dtype) of the plain versions: fp32 math (fp64 for fp64 inputs), GQA by
    repeating each kv head for its H // Hkv query heads."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    math = torch.float64 if q.dtype == torch.float64 else torch.float32
    k = k.repeat_interleave(H // Hkv, dim=2).to(math)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(math) * scale, k)
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = softcap * th
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return torch.where(mask, s, NEG_INF), th, mask, math


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None, return_lse: bool = False):
    """Plain masked softmax attention (``repro/kernels/ref.py::flash_attention_ref``).

    q: (B, S, H, D); k/v: (B, Skv, Hkv, D), GQA by repeating each kv head
    for its H // Hkv query heads. fp32 math (fp64 for fp64 inputs: the
    exact answer the fp32 kernel is held to), output in q's dtype. Query i
    attends key j iff j < Skv, j <= i (causal) and j > i - window (window);
    positions count from 0 in both, as in the kernel. ``return_lse``: also
    each row's logsumexp of the masked logits, (B, H, S) in the math dtype,
    what the forward kernels write for the backward.
    """
    s, _, _, math = _flash_logits(q, k, causal=causal, window=window, softcap=softcap,
                                  scale=scale)
    w = torch.softmax(s, dim=-1)
    v = v.repeat_interleave(q.shape[2] // k.shape[2], dim=2).to(math)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def flash_attention_bwd_ref(q, k, v, o, lse, dout, *, causal: bool = True,
                            window: int | None = None, softcap: float | None = None,
                            scale: float | None = None):
    """The backward kernels' function (``csrc/flash_attn_bwd.cu``,
    ``csrc/flash_attn_bwd_f32.cu``): (dq, dk,
    dv) of ``flash_attention_ref`` from q, k, v, its output ``o``, the
    output's gradient ``dout`` and the rows' logsumexp ``lse`` (B, H, S),
    by FA-2's formulas, not autograd:

        P  = exp(t - lse) on the kept pairs,   D = rowsum(dout * o)
        dS = P * (dout . v^T - D) * (1 - tanh^2(s / softcap))
        dq = scale dS . k,  dk = scale dS^T . q,  dv = P^T . dout

    GQA sums each kv head's gradient over its query heads. fp32 math (fp64
    for fp64 inputs, the exact answer), outputs in the inputs' dtype.
    """
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    t, th, mask, math = _flash_logits(q, k, causal=causal, window=window,
                                      softcap=softcap, scale=scale)
    p = torch.where(mask, torch.exp(t - lse.to(math)[..., None]), 0.0)
    rep = H // Hkv
    do = dout.to(math)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.repeat_interleave(rep, dim=2).to(math))
    delta = torch.einsum("bqhd,bqhd->bhq", do, o.to(math))
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1 - th * th)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds,
                              k.repeat_interleave(rep, dim=2).to(math))
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.to(math))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    Skv = k.shape[1]
    dk = dk.reshape(B, Skv, Hkv, rep, D).sum(3)
    dv = dv.reshape(B, Skv, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_tol(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        want: torch.Tensor, **kw) -> torch.Tensor:
    """Elementwise bound on |kernel - flash_attention_ref(q, k, v, **kw)|.

    fp32: 1e-5 + 1e-5 |want|, with ``want`` the exact answer
    (``flash_attention_ref`` of the inputs in fp64): an fp32 reference sums
    in its own order and, where the logits are large (|s| ~ 10-50), lies up
    to 3.4x this bound from the exact answer itself.
    bf16: 1e-5 + 2^-7 |want| + 2^-8 (P . |v|): the output's own rounding,
    plus one bf16 rounding of each probability before P . V, as every
    tensor-core flash kernel does (P . |v|: ``flash_attention_ref`` on |v|).
    """
    want = want.float()
    if q.dtype == torch.float32:
        return 1e-5 + 1e-5 * want.abs()
    p_abs_v = flash_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    return 1e-5 + 2.0 ** -7 * want.abs() + 2.0 ** -8 * p_abs_v


def flash_attention_bwd_tol(q, k, v, o, lse, dout, want, *, causal: bool = True,
                            window: int | None = None, softcap: float | None = None,
                            scale: float | None = None):
    """Bounds on (dq, dk, dv) of |kernel - want|, where ``want`` is
    ``flash_attention_bwd_ref``'s (dq, dk, dv) from the same inputs: in fp64
    for fp32 inputs (the exact answer x), in fp32 for bf16 ones. Returns
    (elementwise bounds, normwise limits): three tensors shaped like the
    outputs, and three floats that ``||kernel - want||_F`` must stay under.

    Per kept pair (i, j) of a query head: A = scale |q_i|.|k_j|, the row's
    d = dO_i.v_j - D_i, dS = P d f (f = 1 - tanh^2(s/c), 1 without a softcap),
    and u = 2^-24. Both the fp32 kernel and the plain version compute in fp32
    and keep P and dS in fp32 (the bf16 kernel differs: below):
    - s is a sum of D products, off by gamma_D A; tanh has a slope of at most
      1 and exp adds u |t - lse| and a few ulps, so P is off by gamma_(D+8)
      P w, w = 8 + A (1 + 2/c) + |t - lse| (2/c: the error of f itself);
    - dO_i.v_j and D_i are sums of D products, off by gamma_D times
      B = |dO_i|.|v_j| + |dO_i|.|o_i|; so dS is off by gamma_(D+8) W,
      W = P (|d| w + B);
    - dq_i sums n = Skv terms scale dS_ij k_j, dk_j and dv_j n = S * H/Hkv
      terms: gamma_n of the sum of the terms' magnitudes,
      M_d = scale |dS|.|k| (dq), scale |dS|^T.|q| (dk), P^T.|dO| (dv).
    With M_w as M_d with W for |dS| (dq, dk) and P w for P (dv), an fp32
    result lies within (D + 8) u M_w + (n + 2) u M_d of x before its own
    rounding; each bound carries 1% more for the second-order terms.
    fp32 kernel against x: 1e-9 + u |x| + (D + 8) u M_w + (n + 2) u M_d.

    The bf16 kernel rounds P and dS to bf16 before their products on the
    tensor cores, each by at most 2^-8 of itself (dS from the fp32 P, so dS
    carries one rounding): 2^-8 M_d. Its products add the tensor cores'
    k-steps, which truncate each addend below the largest's last bit
    (measured on the H100 for the forward's wgmma: at most 17 2^-23 of a
    step's magnitudes, ~2.2 n u M over n / 16 steps), and it is compared
    with the fp32 plain version, which errs as above, both outputs rounded
    to bf16: 1e-9 + 2^-7 |x| + 2^-8 M_d + 4 (D + 8) u M_w + 4 (n + 2) u M_d.

    Normwise. The bf16 roundings of dS (or P) and of the two outputs are
    independent and unbiased, each uniform within 2^-8 of its value, so of
    variance at most 2^-16/3 of its square: the rounding part of the error
    has an rms of at most 2^-8/sqrt(3) (sqrt(R) + 2 ||x||), R =
    scale^2 sum dS^2 |k_j|^2 (dq), scale^2 sum dS^2 |q_i|^2 (dk), sum P^2
    |dO_i|^2 (dv). Over the 10^4 or more entries of an output its norm stays
    near that rms; the limit is sqrt(3) times it, with the sums' worst case
    added in full: 1e-9 sqrt(N) + 2^-8 (sqrt(R) + 2 ||x||) + ||4 (D + 8) u
    M_w + 4 (n + 2) u M_d||_F. fp32: 1e-9 sqrt(N) + u ||x|| + ||(D + 8) u M_w
    + (n + 2) u M_d||_F, which the elementwise bound implies. A kernel that
    is off by a few percent of an output's norm fails it.
    """
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    qa, ka, oa, da = (t.float().abs() for t in (q, k, o, dout))
    ka_r = ka.repeat_interleave(rep, dim=2)
    vf_r = v.float().repeat_interleave(rep, dim=2)
    t, th, mask, _ = _flash_logits(q.float(), k.float(), causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    t = t - lse.float()[..., None]
    p = torch.where(mask, torch.exp(t), 0.0)
    # w = 8 + A (1 + 2/c) + |t - lse| on the kept pairs
    w = torch.where(mask, t.abs_(), 0.0)
    del t
    a_cap = 1 + (2 / softcap if softcap else 0.0)
    w += scale * a_cap * torch.einsum("bqhd,bkhd->bhqk", qa, ka_r)
    w += 8
    do = dout.float()
    d = (torch.einsum("bqhd,bkhd->bhqk", do, vf_r)
         - torch.einsum("bqhd,bqhd->bhq", do, o.float())[..., None])
    ds = p * d
    if th is not None:
        ds *= 1 - th * th
    del th
    b_mag = (torch.einsum("bqhd,bkhd->bhqk", da, vf_r.abs())
             + torch.einsum("bqhd,bqhd->bhq", da, oa)[..., None])
    wd = p * (d.abs_() * w + b_mag)           # W, the error weight of dS
    del d, b_mag
    w *= p                                    # P w, the error weight of P

    def per_kv(x):   # sum a kv head's query heads: (B, Skv, H, D) -> (B, Skv, Hkv, D)
        return x.reshape(B, Skv, Hkv, rep, D).sum(3)

    dsa = ds.abs()
    m_d = (scale * torch.einsum("bhqk,bkhd->bqhd", dsa, ka_r),
           scale * per_kv(torch.einsum("bhqk,bqhd->bkhd", dsa, qa)),
           per_kv(torch.einsum("bhqk,bqhd->bkhd", p, da)))
    m_w = (scale * torch.einsum("bhqk,bkhd->bqhd", wd, ka_r),
           scale * per_kv(torch.einsum("bhqk,bqhd->bkhd", wd, qa)),
           per_kv(torch.einsum("bhqk,bqhd->bkhd", w, da)))
    del dsa, wd, w
    ds2 = ds.square_()
    r = ((scale ** 2 * torch.einsum("bhqk,bkh->", ds2, ka_r.square().sum(-1))).item(),
         (scale ** 2 * torch.einsum("bhqk,bqh->", ds2, qa.square().sum(-1))).item(),
         torch.einsum("bhqk,bqh->", p.square(), da.square().sum(-1)).item())
    del ds2, p
    u = 2.0 ** -24
    bf16 = q.dtype != torch.float32
    c = 4 if bf16 else 1
    bounds, limits = [], []
    for x, md, mw, n, rk in zip(want, m_d, m_w, (Skv, S * rep, S * rep), r):
        x = x.float()
        sums = 1.01 * (c * (D + 8) * u * mw + c * (n + 2) * u * md)
        if bf16:
            bounds.append(1e-9 + 2.0 ** -7 * x.abs() + 1.01 * 2.0 ** -8 * md + sums)
            rounding = 2.0 ** -8 * (rk ** 0.5 + 2 * x.norm().item())
        else:
            bounds.append(1e-9 + u * x.abs() + sums)
            rounding = u * x.norm().item()
        limits.append(1e-9 * x.numel() ** 0.5 + rounding + sums.norm().item())
    return tuple(bounds), tuple(limits)


def flash_attention_bwd_errors(got, want, q, k, v, o, lse, dout, **kw) -> list[dict]:
    """A backward kernel's (dq, dk, dv) ``got`` against ``want`` (see
    ``flash_attention_bwd_tol``): for each output its max abs error, its
    worst elementwise err/tol, and its norm err/limit. Each ratio must stay
    at 1 or under."""
    bounds, limits = flash_attention_bwd_tol(q, k, v, o, lse, dout, want, **kw)
    out = []
    for name, a, w, b, lim in zip(("dq", "dk", "dv"), got, want, bounds, limits):
        err = a.double() - w.double()
        out.append({"out": name, "max_abs_err": err.abs().max().item(),
                    "err_over_tol": (err.abs() / b).max().item(),
                    "norm_over_limit": err.norm().item() / lim})
    return out


# -- batch norm (csrc/batchnorm.cu) ------------------------------------------------
# Channel dim 1, every other dim a row; statistics are (2, C) fp32 tensors
# ``mv`` = (mean, var) and ``sums`` = two per-channel sums. ``mask``: 0 no
# ReLU, 1 the ReLU's mask recomputed from x, 2 read from the stored output.


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[1] = -1
    return v.reshape(shape)


def _rows_of(x: torch.Tensor) -> list[int]:
    return [d for d in range(x.dim()) if d != 1]


def bn_stats_ref(x: torch.Tensor) -> torch.Tensor:
    """The forward stats kernel's sums: (Σx, Σx²) over the rows, fp32."""
    xf = x.float()
    return torch.stack([xf.sum(_rows_of(x)), (xf * xf).sum(_rows_of(x))])


@functools.lru_cache(maxsize=None)
def inv_count(count: int) -> float:
    """1/count rounded once to fp32: what the kernels multiply a sum by to
    take its mean (so that the plain versions multiply by the same number)."""
    return float(np.float32(1.0) / np.float32(count))


def bn_moments_ref(sums: torch.Tensor, count: int) -> torch.Tensor:
    """mv = (mean, var) from (Σx, Σx²) over ``count`` rows: E[x²] - mean²."""
    inv = inv_count(count)
    mean = sums[0] * inv
    return torch.stack([mean, sums[1] * inv - mean * mean])


def _in(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A parameter rounded to x's dtype, in fp32: what the kernels load."""
    return p.to(x.dtype).float()


def _bn_affine(x, mv, scale, eps: float):
    """(mean, a = rsqrt(var + eps), a * s), fp32, s rounded to x's dtype."""
    rs = torch.rsqrt(mv[1] + eps)
    return mv[0], rs, rs * _in(scale, x)


def _bn_value(x, mv, scale, bias, eps: float) -> torch.Tensor:
    """T((x - mean) * (a * s) + b), rounded to x's dtype T."""
    mean, _, inv = _bn_affine(x, mv, scale, eps)
    return ((x.float() - _per_channel(mean, x)) * _per_channel(inv, x)
            + _per_channel(_in(bias, x), x)).to(x.dtype)


def bn_apply_ref(x, mv, scale, bias, *, eps: float, residual=None,
                 relu: bool = False) -> torch.Tensor:
    """The apply kernel: the BN's value rounded to x's dtype; with a
    residual, that plus the residual in fp32, rounded again; the ReLU last
    (``y <= 0`` gives 0, NaN passes)."""
    y = _bn_value(x, mv, scale, bias, eps)
    if residual is not None:
        y = (y.float() + residual.float()).to(x.dtype)
    return torch.where(y <= 0, torch.zeros_like(y), y) if relu else y


def bn_grad_in_ref(x, dy, y, mv, scale, bias, *, eps: float, mask: int) -> torch.Tensor:
    """dy where the ReLU passed it (threshold_backward's: an output <= 0
    gives 0), from the value recomputed from x (mask 1) or the stored
    output y (mask 2); dy itself without a ReLU (mask 0)."""
    if mask == 0:
        return dy
    v = _bn_value(x, mv, scale, bias, eps) if mask == 1 else y
    return torch.where(v <= 0, torch.zeros_like(dy), dy)


def bn_bwd_sums_ref(x, dy, y, mv, scale, bias, *, eps: float, mask: int) -> torch.Tensor:
    """The backward sums kernel: (Σg, Σg·x̂), fp32, x̂ = (x - mean) a."""
    g = bn_grad_in_ref(x, dy, y, mv, scale, bias, eps=eps, mask=mask).float()
    mean, rs, _ = _bn_affine(x, mv, scale, eps)
    xh = (x.float() - _per_channel(mean, x)) * _per_channel(rs, x)
    return torch.stack([g.sum(_rows_of(x)), (g * xh).sum(_rows_of(x))])


def bn_bwd_dx_ref(x, dy, y, mv, scale, bias, sums, *, eps: float, count: int,
                  mask: int, want_dres: bool = False):
    """The dx kernel: (dx, g or None), in x's dtype.

    dx = s a ((g - Σg/M') - x̂ Σg·x̂/M') with ``sums`` over every rank's
    ``count`` rows; with ``sums`` None (given statistics) s a g alone. g is
    the residual's gradient where ``want_dres``.
    """
    g = bn_grad_in_ref(x, dy, y, mv, scale, bias, eps=eps, mask=mask)
    mean, rs, _ = _bn_affine(x, mv, scale, eps)
    sa = _per_channel(_in(scale, x) * rs, x)
    gf = g.float()
    if sums is None:
        dx = sa * gf
    else:
        xh = (x.float() - _per_channel(mean, x)) * _per_channel(rs, x)
        inv = inv_count(count)
        dx = sa * ((gf - _per_channel(sums[0] * inv, x))
                   - xh * _per_channel(sums[1] * inv, x))
    return dx.to(x.dtype), (g if want_dres else None)


def batchnorm_chain_ref(x, scale, bias, *, stats=None, eps: float = 1e-5,
                        residual=None, relu: bool = False):
    """The BN as the port wrote it before its kernels, one rank, for the
    tests to differentiate with autograd: fp32 moments by ``mean``, the
    variance as E[x²] - mean², the affine in fp32 with the scale and bias as
    given, the value rounded to x's dtype; then ``F.relu(y + residual)`` or
    ``F.relu(y)`` as the model wrote them. Returns (y, (mean, var))."""
    xf = x.float()
    if stats is not None:
        mean, var = stats
    else:
        mean = xf.mean(_rows_of(x))
        var = (xf * xf).mean(_rows_of(x)) - mean * mean
    inv = torch.rsqrt(var + eps) * scale.float()
    y = ((xf - _per_channel(mean, x)) * _per_channel(inv, x)
         + _per_channel(bias.float(), x)).to(x.dtype)
    if residual is not None:
        y = y + residual
    return (torch.relu(y) if relu else y), (mean, var)
