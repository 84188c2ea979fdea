"""Plain PyTorch versions of every kernel in ``csrc/``.

CPU tensors go here (``kernels/ops.py``); on the card these are what each
kernel is held against. They repeat the kernels' arithmetic in fp32 and are
no yardstick of speed.
"""

from __future__ import annotations

import torch


def lars_trust(p: torch.Tensor, g: torch.Tensor, *, eta: float,
               weight_decay: float, eps: float) -> torch.Tensor:
    """eta*||p|| / (||g|| + wd*||p|| + eps), or 1 when either norm is 0.

    A 0-d fp32 tensor on ``p``'s device: the value never visits the host.
    """
    w_norm = torch.linalg.vector_norm(p.float())
    g_norm = torch.linalg.vector_norm(g.float())
    trust = eta * w_norm / (g_norm + weight_decay * w_norm + eps)
    return torch.where((w_norm > 0) & (g_norm > 0), trust,
                       torch.ones_like(trust))


def lars_update_ref(p, g, v, *, lr, mom, eta, weight_decay, eps,
                    nesterov: bool = False):
    """Fused LARS update, fp32 (``repro/kernels/ref.py::lars_update_ref``,
    plus the nesterov branch of ``core/lars.py::update``).

    trust = eta*||p|| / (||g|| + wd*||p|| + eps)  (1.0 when either norm is 0)
    v'    = mom*v + trust*lr*(g + wd*p)
    p'    = p - v'   (nesterov: p - (mom*v' + v' - mom*v))
    """
    trust = lars_trust(p, g, eta=eta, weight_decay=weight_decay, eps=eps)
    p, g, v = p.float(), g.float(), v.float()
    v_new = mom * v + (trust * lr) * (g + weight_decay * p)
    step = mom * v_new + (v_new - mom * v) if nesterov else v_new
    return p - step, v_new


def momentum_sgd_ref(p, g, v, *, lr, mom, nesterov: bool = False):
    """A skip leaf's update (``core/lars.py``: bias and BN): no trust ratio,
    no weight decay. v' = mom*v + lr*g; p' = p - v' (nesterov as above)."""
    p, g = p.float(), g.float()
    v_new = mom * v + lr * g
    step = mom * v_new + (v_new - mom * v) if nesterov else v_new
    return p - step, v_new


def lars_update_leaves_ref(ps, gs, vs, lars, *, lr, mom, eta, weight_decay, eps,
                           nesterov: bool = False):
    """The multi-tensor kernels' function: ``lars_update_ref`` on each leaf
    with ``lars[i]`` true, ``momentum_sgd_ref`` on the others."""
    out_p, out_v = [], []
    for p, g, v, is_lars in zip(ps, gs, vs, lars, strict=True):
        if is_lars:
            p_new, v_new = lars_update_ref(p, g, v, lr=lr, mom=mom, eta=eta,
                                           weight_decay=weight_decay, eps=eps,
                                           nesterov=nesterov)
        else:
            p_new, v_new = momentum_sgd_ref(p, g, v, lr=lr, mom=mom, nesterov=nesterov)
        out_p.append(p_new)
        out_v.append(v_new)
    return out_p, out_v


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Plain masked softmax attention (``repro/kernels/ref.py::flash_attention_ref``).

    q: (B, S, H, D); k/v: (B, Skv, Hkv, D), GQA by repeating each kv head
    for its H // Hkv query heads. fp32 math (fp64 for fp64 inputs: the
    exact answer the fp32 kernel is held to), output in q's dtype. Query i
    attends key j iff j < Skv, j <= i (causal) and j > i - window (window);
    positions count from 0 in both, as in the kernel.
    """
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    math = torch.float64 if q.dtype == torch.float64 else torch.float32
    k = k.repeat_interleave(group, dim=2).to(math)
    v = v.repeat_interleave(group, dim=2).to(math)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(math) * scale, k)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).to(q.dtype)


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
