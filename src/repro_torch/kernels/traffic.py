"""The bytes a kernel moves, for a run that counts them.

On the host a kernel's plain version (``kernels/ref.py``) runs in its
place and moves far more than the kernel: the plain attention writes and
reads (B, H, S, S) scores, the plain loss several (R, V) passes. A run
that counts the bytes of its ops (the dry run's ``launch/hlo_stats.py``
``Recorder``, a dispatch mode with a ``kernel(name)`` context) counts such
a call as the card's kernel moves it: each input read once, each output
written once, and nothing for the ops of the plain version. Without such
a mode entered these helpers change nothing.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import _disable_current_modes, _get_current_dispatch_mode_stack


def _counter():
    """The innermost entered dispatch mode that counts bytes by kernel, or None."""
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if hasattr(m, "kernel")), None)


@contextlib.contextmanager
def as_kernel(name: str):
    """Run the block as the kernel ``name``: yields a function to give it
    the tensors (or byte counts) that the kernel reads and writes."""
    counter = _counter()
    if counter is None:
        yield lambda *ts: None
        return
    with counter.kernel(name) as io:
        yield io


class _Attention(torch.autograd.Function):
    """The plain attention counted as the flash kernels: the forward kernel
    reads q, k, v and writes o (and, under autograd, each row's fp32 lse);
    the backward kernel reads q, k, v, o, dO and lse and writes dq, dk,
    dv. The backward recomputes the plain forward out of the counter's
    sight (its FLOPs were counted once, in the forward) and differentiates
    it, so the FLOPs are those of autograd over the plain attention."""

    @staticmethod
    def forward(ctx, counter, fn, q, k, v):
        with counter.kernel("flash_attn") as io:
            o = fn(q, k, v)
            lse = q.shape[0] * q.shape[2] * q.shape[1] * 4 if any(ctx.needs_input_grad) else 0
            io(q, k, v, o, lse)
        ctx.save_for_backward(q, k, v, o)
        ctx.counter, ctx.fn, ctx.lse = counter, fn, lse
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with _disable_current_modes(), torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ctx.fn(*xs)
        with ctx.counter.kernel("flash_attn_bwd") as io:
            grads = torch.autograd.grad(out, xs, do)
            io(q, k, v, o, do, ctx.lse, *grads)
        return (None, None, *grads)


def attention(fn):
    """``fn(q, k, v)``, a plain attention, as the flash kernels are counted
    (``_Attention``) when a counting mode is entered; else ``fn``."""
    counter = _counter()
    if counter is None:
        return fn
    return lambda q, k, v: _Attention.apply(counter, fn, q, k, v)
