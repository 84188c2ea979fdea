"""Check and time ResNet-50's batch norm kernels on one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_bn [--batch 256] [--out FILE]

``calls(cfg, batch)`` lists every BN of the model in the order it runs,
with its input's shape and its epilogue (the ReLU; the residual add and
the ReLU at ``bn3``): 53 at ResNet-50, 16 distinct. At each distinct shape,
``check`` holds the four kernels (``csrc/batchnorm.cu``) against their
plain versions (``kernels/ref.py``) run on the card from the kernels' own
statistics: the two sums within 2^-14 of the sum of the terms' magnitudes
(two fp32 sums of the same terms in other orders: each is within ~n u of
it for its longest chain of n additions, ~250 at the stem, 1.5e-5; a
dropped chunk moves Σx² by 1/1046 of itself), and every other output
equal bit for bit (the same fp32 operations, uncontracted); then calls
all four twice, which must give the same bytes. ``time_call`` times the
kernels forward (stats + apply) and backward (sums + dx) beside their
bound (the two-pass bytes of ``call_bytes`` / 3.35 TB/s), the plain
versions, the port's earlier autograd chain (``ref.batchnorm_chain_ref``)
and ``F.batch_norm`` (cuDNN) with the same epilogue in PyTorch, the
library's yardstick that the port never calls; each rotates over enough
copies of its inputs to pass the 50 MB L2, so a launch finds them in
device memory, as the step does for all but the last ~50 MB a conv
wrote. Device time from CUDA-graph replay (``launch/timing.py``).
``host_us`` times the host's part of a call (wrappers, autograd) beside
the chain's. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import batchnorm as K
from repro_torch.kernels import ref
from repro_torch.launch.profile_step import gpu_line
from repro_torch.launch.timing import HBM_BYTES_PER_S, graph_ms
from repro_torch.models import resnet

EPS = 1e-5
L2_BYTES = 50 * 2**20
SUM_TOL = 2.0 ** -14   # of the terms' magnitudes: see the module's docstring


@dataclasses.dataclass(frozen=True)
class Call:
    name: str                          # the module, e.g. "stages.1.0.bn1"
    shape: tuple[int, int, int, int]   # its input, (N, C, H, W)
    relu: bool
    residual: bool


def calls(cfg: resnet.ResNetConfig, batch: int) -> list[Call]:
    """Every BN of ``models/resnet.py`` at ``batch`` images, in the order
    the model runs them (the projection's before ``bn3``, which adds it)."""
    size = -(-cfg.image_size // 2)                    # the stem's conv
    out = [Call("stem.bn", (batch, cfg.width, size, size), True, False)]
    size = -(-size // 2)                              # max pool
    cin = cfg.width
    for s, nblocks in enumerate(cfg.stage_sizes):
        inner, cout = cfg.width * 2 ** s, cfg.width * 2 ** s * 4
        for b in range(nblocks):
            at = f"stages.{s}.{b}."
            stride = 2 if (s > 0 and b == 0) else 1
            out.append(Call(at + "bn1", (batch, inner, size, size), True, False))
            size = -(-size // stride)                 # conv2 (v1.5), the projection
            out.append(Call(at + "bn2", (batch, inner, size, size), True, False))
            if cin != cout:
                out.append(Call(at + "bn_proj", (batch, cout, size, size), False, False))
            out.append(Call(at + "bn3", (batch, cout, size, size), True, True))
            cin = cout
    return out


def distinct(cs: list[Call]) -> list[tuple[Call, int]]:
    """(first call, count) of each distinct (shape, epilogue), in run order."""
    n = Counter((c.shape, c.relu, c.residual) for c in cs)
    seen, out = set(), []
    for c in cs:
        key = (c.shape, c.relu, c.residual)
        if key not in seen:
            seen.add(key)
            out.append((c, n[key]))
    return out


def call_bytes(c: Call, esize: int) -> tuple[int, int]:
    """(forward, backward) device-memory bytes of the two-pass kernels: x
    read twice and y written forward, the residual read; x and dy read twice
    and dx written backward, and at ``bn3`` y read twice and the residual's
    gradient written."""
    n = math.prod(c.shape) * esize
    reads_y = c.relu and c.residual
    return n * (3 + c.residual), n * (5 + 3 * reads_y)


def _mask(c: Call) -> int:
    return 0 if not c.relu else (2 if c.residual else 1)


def inputs(c: Call, dtype: torch.dtype, gen: torch.Generator):
    """(x, scale, bias, residual or None, dy) on gen's device: activations
    channels-last in ``dtype``, scale and bias fp32 (the masters)."""
    n, ch, h, w = c.shape
    dev = gen.device

    def act(mag, shift=0.0):
        t = mag * torch.randn(n, h, w, ch, generator=gen, device=dev) + shift
        return t.to(dtype).permute(0, 3, 1, 2)

    scale = 0.5 + torch.rand(ch, generator=gen, device=dev)
    bias = 0.5 * torch.randn(ch, generator=gen, device=dev)
    return act(2.0, 0.5), scale, bias, act(1.0) if c.residual else None, act(1.0)


def check(c: Call, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """The kernels against their plain versions at one call's shape: the two
    sums' worst err/tol (at most 1) and which outputs equal the plain
    version's bit for bit (all of them), and whether a second call repeats
    every output's bytes."""
    x, scale, bias, res, dy = inputs(c, dtype, gen)
    rows = x.numel() // x.shape[1]
    mask = _mask(c)

    def run():
        sums, mv = K.bn_fwd_stats_cuda(x)
        y = K.bn_fwd_apply_cuda(x, mv, scale, bias, eps=EPS, residual=res, relu=c.relu)
        yb = y if mask == 2 else None
        bs, dp = K.bn_bwd_sums_cuda(x, dy, yb, mv, scale, bias, eps=EPS, mask=mask)
        dx, dres = K.bn_bwd_dx_cuda(x, dy, yb, mv, scale, bias, bs, eps=EPS, count=rows,
                                    mask=mask, want_dres=mask == 2)
        dx_eval, _ = K.bn_bwd_dx_cuda(x, dy, yb, mv, scale, bias, None, eps=EPS,
                                      count=rows, mask=mask)
        return sums, mv, y, bs, dp, dx, dres, dx_eval

    got = run()
    sums, mv, y, bs, dp, dx, dres, dx_eval = got
    yb = y if mask == 2 else None
    xf = x.float()
    axes = [0, 2, 3]
    mag_x = torch.stack([xf.abs().sum(axes), (xf * xf).sum(axes)])
    mean, rs = mv[0].view(1, -1, 1, 1), torch.rsqrt(mv[1] + EPS).view(1, -1, 1, 1)
    g = ref.bn_grad_in_ref(x, dy, yb, mv, scale, bias, eps=EPS, mask=mask).float()
    mag_g = torch.stack([g.abs().sum(axes), (g * ((xf - mean) * rs)).abs().sum(axes)])
    want_dx, want_dres = ref.bn_bwd_dx_ref(x, dy, yb, mv, scale, bias, bs, eps=EPS,
                                           count=rows, mask=mask, want_dres=mask == 2)
    bitwise = {
        "mv": torch.equal(mv, ref.bn_moments_ref(sums, rows)),
        "y": torch.equal(y, ref.bn_apply_ref(x, mv, scale, bias, eps=EPS, residual=res,
                                             relu=c.relu)),
        "dparams": torch.equal(dp, bs.to(dtype).float()),
        "dx": torch.equal(dx, want_dx),
        "dx_eval": torch.equal(dx_eval, ref.bn_bwd_dx_ref(
            x, dy, yb, mv, scale, bias, None, eps=EPS, count=rows, mask=mask)[0]),
    }
    if mask == 2:
        bitwise["dres"] = torch.equal(dres, want_dres)
    again = run()
    err_x = (sums - ref.bn_stats_ref(x)).abs()
    err_g = (bs - ref.bn_bwd_sums_ref(x, dy, yb, mv, scale, bias, eps=EPS, mask=mask)).abs()
    out = {
        "call": c.name, "shape": list(c.shape), "dtype": str(dtype)[6:], "mask": mask,
        "stats_err_over_tol": (err_x / (SUM_TOL * mag_x)).max().item(),
        "bwd_sums_err_over_tol": (err_g / (SUM_TOL * mag_g).clamp_min(1e-30)).max().item(),
        "sums_max_abs_err": max(err_x.max().item(), err_g.max().item()),
        "bitwise": bitwise,
        "repeats": all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
    }
    out["ok"] = (out["stats_err_over_tol"] <= 1 and out["bwd_sums_err_over_tol"] <= 1
                 and all(bitwise.values()) and out["repeats"])
    return out


def _rotating(make, nbytes: int):
    """A function that returns the next of enough copies of ``make()`` to
    pass twice the L2 (at most 8), one a call."""
    copies = [make() for _ in range(min(8, max(1, -(-2 * L2_BYTES // nbytes))))]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return nxt, len(copies)


def time_call(c: Call, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """ms of one call forward and backward: the kernels, the plain versions,
    the earlier autograd chain and cuDNN's ``F.batch_norm`` with the same
    epilogue; the two-pass bytes and their bound."""
    esize = torch.tensor([], dtype=dtype).element_size()
    fwd_b, bwd_b = call_bytes(c, esize)
    mask = _mask(c)
    rows = math.prod(c.shape) // c.shape[1]
    nxt, n = _rotating(lambda: inputs(c, dtype, gen), math.prod(c.shape) * esize)
    kw = dict(iters=max(n, 4), replays=3)
    # what the backward reads: each copy's forward outputs, made once
    fwd_out = {}
    for _ in range(n):
        x, scale, bias, res, dy = cur = nxt()
        sums, mv = K.bn_fwd_stats_cuda(x)
        y = K.bn_fwd_apply_cuda(x, mv, scale, bias, eps=EPS, residual=res, relu=c.relu)
        fwd_out[id(cur)] = (mv, y if mask == 2 else None)

    def kernel_fwd():
        x, scale, bias, res, _ = nxt()
        _, mv = K.bn_fwd_stats_cuda(x)
        K.bn_fwd_apply_cuda(x, mv, scale, bias, eps=EPS, residual=res, relu=c.relu)

    def kernel_bwd():
        cur = nxt()
        x, scale, bias, _, dy = cur
        mv, y = fwd_out[id(cur)]
        bs, _ = K.bn_bwd_sums_cuda(x, dy, y, mv, scale, bias, eps=EPS, mask=mask)
        K.bn_bwd_dx_cuda(x, dy, y, mv, scale, bias, bs, eps=EPS, count=rows, mask=mask,
                         want_dres=mask == 2)

    def plain_fwd():
        x, scale, bias, res, _ = nxt()
        mv = ref.bn_moments_ref(ref.bn_stats_ref(x), rows)
        ref.bn_apply_ref(x, mv, scale, bias, eps=EPS, residual=res, relu=c.relu)

    def plain_bwd():
        cur = nxt()
        x, scale, bias, _, dy = cur
        mv, y = fwd_out[id(cur)]
        bs = ref.bn_bwd_sums_ref(x, dy, y, mv, scale, bias, eps=EPS, mask=mask)
        ref.bn_bwd_dx_ref(x, dy, y, mv, scale, bias, bs, eps=EPS, count=rows, mask=mask,
                          want_dres=mask == 2)

    def fwd_bwd(f):
        def run():
            x, scale, bias, res, dy = nxt()
            ins = [t.detach().requires_grad_() for t in (x, scale, bias)]
            torch.autograd.grad(f(*ins, res), ins, dy)
        return run

    def chain(x, scale, bias, res):   # as the model called it: the masters cast
        return ref.batchnorm_chain_ref(x, scale.to(x.dtype), bias.to(x.dtype), eps=EPS,
                                       residual=res, relu=c.relu)[0]

    def library(x, scale, bias, res):
        y = F.batch_norm(x, None, None, scale, bias, training=True, eps=EPS)
        y = y + res if res is not None else y
        return F.relu(y) if c.relu else y

    out = {
        "call": c.name, "shape": list(c.shape), "dtype": str(dtype)[6:],
        "fwd_ms": graph_ms(kernel_fwd, **kw), "bwd_ms": graph_ms(kernel_bwd, **kw),
        "plain_fwd_ms": graph_ms(plain_fwd, **kw), "plain_bwd_ms": graph_ms(plain_bwd, **kw),
        "chain_fwd_bwd_ms": graph_ms(fwd_bwd(chain), **kw),
        "library_fwd_bwd_ms": graph_ms(fwd_bwd(library), **kw),
        "fwd_bytes": fwd_b, "bwd_bytes": bwd_b,
        "fwd_bound_ms": 1e3 * fwd_b / HBM_BYTES_PER_S,
        "bwd_bound_ms": 1e3 * bwd_b / HBM_BYTES_PER_S,
        "copies": n,
    }
    del fwd_out
    torch.cuda.empty_cache()
    return out


def host_us(gen: torch.Generator, iters: int = 300) -> dict:
    """Host microseconds of one BN call with its residual and ReLU, forward
    and backward under autograd, through ``ops.batchnorm`` and through the
    earlier chain, at a shape where the card has next to nothing to do
    (1 x 64 x 8 x 8, bf16), so the time a call is the host's."""
    import time

    from repro_torch.kernels import ops

    c = Call("host", (1, 64, 8, 8), True, True)
    x, scale, bias, res, dy = inputs(c, torch.bfloat16, gen)
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias, res)]

    def kernels():
        y = ops.batchnorm(*leaves[:3], relu=True, residual=leaves[3])
        torch.autograd.grad(y, leaves, dy)

    def chain():
        y = ref.batchnorm_chain_ref(leaves[0], leaves[1].to(x.dtype), leaves[2].to(x.dtype),
                                    eps=EPS, residual=leaves[3], relu=True)[0]
        torch.autograd.grad(y, leaves, dy)

    out = {}
    for name, fn in (("kernels", kernels), ("chain", chain)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e6 * (time.perf_counter() - t0) / iters
    return out


def totals(rows: list[dict], counts: list[int]) -> dict:
    """Each column summed over the step's calls (a distinct row times its count)."""
    keys = ("fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms", "chain_fwd_bwd_ms",
            "library_fwd_bwd_ms", "fwd_bytes", "bwd_bytes", "fwd_bound_ms", "bwd_bound_ms")
    t = {k: sum(n * r[k] for r, n in zip(rows, counts)) for k in keys}
    t["kernels_ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["bound_ms"] = t["fwd_bound_ms"] + t["bwd_bound_ms"]
    t["of_bound"] = t["bound_ms"] / t["kernels_ms"]
    return t


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_bn: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs = distinct(calls(resnet.ResNetConfig.resnet50(), args.batch))
    tiny = distinct(calls(resnet.ResNetConfig.tiny(), 8))
    result = {"gpu": card, "torch": torch.__version__, "batch": args.batch, "checks": [],
              "times": []}
    for dtype, group in ((torch.bfloat16, cs), (torch.float32, tiny)):
        for c, _ in group:
            r = check(c, dtype, gen)
            result["checks"].append(r)
            print(json.dumps(r))
    result["host_us"] = host_us(gen)
    print(json.dumps({"host_us": result["host_us"]}))
    for c, n in cs:
        r = {**time_call(c, torch.bfloat16, gen), "count": n}
        result["times"].append(r)
        print(json.dumps(r))
    result["total"] = totals(result["times"], [n for _, n in cs])
    print(json.dumps({"total": result["total"]}))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0 if all(r["ok"] for r in result["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
