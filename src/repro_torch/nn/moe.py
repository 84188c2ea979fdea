"""Mixture-of-Experts MLP as ``repro/nn/moe.py``: a top-k router and a
sort-based dispatch with a fixed capacity for each expert.

Parameters under the JAX package's names: ``router.kernel`` (d, E) and
``experts.up`` / ``experts.gate`` (E, d, f), ``experts.down`` (E, f, d).

The semantics are the reference's, step for step:

- routing in fp32 (the router kernel stays fp32 under ``compute_params``),
  softmax, top-k, gates renormalised with a 1e-9 clip, and the Switch
  load-balance loss;
- capacity ``ceil(T * k / E * capacity_factor)`` in Python floats; the
  (token, expert) slots sorted stably by expert, ranked within the expert,
  and those ranked at or past the capacity dropped (GShard/Switch). Left
  pad tokens compete for capacity like any other, and at decode (T = B)
  the capacity is small: granite's 40 experts, top 8, give 2 an expert at
  B = 8;
- each expert's FFN on its (capacity, d) rows as batched matmuls in the
  compute dtype (JAX computes them outside any Pallas kernel too);
- the combine: each token adds its kept slots' gated outputs in x's dtype,
  one after the other, by ascending expert. The reference scatter-adds
  the (E, capacity) slot buffer in slot order, which XLA's CPU scatter
  does sequentially with a rounding each add (``tests/test_torch_moe.py``
  checks it), so the port gathers each token's slots and adds them in that
  order: the same sums, and deterministic on the card, where a bf16
  ``index_add_`` would add in the order its atomics land.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.nn import init as winit
from repro_torch.nn import layers as L
from repro_torch.utils import dtensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"

    def capacity(self, tokens: int) -> int:
        return int(math.ceil(tokens * self.top_k / self.n_experts * self.capacity_factor))


def moe_init(gen: torch.Generator, cfg: MoEConfig) -> nn.ModuleDict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return nn.ModuleDict({
        "router": nn.ParameterDict({"kernel": winit.normal(gen, (d, E), std=0.02)}),
        "experts": nn.ParameterDict({
            "up": winit.lecun_normal(gen, (E, d, f), fan_in=d),
            "gate": winit.lecun_normal(gen, (E, d, f), fan_in=d),
            "down": winit.lecun_normal(gen, (E, f, d), fan_in=f),
        }),
    })


def route(p, xt: torch.Tensor, cfg: MoEConfig):
    """Router of the tokens xt (T, d): (gates (T, k) fp32, experts (T, k),
    aux). The logits are fp32 from the fp32 kernel."""
    T, k, E = xt.shape[0], cfg.top_k, cfg.n_experts
    logits = xt.float() @ p["router"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)                           # (T, E)
    gate_vals, topk_e = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load-balance loss (a scatter of fixed size: ``bincount`` would
    # wait for the device to learn its length)
    me = probs.mean(0)
    ce = probs.new_zeros(E).scatter_add_(0, topk_e.reshape(-1), probs.new_ones(T * k))
    ce = ce / (T * k)
    return gate_vals, topk_e, E * torch.sum(me * ce)


def dispatch(topk_e: torch.Tensor, cap: int, n_experts: int):
    """Slots of the (token, expert) pairs under capacity ``cap``.

    Returns ``slot_tok`` (E, cap): the token in each expert's slot, T where
    the slot is empty (the pad row), and ``slot_of`` (T, k): the flat slot
    ``e * cap + rank`` of each of a token's k choices, E * cap (a spare
    slot, dropped) where the pair was dropped. No boolean masks: a masked
    index would wait for the device to learn its size.
    """
    topk_e = dtensor.whole(topk_e, "moe dispatch: routing")   # no rule for searchsorted
    T, k = topk_e.shape
    dev = topk_e.device
    flat_e = topk_e.reshape(T * k)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    # rank within the expert's contiguous group
    pos = torch.arange(T * k, device=dev) - torch.searchsorted(se, se, side="left")
    flat_slot = torch.where(pos < cap, se * cap + pos, n_experts * cap)
    slot_tok = torch.full((n_experts * cap + 1,), T, dtype=torch.long, device=dev)
    slot_tok[flat_slot] = order // k       # the token of each pair; only the spare
    slot_of = torch.empty_like(flat_slot)  # slot is written more than once
    slot_of[order] = flat_slot
    return slot_tok[:-1].view(n_experts, cap), slot_of.reshape(T, k)


def expert_ffn(w, xe: torch.Tensor, act: str) -> torch.Tensor:
    """Each expert's FFN on its rows xe (E, cap, d), in xe's dtype."""
    h = torch.bmm(xe, L.cast(w["up"], xe.dtype))
    g = torch.bmm(xe, L.cast(w["gate"], xe.dtype))
    return torch.bmm(h * L.ACTS[act](g), L.cast(w["down"], xe.dtype))


def combine(ye: torch.Tensor, slot_of: torch.Tensor, topk_e: torch.Tensor) -> torch.Tensor:
    """y (T, d): each token's gated expert outputs ye (E, cap, d), gathered
    by ``slot_of`` and added one at a time by ascending expert, in ye's
    dtype (the reference's scatter order). Dropped pairs read a zero row."""
    d = ye.shape[-1]
    # DTensor: experts unevenly sharded cannot flatten
    ye = dtensor.unshard(ye, 0, what="moe combine: experts")
    rows = torch.cat([ye.reshape(-1, d), ye.new_zeros(1, d)])
    by_expert = torch.gather(slot_of, 1, torch.argsort(topk_e, dim=1))
    y = rows[by_expert[:, 0]]
    for j in range(1, by_expert.shape[1]):
        y = y + rows[by_expert[:, j]]
    return y


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux fp32 scalar)."""
    B, S, d = x.shape
    T = B * S
    cap = cfg.capacity(T)
    xt = x.reshape(T, d)
    gate_vals, topk_e, aux = route(p, xt, cfg)
    slot_tok, slot_of = dispatch(topk_e, cap, cfg.n_experts)
    # the gate of each slot in x's dtype, 0 where empty (the reference's
    # gate_buf), and the dropped pairs' gates in the spare slot
    gates = dtensor.whole(gate_vals, "moe dispatch: gates").reshape(-1).to(x.dtype)
    slot_gate = torch.zeros(cfg.n_experts * cap + 1, dtype=x.dtype, device=gates.device)
    slot_gate[slot_of.reshape(-1)] = gates
    slot_gate = dtensor.replicated_like(slot_gate, x)
    xe = dtensor.take_rows(torch.cat([xt, xt.new_zeros(1, d)]), slot_tok)   # (E, cap, d)
    ye = expert_ffn(p["experts"], xe, cfg.act)
    ye = ye * slot_gate[:-1].view(cfg.n_experts, cap, 1)
    return combine(ye, slot_of, topk_e).reshape(B, S, d), aux
