"""The work of a decoder LM's training step and of its kernels, counted from
the configuration's sizes alone.

- parameters: the embedding once (tied), per layer q, k, v, o, the three MLP
  matrices and the four norm vectors, and the final norm;
- model FLOPs a token: 6 N (the tied head's matrix counted once, in N) plus
  causal attention, 12 L H D (S + 1) / 2 (the forward's two products over
  the (S + 1) / 2 keys a query sees on average, times three for training);
- the flash kernels: the forward's two products, 4 B H D S (S + 1) / 2
  FLOPs a layer, and the backward's five, 2.5 times that; bytes: q, k, v
  read and o and the row statistics written by the forward, q, k, v, o,
  dO and the statistics read and dQ, dK, dV written by the backward, each
  once, in the compute type (the statistics in float32);
- LARS: p, g and v read once and p and v written once, in float32.
"""

from __future__ import annotations

BF16, F32 = 2, 4


def params(model: dict) -> int:
    d, h, hkv, hd, f = (model["hidden_size"], model["num_attention_heads"],
                        model["num_key_value_heads"], model["head_dim"],
                        model["intermediate_size"])
    layer = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f + 2 * d + 2 * hd
    return model["vocab_size"] * d + model["num_hidden_layers"] * layer + d


def flops_per_token(model: dict, seq: int) -> float:
    attn = 12 * model["num_hidden_layers"] * model["num_attention_heads"] * model["head_dim"] \
        * (seq + 1) / 2
    return 6 * params(model) + attn


def flash_flops(model: dict, batch: int, seq: int) -> float:
    """Forward plus backward FLOPs of every layer's flash kernels a step."""
    fwd = 4 * batch * model["num_attention_heads"] * model["head_dim"] * seq * (seq + 1) / 2
    return 3.5 * fwd * model["num_hidden_layers"]


def flash_bytes(model: dict, batch: int, seq: int) -> float:
    h, hkv, hd = model["num_attention_heads"], model["num_key_value_heads"], model["head_dim"]
    q = batch * seq * h * hd * BF16
    kv = batch * seq * hkv * hd * BF16
    lse = batch * h * seq * F32
    fwd = q + 2 * kv + q + lse                     # q, k, v in; o, lse out
    bwd = (q + 2 * kv + q + q + lse) + (q + 2 * kv)  # q, k, v, o, dO, lse in; dq, dk, dv out
    return (fwd + bwd) * model["num_hidden_layers"]


def lars_bytes(model: dict) -> float:
    return 5 * F32 * params(model)
