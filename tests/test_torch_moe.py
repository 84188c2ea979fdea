"""The port's MoE MLP (``repro_torch/nn/moe.py``) against the JAX package's
``repro/nn/moe.py::moe_apply``, on the CPU.

Weights come from ``repro.nn.moe.moe_init``; inputs from numpy with a fixed
seed, the same values on both sides (in bf16: the same bf16 values). Three
things are compared:

- which (token, expert) pairs are kept under the capacity. The reference
  keeps its slot buffer inside the function, so it is read through a probe:
  with the experts set so that expert e's output is e's unit vector times
  act(1) (input feature 0 is 1), ``y[t, 1 + e]`` is non-zero exactly where
  the pair (t, e) was kept. The routing depends on the router and x only,
  so the probe's kept pairs are those of the random experts' run;
- y, fp32: the same sums in another order, rtol 1e-5 and atol 1e-6.
  bf16: both round to bf16, but not at the same places (XLA's CPU fusions
  keep some intermediates in fp32), so y is held to a count of roundings.
  Each rounding moves a value by at most half a bf16 step, 2^-9 of it;
  relative to the magnitude of the computation, ``y_abs = sum over kept
  experts of gate * (|up(x) * act(gate(x))| @ |down|)``, the port rounds
  four times in the hidden layer (two projections, the activation, the
  product), twice after it (the down product, the gate) and k times in
  the combine; the reference no more. So |err| <= (6 + k) 2^-8 y_abs, and
  the cases here reach 3.43 2^-8 y_abs at k = 2 (against 8);
- aux, the Switch loss, from the same fp32 probabilities: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro.nn import moe as jM
from repro_torch.nn import layers as L
from repro_torch.nn import moe as tM

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(t, e, k, cf, act, f=8):
    # d > E: the probe writes expert e to output feature 1 + e
    kw = dict(d_model=max(16, e + 1), d_ff=f, n_experts=e, top_k=k, capacity_factor=cf,
              act=act)
    return jM.MoEConfig(**kw), tM.MoEConfig(**kw)


def _inputs(jcfg, t, dtype, seed, hot=False):
    """(numpy params, JAX x, port x): x (1, t, d) with feature 0 at 1.
    ``hot``: the router's row for feature 0 adds 1 to expert 0's logit, so
    every token picks expert 0 (router logits are ~0.1 otherwise)."""
    jdt, tdt = DTYPES[dtype]
    p = jax.tree.map(np.array, jM.moe_init(jax.random.key(seed), jcfg))
    if hot:
        p["router"]["kernel"][0, 0] += 1.0
    x = np.random.RandomState(seed + 1).randn(1, t, jcfg.d_model).astype(np.float32)
    x[..., 0] = 1.0
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    return p, jx, tx


def _port_tree(p):
    return {"router": {"kernel": torch.tensor(p["router"]["kernel"])},
            "experts": {n: torch.tensor(v) for n, v in p["experts"].items()}}


def _probe_experts(p, jcfg):
    """Experts whose output for token t is act(1) * unit vector 1 + e."""
    E, d, f = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    up, gate, down = (np.zeros((E, d, f), np.float32), np.zeros((E, d, f), np.float32),
                      np.zeros((E, f, d), np.float32))
    up[:, 0, 0] = gate[:, 0, 0] = 1.0
    down[np.arange(E), 0, 1 + np.arange(E)] = 1.0
    return {"router": p["router"], "experts": {"up": up, "gate": gate, "down": down}}


def _kept_by_jax(p, jx, jcfg):
    y, _ = jM.moe_apply(jax.tree.map(jnp.asarray, _probe_experts(p, jcfg)), jx, jcfg)
    y = np.asarray(y.astype(jnp.float32)).reshape(-1, jcfg.d_model)
    return {(int(t), int(e) - 1) for t, e in zip(*np.nonzero(y)) if e >= 1}


def _kept_by_port(p, tx, tcfg):
    T = tx.shape[0] * tx.shape[1]
    _, topk_e, _ = tM.route(_port_tree(p), tx.reshape(T, -1), tcfg)
    _, slot_of = tM.dispatch(topk_e, tcfg.capacity(T), tcfg.n_experts)
    rows, cols = torch.nonzero(slot_of < tcfg.n_experts * tcfg.capacity(T), as_tuple=True)
    return {(int(r), int(topk_e[r, c])) for r, c in zip(rows, cols)}


def _y_abs(p, tx, tcfg) -> np.ndarray:
    """(T, d): sum over a token's kept experts of gate * (|hidden| @ |down|),
    in fp32 from the same inputs."""
    T = tx.shape[0] * tx.shape[1]
    xt = tx.reshape(T, -1).float()
    gates, topk_e, _ = tM.route(_port_tree(p), xt, tcfg)
    _, slot_of = tM.dispatch(topk_e, tcfg.capacity(T), tcfg.n_experts)
    up, gate, down = (torch.tensor(p["experts"][n]) for n in ("up", "gate", "down"))
    out = torch.zeros_like(xt)
    for t, j in zip(*torch.nonzero(slot_of < tcfg.n_experts * tcfg.capacity(T),
                                   as_tuple=True)):
        e = topk_e[t, j]
        hidden = (xt[t] @ up[e]) * L.ACTS[tcfg.act](xt[t] @ gate[e])
        out[t] += gates[t, j] * (hidden.abs() @ down[e].abs())
    return out.numpy()


def _check(t, e, k, cf, act, dtype, seed, hot=False):
    """Kept pairs equal, y and aux within tolerance; returns (kept, T * k)."""
    jcfg, tcfg = _configs(t, e, k, cf, act)
    p, jx, tx = _inputs(jcfg, t, dtype, seed, hot)
    kept = _kept_by_jax(p, jx, jcfg)
    assert _kept_by_port(p, tx, tcfg) == kept
    # the port's probe output reads the same pairs
    ty, _ = tM.moe_apply(_port_tree(_probe_experts(p, jcfg)), tx, tcfg)
    ty = ty.float().reshape(-1, jcfg.d_model).numpy()
    assert {(int(a), int(b) - 1) for a, b in zip(*np.nonzero(ty)) if b >= 1} == kept
    want, want_aux = jM.moe_apply(jax.tree.map(jnp.asarray, p), jx, jcfg)
    got, aux = tM.moe_apply(_port_tree(p), tx, tcfg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tx.shape
    assert aux.dtype == torch.float32
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        bound = (6 + k) * 2.0 ** -8 * _y_abs(p, tx, tcfg)
        err = np.abs(got - want).reshape(bound.shape)
        assert (err <= bound).all(), f"worst err/bound {(err / bound).max():.3f}"
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    return kept, t * k


def test_xla_cpu_scatter_adds_in_slot_order_rounding_each_add():
    """What the port's combine mirrors: XLA's CPU scatter-add in bf16 adds
    the updates one at a time in index order, rounding to bf16 after each
    add (not once at the end, which differs here by up to 16)."""
    rng = np.random.RandomState(0)
    T, d, n = 64, 256, 8
    vals = (rng.randn(T * n, d) * np.exp(2 * rng.randn(T * n, 1))).astype(np.float32)
    idx = rng.permutation(np.repeat(np.arange(T), n))
    vb = jnp.asarray(vals).astype(jnp.bfloat16)
    got = jax.jit(lambda v, i: jnp.zeros((T, d), jnp.bfloat16).at[i].add(v))(vb, idx)
    got = torch.from_numpy(np.array(got.astype(jnp.float32)))
    v = torch.from_numpy(np.array(vb.astype(jnp.float32))).to(torch.bfloat16)
    seq, once = torch.zeros(T, d, dtype=torch.bfloat16), torch.zeros(T, d)
    for s in range(T * n):
        seq[idx[s]] = seq[idx[s]] + v[s]
        once[idx[s]] += v[s].float()
    assert torch.equal(got, seq.float())
    assert not torch.equal(got, once.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("t, e, k, cf, hot, drops", [
    (12, 4, 2, 2.0, True, False),   # capacity factor E/k: cap = T, nothing dropped
    (5, 8, 2, 1.25, True, True),    # T small: cap 2, expert 0 drops 3 of its 5
    (6, 4, 2, 0.5, False, True),    # cap 2 for 12 pairs over 4 experts
    (8, 40, 8, 1.25, True, True),   # granite's E and k at decode (T = B = 8): cap 2
])
def test_moe_apply_matches_jax(t, e, k, cf, hot, drops, act, dtype):
    kept, pairs = _check(t, e, k, cf, act, dtype, seed=0, hot=hot)
    assert (len(kept) < pairs) == drops
    assert len({tok for tok, _ in kept}) > 0


def test_capacity_is_the_reference_formula_in_python_floats():
    cfg = tM.MoEConfig(d_model=1536, d_ff=512, n_experts=40, top_k=8)
    assert cfg.capacity(8) == 2                    # granite at decode, B = 8
    assert cfg.capacity(8 * 2048) == 4096          # granite's prefill, 8 x 2048
    assert tM.MoEConfig(4, 4, 4, 2, capacity_factor=2.0).capacity(12) == 12


def test_dispatch_keeps_the_first_tokens_of_an_expert_in_token_order():
    """A stable sort: when an expert is over capacity, its lowest tokens
    keep their slots, as in the reference."""
    topk_e = torch.tensor([[0, 1], [0, 2], [0, 1], [0, 3]])
    slot_tok, slot_of = tM.dispatch(topk_e, cap=2, n_experts=4)
    assert slot_tok[0].tolist() == [0, 1]            # tokens 2, 3 dropped at expert 0
    assert slot_tok[1].tolist() == [0, 2]
    assert slot_tok[2].tolist() == [1, 4] and slot_tok[3].tolist() == [3, 4]  # 4 = pad row
    assert slot_of.tolist() == [[0, 2], [1, 4], [8, 3], [8, 6]]              # 8 = dropped


def test_moe_apply_gradients_match_jax():
    """Through the router's gates and the experts, fp32: every weight's
    and the input's gradient of a fixed projection of y plus aux."""
    jcfg, tcfg = _configs(6, 4, 2, 1.25, "silu")
    p, jx, tx = _inputs(jcfg, 6, "float32", seed=3)
    w = np.random.RandomState(4).randn(*tx.shape).astype(np.float32)

    def jloss(params, x):
        y, aux = jM.moe_apply(params, x, jcfg)
        return (y * w).sum() + aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jx)
    tp = _port_tree(p)
    leaves = [tp["router"]["kernel"], *tp["experts"].values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx.requires_grad_(True)
    y, aux = tM.moe_apply(tp, tx, tcfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    want = [jg["router"]["kernel"], *(jg["experts"][n] for n in tp["experts"])]
    for leaf, ref in zip(leaves + [tx], want + [jgx]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


@settings(max_examples=6, deadline=None)
@given(t=st.integers(1, 12), e=st.integers(2, 8), k=st.integers(1, 3),
       cf=st.sampled_from([0.5, 1.0, 1.25, 2.0]), act=st.sampled_from(["silu", "gelu"]),
       dtype=st.sampled_from(list(DTYPES)), seed=st.integers(0, 99))
def test_moe_property_matches_jax(t, e, k, cf, act, dtype, seed):
    """Any token count, experts, top-k and capacity: the same kept pairs,
    y and aux as the reference; y finite, no pair kept twice and no expert
    over its capacity."""
    k = min(k, e)
    kept, _ = _check(t, e, k, cf, act, dtype, seed)
    cap = tM.MoEConfig(16, 8, e, k, capacity_factor=cf).capacity(t)
    per_expert = np.bincount([ex for _, ex in kept], minlength=e)
    assert per_expert.max(initial=0) <= cap
