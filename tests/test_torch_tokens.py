"""The port's ``SyntheticTokens`` and the training launcher
(``repro_torch.launch.train``) on the CPU.

The draws come from a ``torch.Generator``, so the tokens differ from
``jax.random``'s; the structure is the reference's
(``repro/data/synthetic.py:SyntheticTokens``): with probability 0.5 the next
token is (prev * 7 + 11) mod V, else a fresh draw, and the labels are the
next tokens.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticTokens as JTokens
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch import train as launch_train

REPO = Path(__file__).resolve().parents[1]


def _loop(rnd, use, vocab):
    """The rule position by position, as the reference's scan runs it."""
    tok = rnd.clone()
    for t in range(use.shape[1]):
        tok[:, t + 1] = torch.where(use[:, t], (tok[:, t] * 7 + 11) % vocab, rnd[:, t + 1])
    return tok


@pytest.mark.parametrize("vocab,seq", [(128, 40), (151_936, 2048)])
def test_closed_form_equals_the_loop_over_the_same_draws(vocab, seq):
    data = SyntheticTokens(vocab=vocab, seed=3, device="cpu")
    tokens, labels = data.batch(5, 3, seq)
    rnd, use = data.draws(5, 3, seq)
    want = _loop(rnd, use, vocab)
    assert tokens.shape == labels.shape == (3, seq) and tokens.dtype == torch.int64
    assert torch.equal(tokens, want[:, :-1]) and torch.equal(labels, want[:, 1:])


def test_labels_are_the_tokens_shifted_and_batches_repeat():
    data = SyntheticTokens(vocab=1000, device="cpu")
    tokens, labels = data.batch(0, 4, 64)
    assert torch.equal(labels[:, :-1], tokens[:, 1:])
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 1000
    again, _ = data.batch(0, 4, 64)
    other, _ = data.batch(1, 4, 64)
    assert torch.equal(again, tokens) and not torch.equal(other, tokens)


def test_about_half_the_transitions_follow_the_rule_as_in_the_reference():
    vocab = 32000
    tokens, labels = SyntheticTokens(vocab=vocab, device="cpu").batch(0, 16, 512)
    share = ((tokens * 7 + 11) % vocab == labels).double().mean().item()
    jt, jl = (np.asarray(a, np.int64) for a in JTokens(vocab=vocab).batch(0, 16, 512))
    jshare = float(((jt * 7 + 11) % vocab == jl).mean())
    # 8192 coins: 0.5 within 4 standard deviations (0.022)
    assert abs(share - 0.5) < 0.022 and abs(jshare - 0.5) < 0.022


def test_the_launcher_trains_the_smoke_config_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
         "--smoke", "--device", "cpu", "--steps", "3"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "13 LARS groups" in out.stdout
    done = [line for line in out.stdout.splitlines() if line.startswith("done: loss")]
    assert done and np.isfinite(float(done[0].split("->")[1].split()[0]))


def test_build_plans_the_stages_and_the_reference_recipe():
    run = launch_train.build("recurrentgemma-9b", smoke=True, seq=16, batch_stages=(2, 4),
                             steps=None, stage_steps=3, device="cpu")
    plan = run.trainer.plan
    assert [(s.global_batch, s.num_steps) for s in plan.stages] == [(2, 3), (4, 3)]
    sync = run.trainer.cfg.grad_sync
    assert (sync.strategy, sync.fuse, sync.comm_dtype) == ("torus2d", False, torch.bfloat16)
    assert sum(len(m) for _, m in run.groups) == len(run.state.params)
    state, history = run.trainer.run(run.state, log=lambda s: None)
    rows = [h for h in history if h["kind"] == "metric"]
    assert state.step == 6 and all(np.isfinite(r["loss"]) and not r["skipped"] for r in rows)
