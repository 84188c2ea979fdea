"""The port's checkpoints (``repro_torch/train/checkpoint.py``) against the
JAX package's (``repro/train/checkpoint.py``): one on-disk format, so a
checkpoint written by either package restores in the other bit for bit,
and the two manifests of the same state agree key for key, CRC for CRC.
Also the reference's own cases (``tests/test_robustness.py``,
``tests/test_elastic.py``) on the port's writer, and a guard that the async
writer's snapshot is a copy: writes to the state after ``save`` returns
never reach the file.
"""

import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet as jresnet
from repro.train import checkpoint as jck
from repro.train.state import TrainState as JState
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.testing.chaos import FaultPlan
from repro_torch.train import checkpoint
from repro_torch.train.checkpoint import AsyncCheckpointWriter
from repro_torch.train.state import TrainState


def _jax_tree(seed=0):
    cfg = jresnet.ResNetConfig.tiny(num_classes=4)
    return jax.tree.map(np.asarray, jresnet.init(jax.random.key(seed), cfg))


def _pair(step=5, loss_scale=8.0, good_steps=3, seed=0):
    """The same train state in both packages: ResNet-tiny params, momentum
    params / 3 (every leaf non-zero), and the guard scalars."""
    tree = _jax_tree(seed)
    mom = jax.tree.map(lambda a: a / 3, tree)
    js = JState(tree, {"momentum": mom}, jnp.asarray(step, jnp.int32),
                jnp.asarray(loss_scale, jnp.float32), jnp.asarray(good_steps, jnp.int32))
    ts = TrainState(params_from_jax(tree, device="cpu"),
                    {"momentum": params_from_jax(mom, device="cpu")}, step,
                    torch.tensor(loss_scale), torch.tensor(good_steps, dtype=torch.int32))
    return js, ts


def state_at(step, seed=1):
    return _pair(step=step, seed=seed)[1]


def assert_states_equal(a: TrainState, b: TrainState):
    assert list(a.params) == list(b.params)
    for x, y in ((a.params, b.params), (a.opt_state["momentum"], b.opt_state["momentum"])):
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k
    assert a.step == b.step and isinstance(a.step, int)
    assert torch.equal(a.loss_scale, b.loss_scale)
    assert torch.equal(a.good_steps, b.good_steps)


# --------------------------------------------------- one format, two packages --

def test_manifests_of_the_same_state_are_equal(tmp_path):
    js, ts = _pair()
    pj = jck.save(str(tmp_path / "jax"), js, meta={"global_batch": 16})
    pt = checkpoint.save(str(tmp_path / "torch"), ts, meta={"global_batch": 16})
    mj, mt = jck.load_manifest(pj), checkpoint.load_manifest(pt)
    assert list(mt["leaves"]) == list(mj["leaves"])       # keys, in flatten order
    assert mt == mj                                        # shapes, dtypes, CRCs
    assert "params::stages::0::0::conv1::kernel" in mt["leaves"]
    assert {"step", "loss_scale", "good_steps"} <= set(mt["leaves"])
    assert mt["format_version"] == checkpoint.FORMAT_VERSION == jck.FORMAT_VERSION
    # the same bytes: every leaf, conv kernels in HWIO, in the same order
    assert open(pt, "rb").read() == open(pj, "rb").read()


def test_a_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    js, ts = _pair()
    path = jck.save(str(tmp_path), js)
    like = state_at(0, seed=2)
    assert_states_equal(checkpoint.restore(path, like), ts)
    assert checkpoint.latest_valid(str(tmp_path), like=like) == path


def test_a_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    js, ts = _pair()
    path = checkpoint.save(str(tmp_path), ts)
    like = _pair(step=0, seed=2)[0]
    got = jck.restore(path, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got.step) == 5 and float(got.loss_scale) == 8.0
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(ts.params),
                 jax.tree.map(np.asarray, got.params))


def test_restore_keeps_like_s_device_dtype_and_layout(tmp_path):
    _, ts = _pair()
    path = checkpoint.save(str(tmp_path), ts)
    like = state_at(0)
    # the dense kernel column-major, every other leaf contiguous
    like.params = {k: v.t().contiguous().t() if v.dim() == 2 else v.contiguous()
                   for k, v in like.params.items()}
    restored = checkpoint.restore(path, like)
    for k, v in restored.params.items():
        assert v.device.type == "cpu" and v.stride() == like.params[k].stride(), k
        assert torch.equal(v, ts.params[k]), k
    assert any(not v.is_contiguous() for v in restored.params.values())
    assert restored.loss_scale.dtype == torch.float32
    assert restored.good_steps.dtype == torch.int32


def test_a_mismatched_structure_is_rejected(tmp_path):
    _, ts = _pair()
    path = checkpoint.save(str(tmp_path), ts)
    like = state_at(0)
    name = next(n for n in like.params if like.params[n].dim() == 4)
    like.params[name] = torch.zeros(like.params[name].shape[0] + 1,
                                    *like.params[name].shape[1:])
    with pytest.raises(checkpoint.CheckpointCorruptError, match="shape"):
        checkpoint.restore(path, like)
    missing = state_at(0)
    missing.params["extra.kernel"] = torch.zeros(2, 2)
    with pytest.raises(checkpoint.CheckpointCorruptError, match="absent"):
        checkpoint.validate(path, like=missing)


# ------------------------------------------------------ the reference's cases --

def test_checkpoint_roundtrip_preserves_guard_state(tmp_path):
    _, ts = _pair(step=0, loss_scale=8.0, good_steps=0)
    path = checkpoint.save(str(tmp_path), ts)
    assert_states_equal(checkpoint.restore(path, ts), ts)
    manifest = checkpoint.validate(path, like=ts)
    assert manifest["step"] == 0 and manifest["format_version"] == 1


def test_latest_orders_by_step_not_mtime(tmp_path):
    p10 = checkpoint.save(str(tmp_path), state_at(10))
    p5 = checkpoint.save(str(tmp_path), state_at(5))
    os.utime(p10, (1, 1))
    assert checkpoint.latest(str(tmp_path)) == p10
    for src in (p5, checkpoint.manifest_path(p5)):
        shutil.copy(src, str(tmp_path / os.path.basename(src).replace("step_", "restored_")))
    assert checkpoint.latest(str(tmp_path)) == p10


def test_truncated_checkpoint_rejected_with_fallback(tmp_path):
    s5, s10 = state_at(5), state_at(10)
    p5 = checkpoint.save(str(tmp_path), s5)
    p10 = checkpoint.save(str(tmp_path), s10)
    with open(p10, "r+b") as f:
        f.truncate(os.path.getsize(p10) // 2)
    with pytest.raises(checkpoint.CheckpointCorruptError, match="unreadable payload|CRC"):
        checkpoint.restore(p10, s10)
    skipped = []
    best = checkpoint.latest_valid(str(tmp_path), like=s5,
                                   on_skip=lambda p, r: skipped.append(p))
    assert best == p5 and skipped == [p10]
    assert_states_equal(checkpoint.restore(best, s5), s5)


def test_bitflip_detected_by_crc(tmp_path):
    path = checkpoint.save(str(tmp_path), state_at(0))
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.validate(path)


def test_crashed_write_leaves_no_torso(tmp_path):
    s5, s10 = state_at(5), state_at(10)
    p5 = checkpoint.save(str(tmp_path), s5)
    plan = FaultPlan(ckpt_crash_writes=(0,), ckpt_crashes_per_write=99)
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.save(str(tmp_path), s10, retries=2, backoff_s=1e-4,
                        io_hook=plan.checkpoint_io_hook)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(p5), os.path.basename(checkpoint.manifest_path(p5))])
    checkpoint.validate(p5, like=s5)


def test_retention_prunes_oldest(tmp_path):
    for step in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), state_at(step), keep_last=2)
    left = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert left == ["step_00000003.npz", "step_00000004.npz"]
    assert checkpoint.latest(str(tmp_path)).endswith("step_00000004.npz")


def test_save_retries_transient_io_errors(tmp_path):
    state = state_at(0)
    plan = FaultPlan(ckpt_crash_writes=(0,), ckpt_crashes_per_write=2)
    attempts = []
    path = checkpoint.save(str(tmp_path), state, retries=3, backoff_s=1e-4,
                           io_hook=plan.checkpoint_io_hook,
                           on_retry=lambda a, e: attempts.append(a))
    assert attempts == [0, 1]
    checkpoint.validate(path, like=state)


def test_restore_after_partial_commit_rejected_with_fallback(tmp_path):
    p1 = checkpoint.save(str(tmp_path), state_at(1))
    p2 = checkpoint.save(str(tmp_path), state_at(2))
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) * 2 // 3)
    with pytest.raises(checkpoint.CheckpointCorruptError,
                       match="unreadable payload|CRC|missing"):
        checkpoint.restore(p2, state_at(2))
    skipped = []
    best = checkpoint.latest_valid(str(tmp_path), like=state_at(1),
                                   on_skip=lambda p, r: skipped.append(p))
    assert best == p1 and skipped == [p2]
    assert checkpoint.restore(best, state_at(1)).step == 1


def test_partial_commit_payload_without_manifest_is_skipped(tmp_path):
    p1 = checkpoint.save(str(tmp_path), state_at(1))

    def manifest_crash(phase, attempt):
        if phase == "manifest":
            raise OSError("injected manifest-write crash")

    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.save(str(tmp_path), state_at(2), retries=1, backoff_s=1e-4,
                        io_hook=manifest_crash)
    torso = str(tmp_path / "step_00000002.npz")
    assert os.path.exists(torso) and not os.path.exists(checkpoint.manifest_path(torso))
    with pytest.raises(checkpoint.CheckpointCorruptError, match="manifest"):
        checkpoint.validate(torso)
    skipped = []
    best = checkpoint.latest_valid(str(tmp_path), like=state_at(1),
                                   on_skip=lambda p, r: skipped.append(p))
    assert best == p1 and skipped == [torso]


# -------------------------------------------------------- the async writer --

def _gate():
    gate, entered = threading.Event(), threading.Event()

    def hook(phase, attempt):
        if phase == "payload":
            entered.set()
            assert gate.wait(30)
    return gate, entered, hook


def test_async_writer_matches_sync_writer(tmp_path):
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    states = [state_at(s) for s in (1, 2, 3)]
    for st in states:
        checkpoint.save(sync_dir, st, meta={"k": 1})
    w = AsyncCheckpointWriter()
    for st in states:
        w.save(async_dir, st, meta={"k": 1})
    assert w.flush(30)
    w.close()
    assert w.errors == []
    assert sorted(os.listdir(sync_dir)) == sorted(os.listdir(async_dir))
    for d in (sync_dir, async_dir):
        assert checkpoint.latest(d).endswith("step_00000003.npz")
        assert checkpoint.latest_valid(d, like=states[0]) == checkpoint.latest(d)
    for name in os.listdir(sync_dir):
        a = open(os.path.join(sync_dir, name), "rb").read()
        assert a == open(os.path.join(async_dir, name), "rb").read(), name


def test_async_save_never_blocks_on_payload_io(tmp_path):
    gate, entered, hook = _gate()
    w = AsyncCheckpointWriter()
    path = w.save(str(tmp_path), state_at(1), io_hook=hook)
    assert entered.wait(30)
    assert w.pending() == 1 and not os.path.exists(path)
    gate.set()
    assert w.flush(30) and w.pending() == 0
    w.close()
    checkpoint.validate(path, like=state_at(1))


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The state's tensors are overwritten in place while the commit waits:
    the file holds the values of the moment ``save`` was called."""
    gate, entered, hook = _gate()
    state, want = state_at(4), state_at(4)
    w = AsyncCheckpointWriter()
    path = w.save(str(tmp_path), state, io_hook=hook)
    assert entered.wait(30)
    with torch.no_grad():
        for t in list(state.params.values()) + list(state.opt_state["momentum"].values()):
            t.fill_(7.0)
        state.loss_scale.fill_(0.5)
        state.good_steps.fill_(9)
    gate.set()
    assert w.flush(30)
    w.close()
    assert w.errors == []
    assert_states_equal(checkpoint.restore(path, state_at(0)), want)


def test_async_bounded_queue_applies_backpressure(tmp_path):
    gate, entered, hook = _gate()
    w = AsyncCheckpointWriter(max_pending=1)
    w.save(str(tmp_path), state_at(1), io_hook=hook)
    assert entered.wait(30)
    w.save(str(tmp_path), state_at(2))
    third_done = threading.Event()
    t = threading.Thread(target=lambda: (w.save(str(tmp_path), state_at(3)),
                                         third_done.set()), daemon=True)
    t.start()
    assert not third_done.wait(0.3)
    assert w.pending() == 3
    gate.set()
    assert third_done.wait(30)
    assert w.flush(30)
    w.close()
    t.join(30)
    assert not t.is_alive()
    assert [s for s, _ in checkpoint._candidates(str(tmp_path))] == [1, 2, 3]


def test_async_survives_midwrite_crash_and_retries(tmp_path):
    plan = FaultPlan(ckpt_crash_writes=(0,), ckpt_crashes_per_write=2)
    w = AsyncCheckpointWriter(retries=3, backoff_s=1e-4)
    path = w.save(str(tmp_path), state_at(1), io_hook=plan.checkpoint_io_hook)
    assert w.flush(30)
    w.close()
    kinds = [e["event"] for e in w.drain_events()]
    assert kinds.count("checkpoint_retry") == 2 and kinds[-1] == "checkpoint"
    assert w.errors == []
    checkpoint.validate(path, like=state_at(1))


def test_async_persistent_failure_surfaces_and_preserves_previous(tmp_path):
    prev = checkpoint.save(str(tmp_path), state_at(1))
    plan = FaultPlan(ckpt_dir_fail_from=0)
    w = AsyncCheckpointWriter(retries=2, backoff_s=1e-4)
    w.save(str(tmp_path), state_at(2), io_hook=plan.checkpoint_io_hook)
    assert w.flush(30)
    w.close()
    assert w.drain_events()[-1]["event"] == "checkpoint_failed"
    assert len(w.errors) == 1 and isinstance(w.errors[0], checkpoint.CheckpointError)
    assert checkpoint.latest_valid(str(tmp_path), like=state_at(1)) == prev
    with pytest.raises(checkpoint.CheckpointError, match="closed"):
        w.save(str(tmp_path), state_at(3))
