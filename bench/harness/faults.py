"""Faults planted in the program, by name, for the readings that set the
limits of ``compare.py`` and for the test that sees ``correct`` come out
false. ``planted`` patches the program's modules in the running process
for the length of a ``with`` block; a benchmark run never plants one.

- ``state_unchanged``: each step returns the train state it was given;
- ``half_batch``: each rank trains on the first half of its rows, the loss
  the mean over them;
- ``no_exchange``: the gradient sync returns each rank's own gradients.
"""

from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "no_exchange")


@contextlib.contextmanager
def planted(name: str | None):
    """The program with the fault ``name`` planted (None: as it is)."""
    from repro_torch.core import grad_sync
    from repro_torch.train import trainer

    saved = (trainer.make_train_step, trainer.shard_batch, grad_sync.sync_tree)
    if name is not None:
        _plant(name, trainer, grad_sync)
    try:
        yield
    finally:
        trainer.make_train_step, trainer.shard_batch, grad_sync.sync_tree = saved


def _plant(name: str, trainer, grad_sync) -> None:
    from repro_torch.train.state import TrainState

    if name == "state_unchanged":
        real = trainer.make_train_step

        def make(*args, **kw):
            step = real(*args, **kw)

            def unchanged(state, batch, epoch, global_batch):
                new, metrics = step(state, batch, epoch, global_batch)
                return TrainState(state.params, state.opt_state, new.step, state.loss_scale,
                                  state.good_steps), metrics
            return unchanged
        trainer.make_train_step = make
    elif name == "half_batch":
        real_shard = trainer.shard_batch

        def half(batch, rank, world):
            rows = real_shard(batch, rank, world)
            return type(rows)(t[:t.shape[0] // 2] for t in rows)
        trainer.shard_batch = half
    elif name == "no_exchange":
        grad_sync.sync_tree = lambda grads, grid, cfg=None, groups=None: dict(grads)
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
