"""The program under test for an ``lm`` configuration: the port's
transformer trained by the port's LM launcher (``launch/train.py:build``),
with the configuration's sizes put into the registry's config of its
``arch``. ``build`` runs on the meta device, so that it allocates nothing:
the benchmark hands the trainer its own weights and batches."""

from __future__ import annotations

import dataclasses

from bench.harness import spec

# the configuration file's keys -> the port's ArchConfig fields
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab",
          "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings"}


def build(config: dict, device, grid, data_fn):
    """(trainer, the program's parameter shapes by name)."""
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch_train

    m, r = config["model"], config["recipe"]
    arch = dataclasses.replace(registry.get(config["arch"]),
                               **{f: m[k] for k, f in FIELDS.items()},
                               compute_dtype=spec.DTYPES[r["compute_dtype"]], remat=r["remat"])
    run = launch_train.build(config["arch"], cfg=arch, sync=r["grad_sync"]["strategy"],
                             schedule=r["schedule"]["name"],
                             label_smoothing=r["label_smoothing"], device="meta", grid=grid)
    shapes = {n: tuple(p.shape) for n, p in run.state.params.items()}
    trainer = dataclasses.replace(run.trainer, data_fn=data_fn)
    return trainer, shapes
