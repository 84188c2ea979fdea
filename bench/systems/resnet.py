"""The program under test for a ``resnet`` configuration: the port's
ResNet-50 trained through ``Trainer`` with the paper's recipe, composed as
the port's own entry does it (``examples/pt_train_resnet50_e2e.py``):
``models/resnet.py`` under ``core/losses.py``'s label-smoothed loss, with
the configuration's LARS, schedule, guard and gradient sync."""

from __future__ import annotations

import torch

from bench.harness import spec



def build(config: dict, device, grid, data_fn):
    """(trainer, the program's parameter shapes by name)."""
    from repro_torch.core import lars, losses
    from repro_torch.core.grad_sync import GradSyncConfig
    from repro_torch.models import resnet
    from repro_torch.train.trainer import GuardConfig, Trainer, TrainerConfig

    m, r = config["model"], config["recipe"]
    model = resnet.init(resnet.ResNetConfig(
        stage_sizes=tuple(m["stage_sizes"]), width=m["width"], num_classes=m["num_classes"],
        image_size=m["image_size"], compute_dtype=spec.DTYPES[r["compute_dtype"]]), device=device)
    smoothing = r["label_smoothing"]

    def loss_fn(params, batch, grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=params, grid=grid)
        return (losses.label_smoothing_xent(logits, labels, smoothing),
                torch.zeros((), device=device))

    s, lc = r["grad_sync"], r["lars"]
    cfg = TrainerConfig(
        schedule=r["schedule"]["name"],
        grad_sync=GradSyncConfig(strategy=s["strategy"], comm_dtype=spec.DTYPES[s["comm_dtype"]],
                                 fuse=s["fuse"], bucket_bytes=s["bucket_bytes"]),
        lars=lars.LARSConfig(eta=lc["eta"], eps=lc["eps"], weight_decay=lc["weight_decay"],
                             skip_tags=tuple(lc["skip_tags"]), nesterov=lc["nesterov"]),
        guard=GuardConfig(enabled=r["guard"]["enabled"]))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn=loss_fn, cfg=cfg, plan=None, data_fn=data_fn, grid=grid)
    return trainer, shapes
