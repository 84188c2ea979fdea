"""The benchmark as data: ``BENCHMARK.json`` at the root of the checkout, and
the files it names, each found by its name.

- a configuration: ``bench/configs/<config>.json`` (the entry's ``file``),
  whose ``reference`` names its plain model in ``bench/reference/`` and
  whose ``family`` names the code that builds the program in
  ``bench/systems/``;
- a cell: ``bench/workloads/<cell>.json``, the traffic's parameters and
  the limits of the comparison that decides ``correct``;
- a kind of traffic (the cell file's ``kind``): ``bench/traffic/<kind>.py``,
  with ``pool(cell, seed, device, global_batch)``, the ready batches made
  at set-up, and ``items(traffic, global_batch)``, the images or tokens a
  step trains; and where the kind needs them, ``fetch(pool, call)``, the
  batch that ``data_fn``'s ``call``-th call returns (default: the pool's
  batches in turn), and ``trainer_fields(traffic, workdir)``, fields of the
  program's ``Trainer`` that the kind sets, such as a ``checkpoint_dir``
  under ``workdir``, the run's own directory (default: none);
- an end-to-end metric: ``bench/end_to_end/<metric>.py``, a per-layer one
  ``bench/metrics/<metric>.py``, each a ``read`` function.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}   # a configuration's names


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's content
    traffic: dict         # the cell file's content
    end_to_end: tuple     # BENCHMARK.json's entries this cell reports
    per_layer: tuple


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    if traffic["traffic"] != entry["traffic"] or config["name"] != conf["name"]:
        raise ValueError(f"{name}: the cell's files do not match BENCHMARK.json")
    grid = traffic["grid"]
    if grid[0] * grid[1] != entry["chips"]:
        raise ValueError(f"{name}: a {grid[0]} x {grid[1]} grid on {entry['chips']} chips")
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    e2e_names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"]
                      if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names))
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer)


def reader(kind: str, name: str):
    """The ``read`` function of ``bench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traffic(kind: str):
    """The module that makes the batches of the traffic's ``kind``."""
    return importlib.import_module(f"bench.traffic.{kind}")


def system(config: dict):
    """The module that builds the program for the configuration's family."""
    return importlib.import_module(f"bench.systems.{config['family']}")
