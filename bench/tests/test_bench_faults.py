"""A run driven on the CPU at a tiny size, past the harness's look for a
chip, with the timed path broken underneath (``harness/faults.py``): each
fault that a cell can have makes ``correct`` come out false, and reads
above the same run without it."""

import time

import pytest
from conftest import TINY

from bench.harness import runner

# (cell, family, ranks, fault): a cell on a 2 x 2 grid of four ranks has the
# exchange between them to leave out too
CASES = [("resnet50.mlperf256", "resnet", 1, f) for f in ("state_unchanged", "half_batch")] + \
        [("qwen3-1.7b.seq4096", "lm", 1, f) for f in ("state_unchanged", "half_batch")] + \
        [("resnet50.mlperf256", "resnet", 4, f)
         for f in ("state_unchanged", "half_batch", "no_exchange")]


def _run(cell, family, ranks, fault):
    tiny = TINY[family]
    if ranks > 1:
        tiny = {**tiny, "chips": ranks, "traffic": {**tiny["traffic"], "grid": [2, ranks // 2]}}
    opts = runner.Options(cell, (2**31 + 11,), 0.1, device="cpu", overrides=tiny, fault=fault)
    r = runner.run(opts, time.perf_counter(), log=lambda line: None)[0]
    line, _ = runner.result(runner.load_cell(opts), r, opts, "cpu")
    return line


@pytest.mark.parametrize("cell,family,ranks,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, family, ranks, fault):
    line = _run(cell, family, ranks, fault)
    assert line["correct"] is False
    assert line["attempted"] > 0
    clean = _run(cell, family, ranks, None)
    worst = max(c["value"] / c["limit"] for c in line["checks"].values())
    assert worst > max(c["value"] / c["limit"] for c in clean["checks"].values())
