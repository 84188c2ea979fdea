"""The control on the card at each one-card cell's own sizes: the reference
with its matrix operands in fp8, put in the program's place, is not correct
by the cell's limits (``readings.py control`` makes the same readings on
more seeds)."""

import sys

import pytest

from bench.harness import runner, spec

sys.path.insert(0, str(spec.BENCH))
import readings  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["resnet50.mlperf256", "qwen3-1.7b.seq4096"])
def test_the_control_is_not_correct(cuda, cell):
    c = runner.load_cell(runner.Options(cell, (1,), 0.0))
    numbers = readings.control(c, 2**31 + 5, cuda)["numbers"]
    limits = c.traffic["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
