"""``examples/pt_quickstart.py``: the recipe on ResNet-tiny on a 2 x 4 grid
of gloo ranks under the supervised trainer, for 2 steps, through the
8-rank launcher (``tests/_pt_parity.py``)."""

import sys
from pathlib import Path

import pytest

from _pt_parity import launch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import pt_quickstart  # noqa: E402


@pytest.mark.multidevice
def test_quickstart_runs_two_steps_on_8_gloo_ranks(tmp_path, capsys):
    workdir = tmp_path / "work"
    workdir.mkdir()
    out = launch(pt_quickstart.run, tmp_path, (2, 4), "cpu", 2, str(workdir))
    for r in range(8):
        assert out[r]["step"] == 2
        rows = [h for h in out[r]["history"] if h["kind"] == "metric"]
        assert [h["step"] for h in rows] == [2] and rows[0]["skipped"] == 0
        assert rows[0]["global_batch"] == 16
    events = [h["event"] for h in out[0]["history"] if "event" in h]
    assert events.count("checkpoint") == 2          # the initial one and the stage end's
    assert sorted(p.name for p in (workdir / "ckpt").iterdir()) == [
        "step_00000000.manifest.json", "step_00000000.npz",
        "step_00000002.manifest.json", "step_00000002.npz"]
    assert (workdir / "metrics.jsonl").exists()
