"""``launch/perf.py`` against ``repro/launch/perf.py``, on torch's ``fake``
process group and meta tensors.

The port keeps the reference's experiments, in its order, with its labels
and record keys; each experiment runs here on a smoke arch with small
meshes passed in. The rates are the H100's, a record with wire bytes
needs a fabric (none of the port is measured), and ``card_step`` counts
the one-card training step that ``chip_smoke.py`` times.
"""

import os

import jax
import pytest

from repro_torch.launch import perf

# a record's keys in the reference (src/repro/launch/perf.py:58-73), its
# compile_s as the port's wall_s
REF_KEYS = {"label", "compute_s", "memory_s", "collective_s", "coll_bytes", "coll_counts",
            "temp_gib", "dominant"}
SMALL = {"data": 2, "model": 2}
TWO_PODS = {"pod": 2, "data": 2, "model": 2}
FACTORIZED = {"data_y": 2, "data_x": 2, "model": 2}
LINK_BW = 1e11          # a fabric for the test's records: bytes/s a link


def _reference():
    """The reference module, ``XLA_FLAGS`` put back (its import sets them)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as jperf
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jperf


def _check(records, labels):
    assert [r["label"] for r in records] == labels
    for r in records:
        assert REF_KEYS | {"wall_s"} <= set(r), set(r)
        assert r["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                    key=lambda k: r[k])
        assert r["compute_s"] == r["flops"] / perf.PEAK_FLOPS > 0
        assert r["memory_s"] == r["bytes_accessed"] / perf.HBM_BW > 0
        assert set(r["coll_counts"]) == {"all-reduce", "all-gather", "reduce-scatter",
                                         "all-to-all", "collective-permute"}


def test_experiments_are_the_references():
    assert list(perf.EXPERIMENTS) == list(_reference().EXPERIMENTS)


def test_rates_are_the_h100s():
    """bf16 dense tensor-core peak and HBM3 rate of the H100 SXM data sheet;
    no fabric is assumed."""
    assert (perf.PEAK_FLOPS, perf.HBM_BW) == (989.4e12, 3.35e12)
    assert not hasattr(perf, "ICI_BW")


def test_sync_strategies():
    recs = perf.exp_sync_strategies(LINK_BW, meshes=(SMALL, TWO_PODS), smoke=True)
    _check(recs, [f"{m}/{s}" for m in ("1pod", "2pod")
                  for s in ("psum", "ring", "hierarchical", "torus2d")])
    for r in recs:
        assert r["collective_s"] == r["coll_bytes"] / LINK_BW > 0
        assert abs(r["fit_rel_diff"]["flops"]) <= 1e-3     # the fit checks the full count
    assert {r["chips"] for r in recs} == {4, 8}


def test_factorized_torus():
    recs = perf.exp_factorized_torus(LINK_BW, flat=SMALL, factorized=FACTORIZED, smoke=True)
    _check(recs, ["flat data=16 (1D ring)", "factorized 4x4 torus",
                  "factorized 4x4 hierarchical", "factorized flat ring (control)"])


def test_kimi_decode():
    recs = perf.exp_kimi_decode(LINK_BW, mesh=SMALL, smoke=True)
    _check(recs, ["baseline", "capacity 1.0"])
    assert recs[1]["coll_bytes"] <= recs[0]["coll_bytes"]     # fewer slots to move


def test_llama_decode():
    """The 2D-TP variant replicates the token batch over ``data`` and keeps
    the cache batch-sharded: no collective moves a cache layer's shard, and
    it moves fewer bytes than the baseline's FSDP weight gathers."""
    recs = perf.exp_llama_decode(LINK_BW, mesh=SMALL, smoke=True)
    _check(recs, ["baseline fsdp+batch-sharded", "2D-TP weight-stationary"])
    assert recs[1]["coll_bytes"] < recs[0]["coll_bytes"]


def test_wire_bytes_need_a_fabric():
    with pytest.raises(ValueError, match="--link-bw"):
        perf.exp_kimi_decode(None, mesh=SMALL, smoke=True)
    with pytest.raises(SystemExit):
        perf.main(["--exp", "nope"])


def test_card_step_needs_no_fabric():
    """One rank moves no wire bytes: the card step's record needs no
    fabric, and counts the flash kernels' bytes as a share of its own."""
    rec = perf.card_step("qwen3-1.7b", 2, 64, smoke=True)
    assert rec["coll_bytes"] == 0 and rec["collective_s"] == 0 and rec["chips"] == 1
    assert rec["link_bw"] is None and rec["flops"] > 0
    assert 0 < rec["attention_bytes_share"] < 1
    assert rec["argument_gib"] > 0 and rec["dominant"] in ("compute_s", "memory_s")


def test_main_lists_and_saves(tmp_path, capsys):
    perf.main(["--list"])
    assert capsys.readouterr().out.split() == list(perf.EXPERIMENTS)
    path = perf.save("kimi_decode", perf.exp_kimi_decode(LINK_BW, mesh=SMALL, smoke=True),
                     str(tmp_path))
    assert path == str(tmp_path / "kimi_decode.json") and "capacity 1.0" in capsys.readouterr().out
