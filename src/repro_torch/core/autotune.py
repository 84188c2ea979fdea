"""Bucket-size autotuning for the bucketed gradient exchange
(``repro/core/autotune.py``, pure math, ported as it is).

``GradSyncConfig.bucket_bytes`` trades latency against overlap: too-large
buckets leave comm exposed after backprop ends, too-small buckets pay the
per-exchange alpha cost ``steps * latency`` once per bucket. Three layers:

1. :func:`analytic_knee_bytes` -- the closed-form serial-efficiency knee of
   ``collectives.comm_cost_model``: the bucket size where one bucket's wire
   time equals its latency term,

       knee = steps * latency * link_bw / wire_bytes_per_payload_byte

   Needs no knowledge of the model; the fallback when the gradient size is
   unknown.

2. :func:`recommend_bucket_bytes` -- evaluate
   ``collectives.bucketed_comm_cost_model`` over a geometric candidate grid
   around the knee (plus the fused baseline ``0``) and take the candidate
   with the fewest exchanges whose ``exposed_seconds`` is within ``slack``
   of the optimum.

3. :func:`refine_from_sweep` -- refinement from sweep rows (one per swept
   ``bucket_bytes``, carrying cost-model seconds and/or measured times):
   the sweep's optimum *bracket* is the acceptance band, and an analytic
   pick outside it means the hardware model's constants are off.

``grad_sync.resolve_sync_config`` resolves ``bucket_bytes="auto"`` here,
after the strategy fallback chain, and only with an explicit
:class:`HardwareModel`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import collectives


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Alpha-beta constants of one fabric + the overlap window.

    ``backward_seconds`` is the wall time of the backward pass the bucketed
    exchange overlaps with -- the only model-dependent constant. It only
    shifts *where* overlap saturates, not the knee itself.

    There are no defaults: the JAX package's are a TPU pod's (50 GB/s ICI,
    1 us a step), and no H100 fabric has been measured for the port yet.
    """

    link_bw: float                 # bytes/s per link
    latency_s: float               # per ring-step latency (alpha)
    backward_seconds: float
    name: str


def analytic_knee_bytes(strategy: str, x: int, y: int,
                        hw: HardwareModel) -> int:
    """Closed-form knee: bucket size where wire time == latency term.

    Uses the strategy's own wire-volume ratio from ``comm_cost_model`` (a
    reference payload cancels out), so the formula specializes correctly
    for torus2d/hierarchical (``2(X-1)+2(Y-1)`` steps) vs the flat ring
    (``2(N-1)`` steps, hence a much larger knee).
    """
    ref = 1 << 20
    c = collectives.comm_cost_model(strategy, ref, x, y,
                                    hw.link_bw, hw.latency_s)
    wire_per_byte = c["wire_bytes"] / ref
    if wire_per_byte <= 0:       # degenerate 1x1 grid: no wire, no buckets
        return 0
    return max(1, int(c["steps"] * hw.latency_s * hw.link_bw
                      / wire_per_byte))


def candidate_bucket_bytes(knee: int, total_bytes: int | None = None,
                           span: int = 4) -> list[int]:
    """Geometric grid ``knee * 2**[-span..span]`` plus the fused baseline
    ``0``, clamped to ``total_bytes`` (a bucket larger than the gradient is
    the fused layout again)."""
    cands = {0}
    for k in range(-span, span + 1):
        b = int(knee * 2.0 ** k)
        if b <= 0:
            continue
        if total_bytes is not None and b >= total_bytes:
            continue
        cands.add(b)
    return sorted(cands)


def _evaluate(strategy: str, total_bytes: float, bucket_bytes: int,
              x: int, y: int, hw: HardwareModel) -> dict:
    m = collectives.bucketed_comm_cost_model(
        strategy, total_bytes, bucket_bytes, x, y,
        hw.link_bw, hw.latency_s, backward_seconds=hw.backward_seconds)
    return {"bucket_bytes": bucket_bytes,
            "num_buckets": m["num_buckets"],
            "exposed_seconds": m["exposed_seconds"],
            "serial_seconds": m["serial_seconds"]}


def recommend_bucket_bytes(strategy: str, x: int, y: int,
                           hw: HardwareModel,
                           total_bytes: float | None = None,
                           candidates: list[int] | None = None,
                           slack: float = 0.05) -> dict:
    """Pick ``bucket_bytes`` for one strategy/mesh/arch; returns the pick
    with the evidence attached.

    With ``total_bytes`` (the comm payload -- sum of ``bucket_layout``
    entry sizes) the pick minimizes the cost model's ``exposed_seconds``
    over ``candidates`` (default: a geometric grid around the analytic
    knee), tie-broken toward the fewest exchanges within ``slack`` relative
    exposure. Without it, the analytic knee alone is returned
    (``mode="analytic"``).
    """
    knee = analytic_knee_bytes(strategy, x, y, hw)
    base = {"strategy": strategy, "x": x, "y": y,
            "hw": dataclasses.asdict(hw),
            "analytic_knee_bytes": knee,
            "total_bytes": total_bytes}
    if total_bytes is None or total_bytes <= 0 or knee == 0:
        return {**base, "mode": "analytic", "bucket_bytes": knee,
                "candidates": []}

    cands = candidates if candidates is not None \
        else candidate_bucket_bytes(knee, int(total_bytes))
    if 0 not in cands:
        cands = [0] + list(cands)
    evaluated = [_evaluate(strategy, total_bytes, b, x, y, hw)
                 for b in sorted(set(int(b) for b in cands))]
    best = min(evaluated, key=lambda e: e["exposed_seconds"])
    feasible = [e for e in evaluated
                if e["exposed_seconds"]
                <= best["exposed_seconds"] * (1.0 + slack)]
    pick = min(feasible,
               key=lambda e: (e["num_buckets"], -e["bucket_bytes"]))
    fused = _evaluate(strategy, total_bytes, 0, x, y, hw)
    return {**base, "mode": "cost_model",
            "bucket_bytes": pick["bucket_bytes"],
            "num_buckets": pick["num_buckets"],
            "exposed_seconds": pick["exposed_seconds"],
            "best_exposed_seconds": best["exposed_seconds"],
            "fused_exposed_seconds": fused["exposed_seconds"],
            "candidates": evaluated}


# ---------------------------------------------------------------------------
# Empirical refinement from sweep artifacts
# ---------------------------------------------------------------------------

def sweep_bracket(rows: list[dict], key: str = "exposed_seconds") -> dict:
    """The measured optimum and its bracketing candidates.

    ``rows`` are sweep artifacts, one per swept ``bucket_bytes``, each
    carrying ``key``. Returns the best row's ``bucket_bytes`` plus the
    adjacent swept values ``low``/``high`` (``None`` = unbounded on that
    side): the band a cost-model pick must land in to be consistent with
    the sweep.
    """
    rows = sorted((r for r in rows if r.get(key) is not None),
                  key=lambda r: r["bucket_bytes"])
    if not rows:
        raise ValueError(f"no sweep rows carry {key!r}")
    i = min(range(len(rows)), key=lambda j: rows[j][key])
    return {
        "best_bucket_bytes": rows[i]["bucket_bytes"],
        "best_value": rows[i][key],
        "low": rows[i - 1]["bucket_bytes"] if i > 0 else None,
        "high": rows[i + 1]["bucket_bytes"] if i + 1 < len(rows) else None,
    }


def pick_within_bracket(bucket_bytes: int, bracket: dict) -> bool:
    """Is a pick inside the sweep's measured-optimum band (inclusive)?

    The fused sentinel ``0`` only matches a bracket that itself reaches
    down to the fused row.
    """
    lo, hi = bracket["low"], bracket["high"]
    if lo is not None and bucket_bytes < lo:
        return False
    if hi is not None and bucket_bytes > hi:
        return False
    return True


def refine_from_sweep(rows: list[dict], strategy: str, x: int, y: int,
                      hw: HardwareModel, total_bytes: float | None = None,
                      slack: float = 0.05) -> dict:
    """Combine sweep artifacts with the analytic model into a final pick.

    ``rows`` come from a bucket-size sweep: each has ``bucket_bytes`` plus
    whichever evidence the sweep produced -- ``exposed_seconds`` (cost
    model), ``num_exchanges`` (exchanges counted), ``us_per_call``
    (measured). The pick is
    the sweep row with the fewest exchanges within ``slack`` of the best
    exposed time; the analytic recommendation rides along with an
    ``agrees`` flag (pick inside the sweep's optimum bracket), so a
    disagreement -- stale hardware constants -- is visible in the artifact
    instead of silently shipped.
    """
    usable = [r for r in rows if r.get("exposed_seconds") is not None]
    bracket = sweep_bracket(usable)
    best = min(usable, key=lambda r: r["exposed_seconds"])
    feasible = [r for r in usable
                if r["exposed_seconds"]
                <= best["exposed_seconds"] * (1.0 + slack)]
    pick = min(feasible,
               key=lambda r: (r.get("num_exchanges",
                                    r.get("num_buckets", 1 << 30)),
                              -r["bucket_bytes"]))
    analytic = recommend_bucket_bytes(strategy, x, y, hw,
                                      total_bytes=total_bytes)
    return {
        "mode": "sweep",
        "bucket_bytes": pick["bucket_bytes"],
        "exposed_seconds": pick["exposed_seconds"],
        "bracket": bracket,
        "analytic": analytic,
        "agrees": pick_within_bracket(analytic["bucket_bytes"], bracket),
    }
