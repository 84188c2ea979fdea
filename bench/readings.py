"""The readings that the limits of the comparison (``harness/compare.py``)
are set from, on the chip at each cell's own sizes; the benchmark's own runs
never make them.

    python3 bench/readings.py --cell <cell> --mode program --seeds 1,2,3 [--fault F]
    python3 bench/readings.py --cell <cell> --mode control --seeds 1,2,3

``program``: the program's set-up and checked first steps on each seed, and
the reference after them, in one process (the lower readings; with
``--fault``, a fault of ``harness/faults.py`` planted in the program).
``control``: the reference in float32 against the reference with its matrix
operands in fp8 (``reference/fp8.py``) put in the program's place, on one
card (the upper readings). ``witness``: the same with them in bf16, the
configurations' own precision: what rounding alone reads, beside the
program. Each seed's numbers print as a JSON line; with
``--out`` they are also written there.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def control(cell, seed: int, device, rounding=None) -> dict:
    """The control's numbers on ``seed``: the reference with ``rounding`` of
    its matrix operands (default fp8) judged against the float32 one, as the
    program is."""
    import torch

    from bench.harness import compare, data, spec
    from bench.reference import fp8
    from bench.reference import train as ref_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell.config, cell.traffic
    mod = ref_train.model(config)
    gb = traffic["per_rank_batch"] * cell.chips
    pool = spec.traffic(traffic["kind"]).pool(cell, seed, device, gb)[:traffic["check_steps"]]
    shapes = mod.param_shapes(config)

    def steps(q):
        return ref_train.train(config, data.weights(shapes, mod.init_rule, seed, device), pool,
                               epoch=0.0, global_batch=gb, q=q,
                               first_update="update_diff_median" in traffic["limits"])

    ref = steps(None)
    low = steps(rounding or fp8.q)
    low = {**low, "grad_norms": low["grad_norms"][0]}
    return {"seed": seed, "numbers": compare.numbers(low, ref),
            "loss": low["loss"], "reference_loss": ref["loss"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--mode", choices=("program", "control", "witness"), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import runner

    seeds = tuple(int(s) for s in args.seeds.split(","))
    opts = runner.Options(cell=args.cell, seeds=seeds, seconds=0.0, fault=args.fault,
                          window=False)
    rows = []
    if args.mode == "program":
        for r in runner.run(opts, T0, log=lambda s: print(s, file=sys.stderr)):
            rows.append({"seed": r["seed"], "numbers": r["numbers"],
                         "loss": r["program_loss"], "reference_loss": r["reference_loss"],
                         "excluded": len(r["excluded"])})
            print(json.dumps(rows[-1]), flush=True)
    else:
        cell = runner.load_cell(opts)
        dev = torch.device("cuda", 0)
        from bench.reference import fp8
        rounding = fp8.bf16 if args.mode == "witness" else fp8.q
        for seed in seeds:
            rows.append(control(cell, seed, dev, rounding))
            print(json.dumps(rows[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"cell": args.cell, "mode": args.mode,
                                        "fault": args.fault, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
