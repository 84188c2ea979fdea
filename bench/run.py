"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one run
of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's chips. It trains
the cell's configuration through the port's ``Trainer.run`` for a window of
``--seconds``, checks the first steps against the plain reference
(``bench/reference``), and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics from a profiled window),
``device`` and, traced, ``breakdown``; ``checks`` last, each compared
number beside its limit, which also end standard error. Everything the run
builds or caches stays under ``build/`` in the checkout. It exits non-zero
and prints no result without the chips, without the port, or if the
process loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def _err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CACHE / sub)
    # one host thread for the operators of each process (the ranks inherit
    # it): the dispatch thread is what the cells time, and the set-up takes
    # half as long without the pool (8.6-9.7 s against 15.3-18.6 s for
    # ResNet-50 at 32 images a step, H100 host, 8 cores)
    os.environ["OMP_NUM_THREADS"] = "1"
    if not (ROOT / "src" / "repro_torch").is_dir():
        _err(f"bench: the port is not in this checkout ({ROOT / 'src' / 'repro_torch'})")
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.harness import runner, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _err(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    from repro_torch.kernels import build
    build.library()     # the first run in a checkout builds it, before any rank starts
    opts = runner.Options(cell=args.workload, seeds=(args.seed,), seconds=args.seconds,
                          trace=bool(args.trace))
    r = runner.run(opts, T0, log=_err)[0]
    found = runner.forbidden_modules()
    if found:
        _err(f"bench: the process loaded {found}")
        return 3
    line, checks = runner.result(cell, r, opts, torch.cuda.get_device_name(0))
    _err(f"losses: program {r['program_loss']}, reference {r['reference_loss']}; "
         f"{len(r['excluded'])} leaves left out of the change")
    for name, value, limit in checks:
        _err(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
