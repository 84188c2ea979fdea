"""Show that the flash backward's card check catches faults planted in the kernel.

    PYTHONPATH=src python3 -m repro_torch.launch.check_bwd_faults [--out FILE]

For the unchanged source and for each fault of ``FAULTS``, it copies
``src/repro_torch`` into a temporary directory, plants the fault in the
copy's ``csrc/flash_attn_bwd.cu`` and ``csrc/flash_attn_bwd_f32.cu`` (text
substitutions, each of which must match as often as the fault says),
builds the copy's kernels there (all copies at once, one ``nvcc`` a
source), and runs the backward's card check
(``profile_flash.check_flash_bwd`` at ``profile_flash.BWD_CHECKS`` in bf16
and fp32, which ``chip_smoke.py`` runs) on the copy in a child process. The
checkout itself is left as it is. A fault is caught in a dtype when some
case's worst err/tol or norm err/limit passes 1. Prints one JSON line a
source and dtype and the card's name and power limit; ``--out`` writes them
as one JSON file. Exits 1 unless the unchanged source passes and every
fault is caught in both dtypes. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]   # src/repro_torch
BF16, F32 = "flash_attn_bwd.cu", "flash_attn_bwd_f32.cu"   # in csrc/
_DS = (r"float ds = p \* \((dp\[\w+\](?:\[\w+\])?) - (?:sD\[il\]|dl)\);",
       r"float ds = p * \1;")
_CAP = (r"if \(kSoftcap\) ds \*= 1\.f - th \* th;", "")
# name: (what it breaks, [(file, pattern, replacement, matches)]); every kernel
# pair of the backward gets the fault: bf16 on wgmma (every D, csrc/
# flash_attn_bwd.cu), fp32 in 3xTF32 on wgmma (D 32-128) and fp32 on FMAs
# (D 256), both in csrc/flash_attn_bwd_f32.cu
FAULTS = {
    "no_delta": ("dS = P dP, without D_i = dO_i . o_i",
                 [(BF16, *_DS, 2), (F32, *_DS, 3)]),
    "no_softcap_factor": ("dS without its factor 1 - tanh^2(s / softcap)",
                          [(BF16, *_CAP, 2), (F32, *_CAP, 3)]),
    "dq_skips_key_tile": ("dQ leaves out the second key tile a row visits", [
        (BF16, r"kk < BN / 16(; \+\+kk\)\s+wgmma_bf16_rs<DH>\(acc,)",
         r"kk < (kb == kb0 + 1 ? 0 : BN / 16)\1", 1),
        (F32, r"(const int k0 = kt \* kBT;)", r"\1\n    if (kt == kt0 + 1) continue;", 1),
        (F32, r"(acc\[i\] \+= )(xq\[i\]);", r"\1kb == kb0 + 1 ? 0.f : \2;", 1)]),
    "dkdv_skips_key_tile": ("dK and dV of key tile 1 stay zero", [
        (BF16, r"const int n = G \* nq;", "const int n = (blockIdx.y == 1 ? 0 : G) * nq;", 1),
        (F32, r"const int n = G \* nq;", "const int n = (blockIdx.y == 1 ? 0 : G) * nq;", 1),
        (F32, r"for \(int g = 0; g < G; \+\+g\)",
         "for (int g = 0; g < (blockIdx.y == 1 ? 0 : G); ++g)", 1)]),
    "dkdv_one_head": ("GQA: dK and dV sum only the first query head of a group", [
        (BF16, r"const int n = G \* nq;", "const int n = 1 * nq;", 1),
        (F32, r"const int n = G \* nq;", "const int n = 1 * nq;", 1),
        (F32, r"for \(int g = 0; g < G; \+\+g\)", "for (int g = 0; g < 1; ++g)", 1)]),
}


def sources(pkg: Path = PKG) -> dict[str, str]:
    """The backward's kernel sources under ``pkg/csrc``, by file name."""
    return {name: (pkg / "csrc" / name).read_text() for name in (BF16, F32)}


def plant(srcs: dict[str, str], subs) -> dict[str, str]:
    """``srcs`` (file name: text) with each substitution made in its file,
    which must match as often as given."""
    out = dict(srcs)
    for name, pattern, repl, count in subs:
        out[name], n = re.subn(pattern, repl, out[name])
        if n != count:
            raise ValueError(f"fault pattern {pattern!r} matched {n} times in {name}, "
                             f"not {count}")
    return out


def copy_with(root: Path, subs) -> Path:
    """``src/repro_torch`` copied under ``root/src`` with ``subs`` planted in
    its backward kernels; its kernels build into ``root/build``."""
    dst = root / "src" / "repro_torch"
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for name, text in plant(sources(dst), subs).items():
        (dst / "csrc" / name).write_text(text)
    return root / "src"


def check() -> int:
    """The child: the card check of the package on ``sys.path``, one JSON line a dtype."""
    import torch

    from repro_torch.launch import profile_flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        rows = [profile_flash.check_flash_bwd(shape, masks, mag, dtype, gen)
                for shape, masks, mag, _ in profile_flash.BWD_CHECKS]
        print(json.dumps({
            "dtype": str(dtype)[6:],
            "worst_err_over_tol": max(r["worst_err_over_tol"] for r in rows),
            "worst_norm_over_limit": max(r["worst_norm_over_limit"] for r in rows),
            "cases": [{k: r[k] for k in ("at", "worst_err_over_tol", "worst_norm_over_limit")}
                      for r in rows]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.check:
        return check()
    import torch

    if not torch.cuda.is_available():
        print("check_bwd_faults: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.profile_step import gpu_line

    card = gpu_line()
    result, ok = {"gpu": card, "sources": []}, True
    with tempfile.TemporaryDirectory() as tmp:
        trees = {name: copy_with(Path(tmp) / name, subs)
                 for name, (_, subs) in [("unchanged", ("", [])), *FAULTS.items()]}
        build = "from repro_torch.kernels import build; build.library()"
        procs = {name: subprocess.Popen([sys.executable, "-c", build], cwd=tmp,
                                        env={**os.environ, "PYTHONPATH": str(src)},
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                 for name, src in trees.items()}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                print(out[-4000:], file=sys.stderr)
                raise SystemExit(f"check_bwd_faults: the {name} source did not build")
        for name, src in trees.items():
            run = subprocess.run([sys.executable, "-m", "repro_torch.launch.check_bwd_faults",
                                  "--check"], cwd=tmp, capture_output=True, text=True,
                                 env={**os.environ, "PYTHONPATH": str(src)})
            if run.returncode != 0:
                print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"check_bwd_faults: the check of {name} did not run")
            for line in run.stdout.splitlines():
                row = json.loads(line)
                worst = max(row["worst_err_over_tol"], row["worst_norm_over_limit"])
                row = {"source": name, "fault": FAULTS[name][0] if name in FAULTS else None,
                       "caught": worst > 1, **row}
                ok &= row["caught"] == (name != "unchanged")
                result["sources"].append(row)
                print(json.dumps(row))
    result["ok"] = ok
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
