"""Build the CUDA kernels in ``csrc/`` and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper), and the objects are linked into one
shared library with a plain C interface. The library lands in ``build/``
at the root of the checkout, named by a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and an unchanged tree is loaded as it is.
Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# q, k, v, o, lse, B, H, Hkv, S, Skv, D, scale, causal, window, softcap, stream
_FLASH = (_P, _P, _P, _P, _P, *(ctypes.c_int,) * 6, ctypes.c_float, ctypes.c_int,
          ctypes.c_int, ctypes.c_float, _P)
# q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, Hkv, S, Skv, D, scale,
# causal, window, softcap, stream
_FLASH_BWD = (*(_P,) * 10, *(ctypes.c_int,) * 6, ctypes.c_float, ctypes.c_int,
              ctypes.c_int, ctypes.c_float, _P)
# C signature of each exported function: (argtypes), restype is int
# (a cudaError_t, 0 on success).
SIGNATURES = {
    "lars_table_check": (ctypes.c_longlong,),
    "lars_norms_f32": (_P, _P, _P, _P, ctypes.c_int, _P),
    "lars_apply_f32": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, _P),
    # ..., rows, vocab, smoothing, threads a row, stream
    "ls_xent_fwd": (_P, ctypes.c_int, _P, _P, _P, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_float, ctypes.c_int, _P),
    "ls_xent_bwd": (_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_float, ctypes.c_int, _P),
    "flash_attn_fwd": _FLASH,      # fp32, csrc/flash_attn.cu
    "flash_attn_tc_fwd": _FLASH,   # bf16 on the tensor cores, csrc/flash_attn_tc.cu
    "flash_attn_bwd": _FLASH_BWD,      # bf16, csrc/flash_attn_bwd.cu
    "flash_attn_bwd_f32": _FLASH_BWD,  # fp32, csrc/flash_attn_bwd_f32.cu
    # csrc/batchnorm.cu: x, dtype, shape (7 long longs), ..., stream
    "bn_fwd_stats": (_P, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_float, _P),
    "bn_fwd_apply": (_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                     ctypes.c_int, _P),
    "bn_bwd_sums": (_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                    ctypes.c_int, _P, _P, _P, _P, _P),
    "bn_bwd_dx": (_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                  ctypes.c_float, ctypes.c_int, _P, _P, _P),
    # csrc/guard.cu
    "guard_table_check": (ctypes.c_longlong, ctypes.c_longlong),
    "guard_unscale_count": (_P, _P, _P, ctypes.c_int, _P),
    # table, finite, blocks, grid, stream
    "guard_commit": (_P, _P, ctypes.c_int, ctypes.c_int, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""   # nvcc's output (ptxas register and spill counts) of the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    return srcs


def library_path() -> Path:
    """The library's path, named by a hash of the flags and of every source
    and header in ``csrc/`` (a header's edit rebuilds its includers)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_log
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(tmp_so), *(str(o) for _, o, _ in procs)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, out)   # atomic: a concurrent loader sees all or nothing
    build_log = "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
