"""Device operations by class, from their names: the benchmark's own copy of
the program's tables (``launch/profile_step.py:CLASSES`` and
``launch/profile_train_lm.py:CLASSES``, merged), plus NCCL, so that a change
of the program cannot move what a per-layer metric counts. First match
wins; a name that matches nothing is ``other``."""

from __future__ import annotations

NCCL = "nccl"
LARS = "port: lars_update"
XENT = "port: ls_xent"
FLASH = "port: flash_attn"
MATMUL = "convolution / matmul"
PORT = (LARS, XENT, FLASH)

CLASSES = (
    (NCCL, ("nccl",)),
    (LARS, ("lars_norms_kernel", "lars_apply_kernel")),
    (XENT, ("ls_xent_",)),
    (FLASH, ("flash_tc_kernel", "flash_fwd_kernel", "flash_f32_kernel", "bwd_prep_kernel",
             "bwd_prep_f32_kernel", "dkdv_kernel", "dkdv_tc_kernel", "dkdv_wg_kernel",
             "dkdv_tf32_kernel", "dq_kernel", "dq_tc_kernel", "dq_wg_kernel", "dq_tf32_kernel",
             "dot_kernel")),
    (MATMUL, ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "implicit", "sm90_",
              "cudnn", "nhwc", "nchw", "nvjet", "matmul")),
    ("sort / scan", ("radix", "sort", "scan")),
    ("reduction", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "copy", "fill", "cat",
                     "index", "gather", "scatter", "pool", "max_pool", "memcpy", "memset")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, frags in CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"
