"""Device ms a step outside matmuls, NCCL and the port's own kernels (LARS,
the loss, flash attention): the norms, RoPE, the SwiGLU, casts, the
embedding's gather and scatter, the guard's checks."""

from bench.harness import classes


def read(t):
    if not t.trace.ops:
        return None
    return t.trace.ms_per_step(exclude=(classes.MATMUL, classes.NCCL) + classes.PORT)
