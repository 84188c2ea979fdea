"""Set-up: from the start of the process to the window's start (the process
group, the kernel library loaded or built, weights and batches from the
seed, the checked first steps and the warm-up)."""


def read(w):
    return w.setup_s
