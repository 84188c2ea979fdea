"""The share of the traced window in which no device operation ran on rank
0's card (1 - the union of their intervals over the window), in %."""


def read(t):
    if not t.trace.ops:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.window_s)
