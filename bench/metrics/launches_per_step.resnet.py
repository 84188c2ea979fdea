"""Device operations (kernels, copies, fills) a step in the traced window."""


def read(t):
    if not t.trace.ops:
        return None
    return t.trace.launches_per_step()
