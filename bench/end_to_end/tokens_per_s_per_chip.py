"""All the tokens that all the ranks trained in the window, over the
window's seconds, over the chips."""


def read(w):
    if w.kind != "tokens":
        return None
    return w.steps * w.items_per_step / w.window_s / w.chips
