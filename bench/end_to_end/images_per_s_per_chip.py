"""All the images that all the ranks trained in the window, over the
window's seconds, over the chips."""


def read(w):
    if w.kind != "images":
        return None
    return w.steps * w.items_per_step / w.window_s / w.chips
