"""Megapixels the cell's stage delivered to the host inside the window, over
the window's seconds. For SR a pixel is one output position of all bands
together (a tile of h x w LR pixels delivers h*f x w*f)."""


def read(run):
    if "mpix" not in run.counts or not run.window_s:
        return None
    return run.counts["mpix"] / run.window_s
