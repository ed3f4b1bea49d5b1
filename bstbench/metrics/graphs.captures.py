"""``graphs.captures``: CUDA graphs captured in the window
(``graphs.STATS["captures"]``).  Writes keep the tree's height, so a steady
window captures none."""


def read(ctx: dict):
    return ctx["counters"]["captures"]
