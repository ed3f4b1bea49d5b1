"""``device.idle_pct``: the share of the traced segment in which no
kernel, copy or memset ran on the card.  The profiler slows the host (the
result line's ``rounds_per_s`` gives the traced segment's pace beside the
untraced window's), so on a host-paced cell this reads above the window's
own idle share.  Nothing where the trace lost events."""


def read(ctx: dict):
    t = ctx["trace"]
    if t is None or not t["complete"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
