"""``server.padding_pct``: the share of the engine lanes launched in the
window that carried no request: 1 - the server's ``lanes`` over the read
chunks times the chunk and the write chunks times the write chunk."""


def read(ctx: dict):
    c = ctx["counters"]
    launched = c["read_lanes_launched"] + c["write_lanes_launched"]
    if launched == 0:
        return None
    return 100.0 * (1.0 - c["lanes"] / launched)
