"""``server.host_ms_per_drain``: the host's own time in a ``drain()``, per
round of the window: the benchmark's span around each drain less the
server's ``busy_s`` (its synchronised chunk and write spans), over the
rounds.  What is left is the server's packing, fetch, column fill and
split."""


def read(ctx: dict):
    rounds = ctx["rounds"]
    if rounds == 0:
        return None
    return (ctx["drain_s"] - ctx["counters"]["busy_s"]) / rounds * 1e3
