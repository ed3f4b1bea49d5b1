"""``engine.write_ms_per_kop``: the engine's write time in the window per
1,000 writes acknowledged: the write op's ``busy_s`` (ingest slices and
the compactions they set off, synchronised) over the writes."""


def read(ctx: dict):
    c = ctx["counters"]
    if c["writes"] == 0:
        return None
    return c["write_busy_s"] * 1e3 / (c["writes"] / 1e3)
