"""``engine.read_chunk_ms``: the engine's time a read chunk in the
window: the read ops' ``busy_s`` (the chunk's staging copy, replay and
sync, on the host's clock) over their chunks."""


def read(ctx: dict):
    c = ctx["counters"]
    if c["read_chunks"] == 0:
        return None
    return c["read_busy_s"] / c["read_chunks"] * 1e3
