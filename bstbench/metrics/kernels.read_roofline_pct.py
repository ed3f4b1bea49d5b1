"""``kernels.read_roofline_pct``: the read chunks' share of the HBM
roofline in the traced segment: the bytes ``work.py`` counts for the
chunks' queries (the plain search's nodes and buffer slots) at the card's
peak bandwidth, over the device time of the kernels that those chunks'
calls launched, joined to them through the trace.  Nothing where the
trace lost events or saw no read chunk."""

from bstbench import peaks


def read(ctx: dict):
    t = ctx["trace"]
    if t is None or not t["complete"]:
        return None
    kernel_s = t["span_kernel_s"].get("engine.query_static", [])
    if len(kernel_s) != len(t["chunk_bytes"]) or sum(kernel_s) <= 0:
        return None
    return 100.0 * sum(t["chunk_bytes"]) / peaks.HBM_BYTES_PER_S / sum(kernel_s)
