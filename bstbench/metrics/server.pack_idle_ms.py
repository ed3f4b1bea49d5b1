"""``server.pack_idle_ms``: the card's idle time under the program's span
``bst.server.pack``, the server building engine batches from requests (a
read span's grouping and concatenation, a stream's padding, a write
span's packed columns), in ms per round of the traced segment
(``program_spans.idle_ms_per_round``)."""

from bstbench import program_spans


def read(ctx: dict):
    return program_spans.idle_ms_per_round(ctx, "bst.server.pack")
