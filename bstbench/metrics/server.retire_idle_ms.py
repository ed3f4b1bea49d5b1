"""``server.retire_idle_ms``: the card's idle time under the program's span
``bst.server.retire``, the server turning fetched columns into answers
(a read chunk's fetch into the columns, its found count and counters,
each request's slice or acknowledgement), in ms per round of the traced
segment (``program_spans.idle_ms_per_round``)."""

from bstbench import program_spans


def read(ctx: dict):
    return program_spans.idle_ms_per_round(ctx, "bst.server.retire")
