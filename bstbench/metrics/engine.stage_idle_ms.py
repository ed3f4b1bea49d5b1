"""``engine.stage_idle_ms``: the card's idle time under the program's span
``bst.engine.stage``, the engine turning a host batch into a step's
static input (a read chunk's staging copy, a write slice's packing and
its copy), in ms per round of the traced segment
(``program_spans.idle_ms_per_round``)."""

from bstbench import program_spans


def read(ctx: dict):
    return program_spans.idle_ms_per_round(ctx, "bst.engine.stage")
