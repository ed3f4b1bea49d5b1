"""The card's idle time under the program's own spans in a traced segment.

The program (``repro_torch.tracing``) names phases of its host code with
spans whose names start with ``bst.``; ``trace.summarize`` gives each idle
gap of the card to the CUDA call in flight at its middle, else to the
innermost span there, and lists the ``trace.TOP`` names with the most idle
time.  A program without such spans (an older one) lists none of them.
"""

PREFIX = "bst."


def idle_ms_per_round(ctx: dict, span: str):
    """The idle seconds the summary lists under ``span``, in ms per traced
    round; 0 where the program's spans are listed but ``span`` is not (it
    then held less idle time than the last name listed, none at all where
    the list is shorter than ``trace.TOP``).  Nothing where the trace lost
    events or lists none of the program's spans."""
    t = ctx["trace"]
    if t is None or not t["complete"]:
        return None
    idle = dict(t["idle_gaps"])
    if not any(name.startswith(PREFIX) for name in idle):
        return None
    return idle.get(span, 0.0) / ctx["mix"]["trace_rounds"] * 1e3
