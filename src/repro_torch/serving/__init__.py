from repro_torch.serving.bst_server import WRITE_OPS, BSTServer, OpStats, ServerStats
from repro_torch.serving.serve_loop import (
    decode_graph,
    greedy_generate,
    make_prefill_fn,
    make_serve_step,
)

__all__ = [
    "BSTServer",
    "OpStats",
    "ServerStats",
    "WRITE_OPS",
    "decode_graph",
    "greedy_generate",
    "make_prefill_fn",
    "make_serve_step",
]
