"""The port's spans: ``span(name)`` marks a phase of the host's code on a
profiler's timeline.

While a profiler records (``torch.profiler.profile``), a span is a
``torch.profiler.record_function``, which lands on the same Kineto
timeline as the CUDA runtime's calls and the device's work, so a trace can
say which phase of the host's code the card waited on.  Otherwise it is
one shared no-op context: a span then costs one check of the profiler's
state, and records no event, allocates nothing, reads no clock and waits
for nothing.

The spans the port emits (the single-card serving path):

  * ``bst.server.pack``   -- ``BSTServer`` building engine batches from
    requests: a read span's grouping by op and its streams' concatenation,
    a stream's padding to whole chunks, a write span's concatenated
    columns;
  * ``bst.engine.stage``  -- ``BSTEngine`` turning a host batch into a
    step's static input: a read chunk's staging copy (``query_static``), a
    write slice's packing, padded to its rung of the ingest ladder, and
    its copy (``_ingest``);
  * ``bst.server.retire`` -- ``BSTServer`` turning fetched columns into
    answers: a read chunk's fetch into the stream's columns, its found
    count and counters; each read request's slice of them; each write
    request's acknowledgement.

No span encloses a call into the engine's ``query_static``, ``apply_ops``
or ``compact``, and graph replays and syncs run outside every span (the
runtime's call names the time they take).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a profiler records,
    else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
