"""repro_torch.analysis: the port's gates -- hot-path lint, contracts, dead
code and the steady-state serve gate (the JAX package's DESIGN.md §10).

The counterpart of ``repro.analysis``, behind one CLI
(``python -m repro_torch.analysis``):

  * ``lint``      -- AST rules for the PyTorch footguns that cost the
                     serving path: control flow and host pulls on tensors
                     (implicit syncs on the card), host ops inside a step
                     the engine captures as a CUDA graph, capture hazards,
                     and an explicit-sync allowlist budget;
  * ``contracts`` -- shape/dtype/layout contracts on ``SearchPlan``, the
                     query outputs, the delta operands and the sharded
                     builders, checked on ``meta`` tensors where the
                     function is shape-only and on tiny tensors elsewhere;
  * ``deadcode``  -- modules no executable root imports;
  * ``runtime``/``gate`` -- the counted transfers, the capture and sync
                     watches, and a real ``BSTServer`` drain per strategy
                     that captures nothing and moves nothing it did not
                     plan to move.

``invariants`` is the pure leaf both the checks and the production code
import.  This ``__init__`` stays import-light on purpose: ``core``,
``kernels`` and ``serving`` import ``invariants`` and ``runtime``, and
importing anything heavier here would close a cycle.
"""
