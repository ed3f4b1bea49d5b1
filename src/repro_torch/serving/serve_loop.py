"""Serving: prefill and greedy decode steps on one card.

``make_serve_step`` and ``make_prefill_fn`` return the per-request units of
the JAX package's serve loop, which jits the decode step and donates its
state.  On a CUDA device the port's decode step is one CUDA graph
(``repro_torch.graphs``) per (config, model, batch, cache length, memory
length), captured at first use and replayed at every step: the graph owns
its decode state (every cache of the family -- KV ring, SSM conv tails and
states, the encdec cross memory -- and the position) and its static tokens
and logits, and the prefill writes its caches into that state.  Prefill
itself runs eagerly: it is bound by its device work, not by launches.  On
the CPU both run eagerly, and ``eager=True`` asks for the eager route on
the card too, to hold the graph against it.  A ``mesh`` (sharded serving)
raises ``NotImplementedError``: it is still to port (ROADMAP.md Queue 1
item 9).  ``greedy_generate`` is the batched greedy decoding loop.  The
families with a frontend (encdec, vlm) take its stub embeddings beside the
tokens, as the JAX package's serve loop does.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import graphs
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _single_card(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded LM serving (a mesh) is not ported yet (ROADMAP.md Queue 1 item 9)"
        )


def _addresses(model: M.Model) -> Tuple[int, ...]:
    """The addresses of ``model``'s parameters and buffers: what a decode
    graph reads its weights from."""
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))


class DecodeGraph:
    """The decode step of one (config, batch, cache length, memory length)
    on ``model`` as one CUDA graph, with the state it owns: ``state``
    (caches and position), the (B, 1) ``tokens`` it reads and the (B, V)
    logits it writes.  ``memory_len`` is the encdec cross memory's length,
    the encoder's (None for the other families): the memory is never
    padded, so each length has its graph.  Its warm-up step moves the
    position; a prefill into ``state`` sets it before the first replay.  It
    holds no reference to the model, only the addresses of its parameters
    and buffers at the capture (``addresses``): a graph whose model holds
    tensors at other addresses since (a parameter re-bound,
    ``model.to(...)``) is stale, and is never replayed."""

    def __init__(self, cfg: ModelConfig, model: M.Model, batch: int, max_len: int,
                 memory_len: Optional[int] = None):
        device = model.embed.device
        self.cfg = cfg
        self.state = M.make_decode_state(cfg, batch, max_len, device, memory_len)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64, device=device)
        self.addresses = _addresses(model)
        with torch.cuda.device(device):
            self.graph = graphs.Graph(
                lambda: M.decode_step(cfg, model, self.tokens, self.state)[0],
                label=("decode", batch, max_len, memory_len),
            )

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens)
        return self.graph.replay()


# Per model (held weakly: a model's graphs go with it), its decode graphs by
# (config, batch, max_len, memory_len).
_GRAPHS: "weakref.WeakKeyDictionary[M.Model, Dict[Tuple, DecodeGraph]]" = (
    weakref.WeakKeyDictionary()
)


def decode_graph(cfg: ModelConfig, model: M.Model, batch: int, max_len: int,
                 memory_len: Optional[int] = None) -> DecodeGraph:
    """``model``'s decode graph for (cfg, batch, max_len, memory_len),
    captured at the first call and returned as it is by every later one
    while the model holds its parameters at the same addresses; otherwise
    captured anew over the current ones, as the JAX step takes ``params``
    at every call."""
    per_model = _GRAPHS.setdefault(model, {})
    key = (cfg, batch, max_len, memory_len)
    g = per_model.get(key)
    if g is None or g.addresses != _addresses(model):
        per_model[key] = g = DecodeGraph(cfg, model, batch, max_len, memory_len)
    return g


def _graph_of(cfg: ModelConfig, model: M.Model, state: M.DecodeState) -> DecodeGraph:
    """The graph that owns ``state``: the one whose state has its position
    tensor (every family's state has one)."""
    for g in _GRAPHS.get(model, {}).values():
        if g.cfg == cfg and g.state.position is state.position:
            if g.addresses != _addresses(model):
                raise ValueError(
                    "the decode graph of this state was captured over parameters the "
                    "model no longer holds (re-bound or moved since): prefill again"
                )
            return g
    raise ValueError(
        "the graphed decode step runs on the state of its own graph: prefill "
        "through make_prefill_fn (or M.prefill(..., out=decode_graph(...).state))"
    )


def _eager(eager: bool, tokens: torch.Tensor) -> bool:
    return eager or tokens.device.type != "cuda"


def make_serve_step(cfg: ModelConfig, mesh: Any = None, *, eager: bool = False) -> Callable:
    """(model, tokens (B, 1), DecodeState) -> (logits (B, V), DecodeState);
    the state's caches and position advance in place.  On a CUDA device
    (unless ``eager``) the step is one replay of the state's decode graph,
    so the state must be the one its prefill wrote (``make_prefill_fn``),
    and the logits are the graph's static buffer: valid until the next
    step of that graph, as a donated buffer is (clone them to keep them)."""
    _single_card(mesh)

    def step(model, tokens, state):
        if _eager(eager, tokens):
            return M.decode_step(cfg, model, tokens, state)
        graph = _graph_of(cfg, model, state)
        return graph(tokens), graph.state

    return step


def make_prefill_fn(
    cfg: ModelConfig, mesh: Any = None, max_len: Optional[int] = None, *, eager: bool = False
) -> Callable:
    """(model, tokens (B, S)[, frontend_embeds]) -> (last-position logits
    (B, V), DecodeState): the frontend's embeddings are the third argument
    where ``cfg.frontend`` is set (encdec: the encoder's frames (B, Smem,
    D); vlm: the patch embeddings (B, flen, D)), as in the JAX package.  On
    a CUDA device (unless ``eager``) the caches are written into the state
    of the decode graph for (B, ``max_len``, Smem), captured at the first
    such prefill; a later request of that shape overwrites them."""
    _single_card(mesh)

    def run(model, tokens, frontend_embeds=None):
        if _eager(eager, tokens):
            return M.prefill(cfg, model, tokens, frontend_embeds, max_len=max_len)
        B, S = tokens.shape
        memory_len = frontend_embeds.shape[1] if cfg.family == "encdec" else None
        out = decode_graph(cfg, model, B, max_len or S, memory_len).state
        return M.prefill(cfg, model, tokens, frontend_embeds, max_len=max_len, out=out)

    if cfg.frontend is not None:
        def prefill(model, tokens, frontend_embeds):
            return run(model, tokens, frontend_embeds)
    else:
        def prefill(model, tokens):
            return run(model, tokens)

    return prefill


def greedy_generate(
    cfg: ModelConfig,
    model: M.Model,
    prompt_tokens: torch.Tensor,
    n_new: int,
    frontend_embeds: Optional[torch.Tensor] = None,
    *,
    eager: bool = False,
) -> torch.Tensor:
    """(B, S) prompts -> (B, n_new) greedy tokens: the prefill's argmax, then
    one decode step per further token, through the graphed step on a CUDA
    device unless ``eager``.  ``frontend_embeds`` go to the prefill where
    ``cfg.frontend`` is set.  (The JAX loop runs one more decode step
    after the last token and discards its logits; the tokens are the
    same.)"""
    B, S = prompt_tokens.shape
    prefill = make_prefill_fn(cfg, max_len=S + n_new, eager=eager)
    frontend = () if cfg.frontend is None else (frontend_embeds,)
    logits, state = prefill(model, prompt_tokens, *frontend)
    step = make_serve_step(cfg, eager=eager)
    tok = logits.argmax(dim=-1, keepdim=True)
    outs = [tok]
    for _ in range(n_new - 1):
        logits, state = step(model, tok, state)
        tok = logits.argmax(dim=-1, keepdim=True)
        outs.append(tok)
    return torch.cat(outs, dim=1)
