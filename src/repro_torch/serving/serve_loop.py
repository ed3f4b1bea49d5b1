"""Serving: prefill and greedy decode steps on one card.

``make_serve_step`` and ``make_prefill_fn`` return the per-request units of
the JAX package's serve loop; PyTorch runs them eagerly, so they bind the
config and nothing is compiled.  A ``mesh`` (sharded serving) raises
``NotImplementedError``: it is still to port (ROADMAP.md Queue 1 item 9).
``greedy_generate`` is the batched greedy decoding driver.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _single_card(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded LM serving (a mesh) is not ported yet (ROADMAP.md Queue 1 item 9)"
        )


def make_serve_step(cfg: ModelConfig, mesh: Any = None) -> Callable:
    """(model, tokens (B, 1), DecodeState) -> (logits (B, V), DecodeState);
    the state's caches are updated in place."""
    _single_card(mesh)
    return functools.partial(M.decode_step, cfg)


def make_prefill_fn(cfg: ModelConfig, mesh: Any = None, max_len: Optional[int] = None) -> Callable:
    """(model, tokens (B, S)) -> (last-position logits (B, V), DecodeState)."""
    _single_card(mesh)
    return functools.partial(M.prefill, cfg, max_len=max_len)


def greedy_generate(
    cfg: ModelConfig, model: M.Model, prompt_tokens: torch.Tensor, n_new: int
) -> torch.Tensor:
    """(B, S) prompts -> (B, n_new) greedy tokens: the prefill's argmax, then
    one decode step per further token.  (The JAX driver runs one more decode
    step after the last token and discards its logits; the tokens are the
    same.)"""
    B, S = prompt_tokens.shape
    logits, state = make_prefill_fn(cfg, max_len=S + n_new)(model, prompt_tokens)
    step = make_serve_step(cfg)
    tok = logits.argmax(dim=-1, keepdim=True)
    outs = [tok]
    for _ in range(n_new - 1):
        logits, state = step(model, tok, state)
        tok = logits.argmax(dim=-1, keepdim=True)
        outs.append(tok)
    return torch.cat(outs, dim=1)
