"""Training step and loop: microbatch accumulation, AdamW, the host loop.

The port of the JAX package's ``training/train_loop.py`` for one device:
the step runs ``forward_train``, autograd's backward, the global-norm clip,
the cosine schedule and AdamW on fp32 masters, and writes the updated
parameters back into the model in its compute dtype.  The same metrics as
the JAX step: ``loss``, ``moe_dropped``, ``grad_norm`` and ``lr``, each a
device tensor (the step reads nothing on the host).  Microbatches split the
batch along its first dimension: the fp32 gradients are summed divided by
the count, the loss averaged, and the metrics are the last microbatch's.

Where the JAX step returns a new state (and donates the old one), this one
updates the model's parameters and the optimizer state in place and
returns the state it was given.  Gradient compression ("bf16", "int8")
belongs to the data-parallel all-reduce, which one device does not run: the
step ignores it, as the JAX package's single-device ``step_plain`` does,
and for "int8" the state still holds the error-feedback zeros.  The mesh
step (data-parallel with the compressed all-reduce, or sharded parameters)
is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1  # grad accumulation factor
    compression: Optional[str] = None  # None | "bf16" | "int8"
    b1: float = 0.9
    b2: float = 0.95


class TrainState(NamedTuple):
    params: M.Model  # trainable, in the config's compute dtype
    opt: opt.AdamWState
    error_feedback: List[torch.Tensor]  # int8 compression residuals (or empty)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                     device="cuda") -> TrainState:
    """A trainable model from ``seed`` (``init_params``), its AdamW state,
    and for int8 compression the error-feedback zeros."""
    model = M.init_params(cfg, seed=seed, device=device, trainable=True)
    params = list(model.parameters())
    ef = []
    if tcfg.compression == "int8":
        ef = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    return TrainState(params=model, opt=opt.adamw_init(params), error_feedback=ef)


StepFn = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh: Any = None) -> StepFn:
    """``step(state, tokens, labels, frontend=None) -> (state, metrics)`` on
    the state's device; tokens and labels (B, S) integer tensors, frontend
    the stub embeddings ``forward_train`` takes (encdec, vlm)."""
    if mesh is not None:
        raise NotImplementedError(
            "the mesh train step (data parallelism with the compressed all-reduce, sharded "
            "parameters) is not ported yet (ROADMAP.md Queue 1 items 9 and 13e)"
        )

    def grads_of(model: M.Model, tokens, labels, frontend):
        """One forward and backward: (loss, metrics, the parameters' grads)."""
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss, metrics = M.forward_train(cfg, model, tokens, labels, frontend)
        loss.backward()
        missing = [name for name, p in model.named_parameters() if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        return loss.detach(), metrics, [p.grad for p in params]

    def accumulate(model: M.Model, tokens, labels, frontend):
        mb = tcfg.microbatches
        if mb == 1:
            return grads_of(model, tokens, labels, frontend)
        Bl = tokens.shape[0]
        if Bl % mb:
            raise ValueError(f"a batch of {Bl} does not split into {mb} microbatches")
        n = Bl // mb
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in model.parameters()]
        acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(mb):
            rows = slice(i * n, (i + 1) * n)
            loss, metrics, grads = grads_of(model, tokens[rows], labels[rows],
                                            None if frontend is None else frontend[rows])
            for a, g in zip(acc, grads):
                a.add_(g.float() / mb)
            acc_loss = acc_loss + loss / mb
        return acc_loss, metrics, acc

    def step(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor,
             frontend: Optional[torch.Tensor] = None):
        model = state.params
        loss, metrics, grads = accumulate(model, tokens, labels, frontend)
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.clip_norm)
        for p in model.parameters():  # the raw grads go before the update's temporaries
            p.grad = None
        lr = opt.cosine_schedule(state.opt.step, tcfg.peak_lr, tcfg.warmup_steps,
                                 tcfg.total_steps)
        params, opt_state = opt.adamw_update(
            grads, state.opt, lr, b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
            compute_dtype=cfg.param_dtype,
        )
        del grads
        with torch.no_grad():
            for p, new in zip(model.parameters(), params):
                p.copy_(new)
        metrics = {"moe_dropped": metrics["moe_dropped"].detach(), "loss": loss,
                   "grad_norm": gnorm, "lr": lr}
        return TrainState(model, opt_state, state.error_feedback), metrics

    return step


def train_loop(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    pipeline,
    steps: int,
    state: Optional[TrainState] = None,
    frontend: Optional[torch.Tensor] = None,
    callback: Optional[Callable[[int, TrainState, Dict[str, float]], None]] = None,
    device="cuda",
):
    """The host loop of ``launch/train.py`` and the tests: ``steps`` steps on
    ``pipeline.batch_at(step)`` from ``state`` (a seed-0 init if None), the
    frontend's embeddings (if any) with every batch, each step's metrics
    read on the host after it and handed to ``callback(step, state,
    metrics)``.  Returns ``(state, history)``."""
    state = state if state is not None else init_train_state(cfg, tcfg, 0, device)
    step_fn = make_train_step(cfg, tcfg)
    history = []
    for s in range(steps):
        tokens, labels = (torch.from_numpy(a).to(device, torch.int64) for a in pipeline.batch_at(s))
        state, metrics = step_fn(state, tokens, labels, frontend)
        history.append({k: float(v) for k, v in metrics.items()})
        if callback is not None:
            callback(s, state, history[-1])
    return state, history
