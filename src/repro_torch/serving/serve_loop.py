"""Serving: prefill and greedy decode steps on one card.

``make_serve_step`` and ``make_prefill_fn`` return the per-request units of
the JAX package's serve loop, which jits the prefill and the decode step
and donates the decode state.  On a CUDA device the port runs each as a
CUDA graph (``repro_torch.graphs``), captured at first use and replayed at
every later call.  The decode graph is one per (config, model, batch,
cache length, memory length): it owns its decode state (every cache of the
family -- KV ring, SSM conv tails and states, the encdec cross memory --
and the position) and its static tokens and logits.  The prefill graph is
one per (config, model, batch, prompt length, cache length, frontend
shape): it owns its static tokens, frontend buffer and logits, and writes
the caches and position into the state of the decode graph of its batch,
cache length and memory length, so that prefill and decode together read
and write only fixed addresses.  On the CPU both run eagerly, and
``eager=True`` asks for the eager route on the card too, to hold the
graphs against it.  ``greedy_generate`` is the batched greedy decoding
loop.  The families with a frontend (encdec, vlm) take its stub
embeddings beside the tokens, as the JAX package's serve loop does.

With a ``mesh`` (a ``DeviceMesh`` over the whole process group, one
process a device) the steps are the JAX package's sharded ones: the model
is a tensor-parallel one of this rank's parameter blocks
(``shard_model``), every rank is given the same global tokens and takes
its rows where ``specs.batch_dim`` splits the batch over the DP axes, the
caches are this rank's blocks per ``specs.decode_state_specs`` (the KV
cache head- or sequence-sharded: the prefill chooses as the JAX package's
does, ``place_state`` as it is told), and the logits are this
rank's block per ``specs.logits_spec`` (its rows, its vocab block):
``gather_logits`` puts them together.  ``place_state`` cuts a whole decode
state into a rank's blocks, as ``jax.device_put`` with those specs does.
Over NCCL the mesh prefill and decode steps are CUDA graphs with their
collectives (``graphs.Graph(collectives=True)``), as the sharded BST
program is; over gloo (the CPU, or ranks that share one card) they run
eagerly: gloo's collectives run on the host and cannot be captured.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import graphs
from repro_torch.checkpoint import elastic
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import specs, tp


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
                 memory_len: Optional[int] = None, mesh: Any = None):
        device = model.embed.device
        self.cfg = cfg
        if mesh is None:
            self.state = M.make_decode_state(cfg, batch, max_len, device, memory_len)
            rows, collectives = batch, False
        else:  # this rank's blocks; the step's collectives are kernels of the graph
            self.state = mesh_decode_state(cfg, mesh, batch, max_len, device, memory_len)
            rows, collectives = _rows(mesh, batch).stop - _rows(mesh, batch).start, True
        self.tokens = torch.zeros((rows, 1), dtype=torch.int64, device=device)
        self.addresses = _addresses(model)
        self.graph = graphs.Graph(
            lambda: M.decode_step(cfg, model, self.tokens, self.state)[0],
            label=("decode", batch, max_len, memory_len), collectives=collectives, device=device,
        )

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens)
        return self.graph.replay()


class PrefillGraph:
    """The prefill of one (config, batch, prompt length, cache length,
    frontend shape[, mesh]) on ``model`` as one CUDA graph: it reads its
    static (B, S) ``tokens`` and ``frontend`` buffer (the global batch
    with a mesh: the graph takes this rank's rows), writes the caches and
    the position into ``decode``'s state, the decode graph's of the same
    batch, cache length and memory length, and its (B, V) logits.  The
    capture runs the prefill once eagerly (the warm-up) and records it; the
    first call replays it as every later one does (a prefill only rewrites
    the caches it wrote: it may run twice).  Like the decode graph it holds the addresses of the
    model's parameters and buffers, not the model.  A model's prefill
    graphs share one memory pool, ``pool``: a replay may reuse the memory
    of another prefill graph's logits, so the logits a prefill returns
    are valid until the model's next prefill, of any shape (clone them to
    keep them)."""

    def __init__(self, cfg: ModelConfig, model: M.Model, decode: DecodeGraph,
                 tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor],
                 max_len: Optional[int], mesh: Any, pool):
        B, S = tokens.shape
        self.decode = decode
        self.addresses = _addresses(model)
        self.tokens = tokens.clone()
        self.frontend = None if frontend_embeds is None else frontend_embeds.clone()
        state = decode.state
        if mesh is None:
            def run():
                return M.prefill(cfg, model, self.tokens, self.frontend, max_len=max_len,
                                 out=state)[0]
        else:
            rows, split = _rows(mesh, B), specs.batch_dim(mesh, B) is not None

            def run():
                fe = None if self.frontend is None else self.frontend[rows]
                with model.tp.batch_rows(split):
                    return M.prefill(cfg, model, self.tokens[rows], fe, max_len=max_len,
                                     out=state)[0]

        self.graph = graphs.Graph(run, pool=pool, label=("prefill", B, S, max_len),
                                  collectives=mesh is not None, device=tokens.device)

    def __call__(self, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, M.DecodeState]:
        self.tokens.copy_(tokens)
        if self.frontend is not None:
            self.frontend.copy_(frontend_embeds)
        return self.graph.replay(), self.decode.state


# Per model (held weakly: a model's graphs go with it), its decode graphs by
# (config, batch, max_len, memory_len, mesh?), its prefill graphs by
# (config, batch, prompt length, max_len, frontend shape, mesh?), and the
# memory pool its prefill graphs share.
_GRAPHS: "weakref.WeakKeyDictionary[M.Model, Dict[Tuple, DecodeGraph]]" = (
    weakref.WeakKeyDictionary()
)
_PREFILLS: "weakref.WeakKeyDictionary[M.Model, Dict[Tuple, PrefillGraph]]" = (
    weakref.WeakKeyDictionary()
)
_POOLS: "weakref.WeakKeyDictionary[M.Model, Any]" = weakref.WeakKeyDictionary()


def decode_graph(cfg: ModelConfig, model: M.Model, batch: int, max_len: int,
                 memory_len: Optional[int] = None, mesh: Any = None) -> DecodeGraph:
    """``model``'s decode graph for (cfg, batch, max_len, memory_len[,
    the mesh]), captured at the first call and returned as
    it is by every later one while the model holds its parameters at the
    same addresses; otherwise captured anew over the current ones, as the
    JAX step takes ``params`` at every call."""
    per_model = _GRAPHS.setdefault(model, {})
    key = (cfg, batch, max_len, memory_len, mesh is not None)
    g = per_model.get(key)
    if g is None or g.addresses != _addresses(model):
        per_model[key] = g = DecodeGraph(cfg, model, batch, max_len, memory_len, mesh)
    return g


def prefill_graph(cfg: ModelConfig, model: M.Model, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor] = None, max_len: Optional[int] = None,
                  mesh: Any = None) -> PrefillGraph:
    """``model``'s prefill graph for the shapes of ``tokens`` (the global
    batch with a mesh) and ``frontend_embeds``, into the state of
    ``decode_graph``'s graph for (B, ``max_len`` or S, Smem), captured at
    the first call (over these inputs) and returned as it is by every
    later one while that decode graph and the parameters' addresses stay
    the same; otherwise captured anew."""
    B, S = tokens.shape
    memory_len = frontend_embeds.shape[1] if cfg.family == "encdec" else None
    decode = decode_graph(cfg, model, B, max_len or S, memory_len, mesh)
    frontend = None if frontend_embeds is None else (tuple(frontend_embeds.shape),
                                                      frontend_embeds.dtype)
    key = (cfg, B, S, max_len or S, frontend, mesh is not None)
    per_model = _PREFILLS.setdefault(model, {})
    g = per_model.get(key)
    if g is None or g.decode is not decode or g.addresses != _addresses(model):
        if model not in _POOLS:
            _POOLS[model] = torch.cuda.graph_pool_handle()
        per_model.pop(key, None)
        per_model[key] = g = PrefillGraph(cfg, model, decode, tokens, frontend_embeds, max_len,
                                          mesh, _POOLS[model])
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


# ------------------------------------------------------------------ the mesh
def _rows(mesh: Any, batch: int) -> slice:
    """This rank's rows of a global serving batch (``specs.batch_dim``)."""
    shape = specs.mesh_shape(mesh)
    coord = dict(zip(shape, mesh.get_coordinate()))
    (rows,) = elastic.shard_slices((batch,), (specs.batch_dim(shape, batch),), shape, coord)
    return rows


def shard_model(cfg: ModelConfig, model: M.Model, mesh: Any) -> M.Model:
    """The tensor-parallel model of ``model`` on ``mesh``: this rank's
    blocks of its parameters (``param_specs``) on the mesh's device."""
    return elastic.sharded_model(cfg, elastic.reshard_params(model, cfg, mesh), mesh)


def _cut_state(cfg: ModelConfig, mesh: Any, batch: int, state: M.DecodeState,
               seq_shard: Optional[bool], make) -> M.DecodeState:
    """``state``'s tensors cut by ``decode_state_specs``: ``make(tensor,
    this rank's slices)`` gives each block."""
    shape = specs.mesh_shape(mesh)
    coord = dict(zip(shape, mesh.get_coordinate()))
    sp = specs.decode_state_specs(cfg, shape, batch, seq_shard)
    want = M.state_tensors(sp)

    def cut(name, t):
        return make(t, elastic.shard_slices(t.shape, want[name], shape, coord))

    position = make(state.position, ())
    kv = ssm_c = cross = None
    if state.kv is not None:
        seq = tp.mesh_axis(mesh, ("model",)) if specs.seq_sharded(cfg, shape, seq_shard) else None
        kv = type(state.kv)(cut("kv.k", state.kv.k), cut("kv.v", state.kv.v), position, seq)
    if state.ssm is not None:
        ssm_c = type(state.ssm)(cut("ssm.conv", state.ssm.conv), cut("ssm.state", state.ssm.state),
                                position)
    if state.cross_kv is not None:
        cross = (cut("cross_kv.k", state.cross_kv[0]), cut("cross_kv.v", state.cross_kv[1]))
    return M.DecodeState(kv=kv, ssm=ssm_c, cross_kv=cross, position=position)


def mesh_decode_state(cfg: ModelConfig, mesh: Any, batch: int, max_len: int, device,
                      memory_len: Optional[int] = None,
                      seq_shard: Optional[bool] = None) -> M.DecodeState:
    """Zeroed caches of a global batch of ``batch``: this rank's blocks per
    ``decode_state_specs(seq_shard)``, the sequence split chosen
    automatically by default (a sequence-sharded KV cache carries the model
    axis as its ``seq_axis``)."""
    meta = M.make_decode_state(cfg, batch, max_len, "meta", memory_len)

    def make(t, rows):
        return torch.zeros([s.stop - s.start for s in rows], dtype=t.dtype, device=device)

    return _cut_state(cfg, mesh, batch, meta, seq_shard, make)


def place_state(cfg: ModelConfig, mesh: Any, batch: int, state: M.DecodeState,
                seq_shard: Optional[bool] = None) -> M.DecodeState:
    """A whole decode state (a single-card prefill's) cut into copies of
    this rank's blocks per ``decode_state_specs(seq_shard)``."""
    return _cut_state(cfg, mesh, batch, state, seq_shard, lambda t, rows: t[rows].clone())


def gather_logits(cfg: ModelConfig, mesh: Any, batch: int, logits: torch.Tensor) -> torch.Tensor:
    """The whole (B, V) logits of a mesh step's block (``logits_spec``):
    the vocab blocks gathered over the model axis, the rows over the DP
    axes."""
    shape = specs.mesh_shape(mesh)
    spec = specs.logits_spec(cfg, shape, batch)
    if spec[1] is not None:
        logits = tp.mesh_axis(mesh, ("model",)).all_gather(logits, dim=1)
    if spec[0] is not None:
        logits = tp.mesh_axis(mesh, specs.dp_axes(shape)).all_gather(logits, dim=0)
    return logits


def _check_model(model: M.Model) -> None:
    if getattr(model, "tp", None) is None:
        raise ValueError("a mesh step runs a tensor-parallel model: build it with "
                         "shard_model(cfg, model, mesh) (or elastic.sharded_model)")


# -------------------------------------------------------------- entry points
def make_serve_step(cfg: ModelConfig, mesh: Any = None, batch: int = 1,
                    seq_shard: Optional[bool] = None, *, eager: bool = False) -> Callable:
    """(model, tokens (B, 1), DecodeState) -> (logits (B, V), DecodeState);
    the state's caches and position advance in place.  On a CUDA device
    (unless ``eager``) the step is one replay of the state's decode graph,
    so the state must be the one its prefill wrote (``make_prefill_fn``),
    and the logits are the graph's static buffer: valid until the next
    step of that graph, as a donated buffer is (clone them to keep them).

    With ``mesh``: the sharded step of a global batch of ``batch``, the
    KV cache laid out per ``decode_state_specs(seq_shard)`` (None: auto,
    as the prefill lays it out; a state of the other layout raises), on a
    tensor-parallel model; tokens are the global (B, 1) on every rank, the
    logits this rank's block.  A graph over NCCL (the state its prefill
    wrote), eager over gloo."""
    if mesh is None:
        def step(model, tokens, state):
            if graphs.eager_route(eager, tokens):
                return M.decode_step(cfg, model, tokens, state)
            graph = _graph_of(cfg, model, state)
            return graph(tokens), graph.state

        return step

    rows = _rows(mesh, batch)
    split = specs.batch_dim(mesh, batch) is not None
    seq = specs.seq_sharded(cfg, mesh, seq_shard)

    def mesh_step(model, tokens, state):
        _check_model(model)
        if tokens.shape[0] != batch:
            raise ValueError(f"the mesh step was made for a batch of {batch}, got "
                             f"{tokens.shape[0]}")
        if state.kv is not None and (state.kv.seq_axis is not None) != seq:
            layouts = ("head", "sequence")
            raise ValueError(f"the mesh step (seq_shard={seq_shard!r}) takes a {layouts[seq]}-"
                             f"sharded KV cache, the state's is {layouts[not seq]}-sharded")
        with model.tp.batch_rows(split):
            if graphs.eager_route(eager, tokens, collectives=True):
                return M.decode_step(cfg, model, tokens[rows], state)
            graph = _graph_of(cfg, model, state)
            return graph(tokens[rows]), graph.state

    return mesh_step


def make_prefill_fn(
    cfg: ModelConfig, mesh: Any = None, batch: int = 1, max_len: Optional[int] = None, *,
    eager: bool = False,
) -> Callable:
    """(model, tokens (B, S)[, frontend_embeds]) -> (last-position logits
    (B, V), DecodeState): the frontend's embeddings are the third argument
    where ``cfg.frontend`` is set (encdec: the encoder's frames (B, Smem,
    D); vlm: the patch embeddings (B, flen, D)), as in the JAX package.  On
    a CUDA device (unless ``eager``) the prefill is one replay of the
    model's prefill graph for these shapes (``prefill_graph``), which
    writes the caches into the state of the decode graph for (B,
    ``max_len``, Smem): a later request of that shape overwrites them, and
    the logits are the prefill graph's static buffer (valid until the
    model's next prefill).

    With ``mesh``: the sharded prefill of a global batch of ``batch`` on a
    tensor-parallel model (the global tokens and frontend on every rank),
    its cache laid out by ``decode_state_specs`` with the sequence split
    chosen automatically, as the JAX package's; the logits are this
    rank's block.  A graph over NCCL, eager over gloo, whose collectives
    run on the host."""
    rows = None if mesh is None else _rows(mesh, batch)
    split = mesh is not None and specs.batch_dim(mesh, batch) is not None

    def run(model, tokens, frontend_embeds=None):
        if mesh is None:
            if graphs.eager_route(eager, tokens):
                return M.prefill(cfg, model, tokens, frontend_embeds, max_len=max_len)
            return prefill_graph(cfg, model, tokens, frontend_embeds, max_len)(
                tokens, frontend_embeds)
        _check_model(model)
        B, S = tokens.shape
        if B != batch:
            raise ValueError(f"the mesh prefill was made for a batch of {batch}, got {B}")
        if not graphs.eager_route(eager, tokens, collectives=True):
            return prefill_graph(cfg, model, tokens, frontend_embeds, max_len, mesh)(
                tokens, frontend_embeds)
        memory_len = frontend_embeds.shape[1] if cfg.family == "encdec" else None
        out = mesh_decode_state(cfg, mesh, batch, max_len or S, tokens.device, memory_len)
        fe = None if frontend_embeds is None else frontend_embeds[rows]
        with model.tp.batch_rows(split):
            return M.prefill(cfg, model, tokens[rows], fe, max_len=max_len, out=out)

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
    one decode step per further token, through the prefill and decode
    graphs on a CUDA device unless ``eager``.  ``frontend_embeds`` go to the prefill where
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
