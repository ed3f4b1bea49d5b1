"""Partition specs per architecture (DP / TP / EP / SP), keyed by the port's names.

The port's copy of the JAX package's ``sharding/specs.py``: the same rules
as pure functions of (config, mesh shape), so the tests hold them to the
JAX package's over ``jax.sharding.AbstractMesh`` and
``checkpoint/elastic.py`` places a state by them.  Axis roles on the
production mesh (``launch/mesh.py``): ``pod`` and ``data`` are data
parallelism, ``model`` tensor parallelism (attention heads, FFN width,
vocab rows, expert inner width, SSM heads).  A dim is sharded only when
its size divides by the axis size; otherwise it is replicated.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or a mapping of
axis name to size, in mesh order.  A spec is a ``Spec``: a tuple with one
entry a tensor dim, each an axis name, a tuple of names (the dim split
over them, the first the major one) or ``None`` (replicated), as a
``PartitionSpec`` has them.  ``param_specs`` and the trees of
``state_specs`` map the port's parameter names (``layers.3.attn.wq``) to
specs, in ``named_parameters`` order.  The JAX tree stacks a layer's
leaves as (L, ...); a per-layer tensor's spec is the stacked leaf's
without its leading layer entry, and that entry is the spec's ``layer``:
``None``, or the axis over which ZeRO-1 (``cfg.zero1``) splits the layers,
so that layer i is held whole by the devices whose coordinate on that axis
is i // (L / size) -- which no DTensor placement of a single layer's
tensor can say.

``train_step_shardings`` places the tensor-parallel train step's inputs
and outputs; ``decode_state_specs`` a ``DecodeState``'s caches (stacked
(L, ...) as the JAX package's, so each cache's spec is the JAX leaf's
whole tuple) and ``serve_step_shardings`` the serving step's: what
``training/train_loop.py``'s ``mode="pjit"`` and
``serving/serve_loop.py``'s mesh steps cut their tensors by
(``sharding/tp.py`` computes on those blocks).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.models.config import ModelConfig

Entry = Any  # None | str | Tuple[str, ...]


def _canonical(entry: Entry) -> Entry:
    """An entry as ``PartitionSpec`` keeps it: a one-name tuple as the
    name, an empty tuple as ``None``."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


class Spec(tuple):
    """One tensor's placement: a tuple of entries, one a dim, and
    ``layer``, the entry of the JAX tree's stacked layer dim (``None``
    for a tensor that is not a layer's, and for a layer replicated over
    the mesh)."""

    def __new__(cls, dims=(), layer: Entry = None):
        spec = super().__new__(cls, tuple(_canonical(e) for e in dims))
        spec.layer = _canonical(layer)
        return spec

    def stacked(self) -> Tuple[Entry, ...]:
        """The JAX package's spec of the stacked (L, ...) leaf."""
        return (self.layer, *self)

    def __eq__(self, other):
        return tuple.__eq__(self, other) and self.layer == getattr(other, "layer", None)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((tuple(self), self.layer))

    def __repr__(self):
        return f"Spec({tuple(self)!r}" + (f", layer={self.layer!r})" if self.layer else ")")


def mesh_ranks(mesh: Any) -> List[List[int]]:
    """A ``DeviceMesh``'s ranks, nested as its shape (a list a dim).  The
    layout is host metadata, read outside any ``FakeTensorMode`` (a dry
    run traces the steps under one, and the layout is a real tensor)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return mesh.mesh.tolist()


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, np.shape(mesh_ranks(mesh))))


def _axis(shape: Mapping[str, int], name: str) -> int:
    return shape.get(name, 1)


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _maybe(dim: int, size: int, axis: str) -> Optional[str]:
    """Shard ``dim`` over ``axis`` of ``size`` only if divisible."""
    return axis if size > 1 and dim % size == 0 else None


def all_axes(mesh: Any) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def _jax_param_specs(cfg: ModelConfig, m: int) -> Dict[str, Any]:
    """The JAX package's spec tree (tuples; a layer's specs without the
    layer entry), ``m`` the model axis's size."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def attn_spec():
        s = {
            "wq": (None, _maybe(H * hd, m, "model")),
            "wk": (None, _maybe(KV * hd, m, "model")),
            "wv": (None, _maybe(KV * hd, m, "model")),
            "wo": (_maybe(H * hd, m, "model"), None),
        }
        if cfg.qk_norm:
            s["q_norm"] = (None,)
            s["k_norm"] = (None,)
        return s

    def mlp_spec():
        return {
            "w_gate": (None, _maybe(F, m, "model")),
            "w_up": (None, _maybe(F, m, "model")),
            "w_down": (_maybe(F, m, "model"), None),
        }

    def moe_spec():
        return {
            "router": (None, None),
            # experts replicated across E dim, TP inside each expert
            "w_gate": (None, None, _maybe(F, m, "model")),
            "w_up": (None, None, _maybe(F, m, "model")),
            "w_down": (None, _maybe(F, m, "model"), None),
        }

    def ssm_spec():
        di, Hs = cfg.d_inner, cfg.ssm_heads
        return {
            "wx": (None, _maybe(di, m, "model")),
            "wz": (None, _maybe(di, m, "model")),
            "wB": (None, None),
            "wC": (None, None),
            "wdt": (None, _maybe(Hs, m, "model")),
            "dt_bias": (_maybe(Hs, m, "model"),),
            "A_log": (_maybe(Hs, m, "model"),),
            "Dskip": (_maybe(Hs, m, "model"),),
            "conv_w": (None, None),
            "norm": (_maybe(di, m, "model"),),
            "wo": (_maybe(di, m, "model"), None),
        }

    def layer_spec(role: str):
        s: Dict[str, Any] = {"ln1": (None,)}
        if cfg.family == "ssm":
            s["ssm"] = ssm_spec()
            return s
        s["attn"] = attn_spec()
        if cfg.family == "hybrid":
            s["ssm"] = ssm_spec()
        if role == "decoder" and cfg.family == "encdec":
            s["ln_cross"] = (None,)
            s["cross"] = attn_spec()
        s["ln2"] = (None,)
        if cfg.family == "moe":
            s["moe"] = moe_spec()
        elif cfg.d_ff > 0:
            s["mlp"] = mlp_spec()
        return s

    specs: Dict[str, Any] = {
        "embed": (_maybe(V, m, "model"), None),  # vocab rows over model
        "final_norm": (None,),
        "layers": layer_spec("decoder"),
    }
    if not cfg.tie_embeddings:
        specs["head"] = (_maybe(V, m, "model"), None)
    if cfg.family == "encdec":
        specs["enc_layers"] = layer_spec("encoder")
        specs["enc_final_norm"] = (None,)
    return specs


def _meta_params(cfg: ModelConfig):
    from repro_torch.models.model import Model

    return list(Model(cfg, device="meta").named_parameters())


def param_specs(cfg: ModelConfig, mesh: Any) -> Dict[str, Spec]:
    """Parameter name -> ``Spec``, in ``named_parameters`` order."""
    from repro_torch.models import convert

    m = _axis(mesh_shape(mesh), "model")
    if cfg.sharding_strategy == "dp_only":
        m = 1  # every _maybe() falls back to replication
    tree = _jax_param_specs(cfg, m)
    specs = {}
    for name, _ in _meta_params(cfg):
        keys, _layer = convert.jax_key(name)
        node = tree
        for key in keys:
            node = node[key]
        specs[name] = Spec(node)
    return specs


def _zero_shard(stacked: Tuple[Entry, ...], shape: Tuple[int, ...], d: int) -> Tuple[Entry, ...]:
    """The JAX package's ZeRO-1 rule on a leaf's spec: the first
    unsharded dim divisible by the data axis gets it (padding the spec to
    the leaf's rank), else the spec unchanged."""
    dims = list(stacked) + [None] * (len(shape) - len(stacked))
    for i, n in enumerate(shape):
        if dims[i] is None and n % d == 0:
            dims[i] = "data"
            return tuple(dims)
    return stacked


def state_specs(cfg: ModelConfig, mesh: Any):
    """Specs of a ``TrainState``: ``params``, ``opt`` (``step``, and the
    ``master``, ``mu``, ``nu`` name -> ``Spec`` dicts, ZeRO-1 sharded over
    ``data`` when ``cfg.zero1``) and an empty ``error_feedback``."""
    from repro_torch.models import convert
    from repro_torch.optim.optimizer import AdamWState
    from repro_torch.training.train_loop import TrainState

    shape = mesh_shape(mesh)
    ps = param_specs(cfg, shape)
    opt_ps = ps
    if cfg.zero1 and shape.get("data", 1) > 1:
        d = shape["data"]
        named = _meta_params(cfg)
        counts = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
        opt_ps = {}
        for name, p in named:
            keys, layer = convert.jax_key(name)
            spec = ps[name]
            if layer is None:
                opt_ps[name] = Spec(_zero_shard(tuple(spec), tuple(p.shape), d))
                continue
            full = _zero_shard(spec.stacked(), (counts[keys[0]], *p.shape), d)
            opt_ps[name] = Spec(full[1:], layer=full[0])
    return TrainState(
        params=ps,
        opt=AdamWState(step=Spec(()), master=opt_ps, mu=opt_ps, nu=opt_ps),
        error_feedback=(),
    )


def batch_specs(cfg: ModelConfig, mesh: Any) -> Dict[str, Spec]:
    dp = all_axes(mesh) if cfg.sharding_strategy == "dp_only" else dp_axes(mesh)
    return {
        "tokens": Spec((dp, None)),
        "labels": Spec((dp, None)),
        "frontend": Spec((dp, None, None)),
    }


def _ndp(shape: Mapping[str, int]) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= shape.get(a, 1)
    return n


def batch_dim(mesh: Any, batch: int) -> Entry:
    """The serving batch's entry: split over the DP axes when ``batch``
    divides by their product and there is more than one DP rank, else
    replicated (the JAX package's ``bdim``)."""
    shape = mesh_shape(mesh)
    dp, ndp = dp_axes(shape), _ndp(shape)
    return _canonical(dp) if (batch % max(ndp, 1) == 0 and ndp > 1) else None


def train_step_shardings(cfg: ModelConfig, mesh: Any) -> Dict[str, Any]:
    """Specs of ``make_train_step(mode="pjit")``'s (state, tokens,
    labels[, frontend]) and of its (state, metrics)."""
    ss = state_specs(cfg, mesh)
    bs = batch_specs(cfg, mesh)
    ins = (ss, bs["tokens"], bs["labels"])
    if cfg.frontend is not None:
        ins = ins + (bs["frontend"],)
    return {"in": ins, "out": (ss, Spec(()))}


def seq_sharded(cfg: ModelConfig, mesh: Any, seq_shard: Optional[bool] = None) -> bool:
    """Whether the KV cache splits its slots (sequence) over the model
    axis: ``seq_shard``, or for None (auto) exactly when the kv heads do
    not split and the axis has more than one rank."""
    m = _axis(mesh_shape(mesh), "model")
    if seq_shard is None:
        return cfg.has_attention and _maybe(cfg.n_kv_heads, m, "model") is None and m > 1
    return bool(seq_shard)


def decode_state_specs(cfg: ModelConfig, mesh: Any, batch: int,
                       seq_shard: Optional[bool] = None):
    """Specs of a ``DecodeState``: the batch over DP when it divides, kv
    heads and SSM heads over model.  ``seq_shard=True`` splits the KV
    cache's slots over model instead of its kv heads (sequence-parallel
    decode: each rank owns 1/m of the window, computes a partial softmax,
    and the ranks combine its statistics); None (auto) seq-shards exactly
    when the kv heads cannot split (``seq_sharded``).  Each cache entry is
    the (L, ...) stacked tensor's whole spec; the position is replicated."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import DecodeState

    m = _axis(mesh_shape(mesh), "model")
    bdim = batch_dim(mesh, batch)
    kv_head = _maybe(cfg.n_kv_heads, m, "model")
    seq = seq_sharded(cfg, mesh, seq_shard)
    position = Spec(())
    kv = sm = cross = None
    if cfg.has_attention:
        if seq:
            kv = attn_mod.KVCache(k=Spec((None, bdim, "model", None, None)),
                                  v=Spec((None, bdim, "model", None, None)), length=position)
        else:
            kv = attn_mod.KVCache(k=Spec((None, bdim, None, kv_head, None)),
                                  v=Spec((None, bdim, None, kv_head, None)), length=position)
    if cfg.family in ("ssm", "hybrid"):
        sm = ssm_mod.SSMCache(
            conv=Spec((None, bdim, None, None)),
            state=Spec((None, bdim, _maybe(cfg.ssm_heads, m, "model"), None, None)),
            length=position)
    if cfg.family == "encdec":
        cross = (Spec((None, bdim, None, kv_head, None)), Spec((None, bdim, None, kv_head, None)))
    return DecodeState(kv=kv, ssm=sm, cross_kv=cross, position=position)


def logits_spec(cfg: ModelConfig, mesh: Any, batch: int) -> Spec:
    """The serving steps' (B, V) logits: the batch as ``batch_dim``, the
    vocab over model where it divides."""
    m = _axis(mesh_shape(mesh), "model")
    return Spec((batch_dim(mesh, batch), _maybe(cfg.vocab_size, m, "model")))


def serve_step_shardings(cfg: ModelConfig, mesh: Any, batch: int,
                         seq_shard: Optional[bool] = False) -> Dict[str, Any]:
    """Specs of the mesh decode step's (params, tokens, cache) and of its
    (logits, cache)."""
    cache = decode_state_specs(cfg, mesh, batch, seq_shard=seq_shard)
    toks = Spec((batch_dim(mesh, batch), None))
    return {"in": (param_specs(cfg, mesh), toks, cache),
            "out": (logits_spec(cfg, mesh, batch), cache)}
