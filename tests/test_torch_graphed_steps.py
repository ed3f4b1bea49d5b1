"""The graph route of the prefill and the train step, on the CPU.

On a CUDA device ``make_prefill_fn``, ``greedy_generate`` and
``make_train_step`` run their steps as CUDA graphs (``repro_torch.graphs``);
the CPU has none, so here a stand-in for ``graphs.Graph`` runs the captured
function at the capture and again at every replay, and the route predicate
``graphs.eager_route`` is patched so that the CPU takes the graph route.
What this holds is the route's bookkeeping: the static inputs, which graph
a call finds, when a graph is captured anew, the prefill writing into its
decode graph's state, the train step's first call being the capture's
warm-up, and every state tensor updated in place.  The kernels inside a
real graph are held against the eager route on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

At smoke size, fp32, the weights the JAX package's: prefill then 4 decode
steps of the dense, moe, ssm and encdec families against the JAX package's
``prefill`` and ``decode_step`` within ``tests/test_torch_lm.py``'s 2e-5,
and bit for bit against the port's eager route; 3 train steps, plain and
with 2 microbatches, against the eager route bit for bit and the JAX
package's ``make_train_step`` (loss within 1e-5; parameters within 1e-4:
three AdamW steps of lr 1e-3 on the same gradients to fp32 rounding, which
``tests/test_torch_training.py`` holds one step of within 1e-5 of its
scale).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models.convert import jax_leaf, params_from_jax  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402

jtrain = importlib.import_module("repro.training.train_loop")
ttrain = importlib.import_module("repro_torch.training.train_loop")

LOGIT_TOL = 2e-5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
DECODE_STEPS = 4
TRAIN_STEPS = 3
TRAIN_ARCH = "tinyllama_1p1b"
BATCH, SEQ = 4, 16


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def graph_route(monkeypatch):
    """The CPU on the graph route: ``graphs.Graph`` stands in as a graph
    that runs ``fn`` at its capture and at every replay (its capture's
    result is ``warm`` and ``out``, as a real graph's warm-up and static
    output), every step takes the graph route, and a memory pool is a
    token.  Yields the labels of the graphs captured, in order."""
    captured = []

    class RunningGraph:
        def __init__(self, fn, *, warmup=True, release=False, pool=None, label=None,
                     collectives=False, device=None):
            self._fn = fn
            self.out = self.warm = fn()
            self.pool_bytes = 0
            captured.append(label)

        def replay(self):
            self.out = self._fn()
            return self.out

    monkeypatch.setattr(graphs, "Graph", RunningGraph)
    monkeypatch.setattr(graphs, "eager_route", lambda eager, tensor, collectives=False: eager)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    return captured


def _norms_to_one(params):
    """The JAX init tree with every norm scale 1 (its init draws them)."""
    for stack in (params["layers"], params.get("enc_layers")):
        if stack is None:
            continue
        for leaf in (stack, stack.get("attn", {}), stack.get("ssm", {})):
            for name in ("ln1", "ln2", "ln_cross", "q_norm", "k_norm", "norm"):
                if name in leaf:
                    leaf[name] = np.ones_like(leaf[name])
    return params


def _serving_case(arch, seed=0):
    jcfg = dataclasses.replace(jsmoke_config(arch), attention_impl="flash_pallas")
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), attention_impl="flash")
    params = _norms_to_one(jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed))))
    return jcfg, tcfg, params, params_from_jax(tcfg, params, device="cpu")


def _caches(state):
    """A decode state's caches by name, on either side."""
    out = {}
    if state.kv is not None:
        out.update({"kv.k": state.kv.k, "kv.v": state.kv.v})
    if state.ssm is not None:
        out.update({"ssm.conv": state.ssm.conv, "ssm.state": state.ssm.state})
    if state.cross_kv is not None:
        out.update({"cross.k": state.cross_kv[0], "cross.v": state.cross_kv[1]})
    return out


# ------------------------------------------------------------------ prefill
@pytest.mark.parametrize("arch,S,frames", [
    ("qwen3_1p7b", 12, 0), ("mixtral_8x7b", 24, 0), ("mamba2_1p3b", 14, 0),
    ("seamless_m4t_medium", 12, 20),
])
def test_graphed_prefill_and_decode_match_jax(graph_route, arch, S, frames):
    """Prefill then DECODE_STEPS decode steps through the graph route: the
    logits, every cache and the position against the JAX package's
    ``prefill`` and ``decode_step`` (jitted) and bit for bit against the
    port's eager route; the prefill wrote into its decode graph's state,
    the one graph of each kind captured."""
    jcfg, tcfg, params, model = _serving_case(arch)
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, S + DECODE_STEPS)).astype(np.int32)
    fe = rng.standard_normal((2, frames, tcfg.d_model)).astype(np.float32) if frames else None
    front = () if fe is None else (_t(fe),)
    max_len = S + DECODE_STEPS

    jlog, jstate = jax.jit(functools.partial(JM.prefill, jcfg, max_len=max_len))(
        jparams, jnp.asarray(toks[:, :S]), None if fe is None else jnp.asarray(fe))
    routes = {}
    for eager in (False, True):
        logits, state = serve_loop.make_prefill_fn(tcfg, max_len=max_len, eager=eager)(
            model, _t(toks[:, :S]).long(), *front)
        out = [logits.clone()]
        caches = {k: t.clone() for k, t in _caches(state).items()}
        assert int(state.position) == S
        step = serve_loop.make_serve_step(tcfg, eager=eager)
        for t in range(DECODE_STEPS):
            logits, state = step(model, _t(toks[:, S + t:S + t + 1]).long(), state)
            out.append(logits.clone())
        routes[eager] = out, caches, state
    graph_out, graph_caches, graph_state = routes[False]
    memory_len = frames if tcfg.family == "encdec" else None
    assert graph_state is serve_loop.decode_graph(tcfg, model, 2, max_len, memory_len).state
    assert graph_route == [("decode", 2, max_len, memory_len), ("prefill", 2, S, max_len)]

    _close(graph_out[0], jlog, LOGIT_TOL)
    want = _caches(jstate)
    assert set(graph_caches) == set(want)
    for name, got in graph_caches.items():
        _close(got, want[name], LOGIT_TOL)
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))
    for t in range(DECODE_STEPS):
        jlog, jstate = jdecode(jparams, jnp.asarray(toks[:, S + t:S + t + 1]), jstate)
        _close(graph_out[t + 1], jlog, LOGIT_TOL)
    eager_out, eager_caches, _ = routes[True]
    assert all(torch.equal(a, b) for a, b in zip(graph_out, eager_out, strict=True))
    assert all(torch.equal(graph_caches[k], eager_caches[k]) for k in eager_caches)


def test_prefill_graphs_are_keyed_on_their_shapes_and_the_parameters(graph_route):
    """One capture per (batch, prompt length, cache length): a repeated
    request captures nothing, a shorter prompt with the same cache length
    only its prefill graph, a longer cache both; a re-bound parameter
    captures both anew over the new weights, whose tokens are the eager
    route's."""
    _, tcfg, _, model = _serving_case("qwen3_1p7b", seed=1)
    toks = _t(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 16))).long()
    want = serve_loop.greedy_generate(tcfg, model, toks[:, :12], 4, eager=True)
    assert torch.equal(serve_loop.greedy_generate(tcfg, model, toks[:, :12], 4), want)
    assert [g[0] for g in graph_route] == ["decode", "prefill"]
    assert torch.equal(serve_loop.greedy_generate(tcfg, model, toks[:, :12], 4), want)
    assert len(graph_route) == 2
    serve_loop.make_prefill_fn(tcfg, max_len=16)(model, toks[:, :10])
    assert graph_route[2:] == [("prefill", 2, 10, 16)]
    serve_loop.make_prefill_fn(tcfg, max_len=20)(model, toks[:, :10])
    assert graph_route[3:] == [("decode", 2, 20, None), ("prefill", 2, 10, 20)]
    model.final_norm = torch.nn.Parameter(torch.full_like(model.final_norm, 0.5),
                                          requires_grad=False)
    want = serve_loop.greedy_generate(tcfg, model, toks[:, :12], 4, eager=True)
    assert torch.equal(serve_loop.greedy_generate(tcfg, model, toks[:, :12], 4), want)
    assert [g[0] for g in graph_route[5:]] == ["decode", "prefill"]


# --------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def train_case():
    """tinyllama's smoke weights (norm scales 1, the rest N(0, 0.02) from
    numpy, in the JAX init tree's shapes) and the JAX package's states
    after each of TRAIN_STEPS steps, per microbatch count."""
    jcfg = jsmoke_config(TRAIN_ARCH)
    rng = np.random.default_rng(0)

    def draw(path, spec):
        if path[-1].key in ("ln1", "ln2", "q_norm", "k_norm", "final_norm"):
            return np.ones(spec.shape, np.float32)
        return (rng.standard_normal(spec.shape) * 0.02).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0))))
    jax_runs = {}
    for mb in (1, 2):
        step = jtrain.make_train_step(jcfg, _jtcfg(mb), donate=False)
        jstate = jtrain.TrainState(params=params, opt=jopt.adamw_init(params),
                                   error_feedback=())
        runs = []
        for s in range(TRAIN_STEPS):
            jstate, jm = step(jstate, *map(jnp.asarray, _batch(s)))
            runs.append((float(jm["loss"]), jax.tree.map(np.asarray, jstate.params)))
        jax_runs[mb] = runs
    return params, jax_runs


def _tcfg(mb):
    return ttrain.TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, microbatches=mb)


def _jtcfg(mb):
    return jtrain.TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, microbatches=mb)


def _batch(step):
    return TokenPipeline(tconfigs.smoke_config(TRAIN_ARCH).vocab_size, SEQ, BATCH,
                         seed=1).batch_at(step)


def _state(params):
    model = params_from_jax(tconfigs.smoke_config(TRAIN_ARCH), params, device="cpu",
                            trainable=True)
    return ttrain.TrainState(model, topt.adamw_init(list(model.parameters())), [])


def _tensors(state):
    return ([p.detach() for p in state.params.parameters()] + [state.opt.step]
            + state.opt.master + state.opt.mu + state.opt.nu)


@pytest.mark.parametrize("mb", [1, 2])
def test_graphed_train_steps_match_eager_and_jax(graph_route, train_case, mb):
    """TRAIN_STEPS steps through the graph route: the first is the
    capture's warm-up (one capture, one step: the step counter says so),
    the others replays; metrics and every state tensor equal the eager
    route's bit for bit, the loss within LOSS_TOL and the parameters within
    PARAM_TOL of the JAX package's step, and every tensor of the state,
    the step counter included, keeps its address."""
    params, jax_runs = train_case
    cfg = tconfigs.smoke_config(TRAIN_ARCH)
    graphed, eager = _state(params), _state(params)
    addresses = [t.data_ptr() for t in _tensors(graphed)]
    step, eager_step = ttrain.make_train_step(cfg, _tcfg(mb)), \
        ttrain.make_train_step(cfg, _tcfg(mb), eager=True)
    for s in range(TRAIN_STEPS):
        tokens, labels = (torch.from_numpy(a).long() for a in _batch(s))
        out, metrics = step(graphed, tokens, labels)
        eager, want = eager_step(eager, tokens, labels)
        assert out is graphed and len(graph_route) == 1 and int(graphed.opt.step) == s + 1
        assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in want.items()}
        assert all(torch.equal(a, b) for a, b in zip(_tensors(graphed), _tensors(eager),
                                                     strict=True))
        assert [t.data_ptr() for t in _tensors(graphed)] == addresses
        jloss, jparams = jax_runs[mb][s]
        _close(float(metrics["loss"]), jloss, LOSS_TOL)
        for name, p in graphed.params.named_parameters():
            _close(p.detach().numpy(), jax_leaf(jparams, name), PARAM_TOL)
    assert graph_route == [("train", BATCH, SEQ)]


def test_restored_state_is_captured_anew(graph_route, train_case, tmp_path):
    """A checkpoint of the graphed state after two steps, restored into a
    fresh state: the same step function captures that state anew (its
    tensors are not the captured ones), and its next step equals the live
    state's bit for bit, as does the step counter the checkpoint kept."""
    params, _ = train_case
    cfg = tconfigs.smoke_config(TRAIN_ARCH)
    step = ttrain.make_train_step(cfg, _tcfg(1))
    live = _state(params)
    for s in range(2):
        live, _ = step(live, *(torch.from_numpy(a).long() for a in _batch(s)))
    store.save_checkpoint(str(tmp_path), 1, live)
    restored, at, _ = store.restore_checkpoint(str(tmp_path), _state(params))
    assert at == 1 and int(restored.opt.step) == int(live.opt.step) == 2
    assert len(graph_route) == 1
    batch = [torch.from_numpy(a).long() for a in _batch(2)]
    restored, got = step(restored, *batch)
    assert len(graph_route) == 2
    live, want = step(live, *batch)
    assert len(graph_route) == 2  # the live state's graph, replayed
    assert float(got["loss"]) == float(want["loss"]) and int(restored.opt.step) == 3
    assert all(torch.equal(a, b) for a, b in zip(_tensors(restored), _tensors(live),
                                                 strict=True))
