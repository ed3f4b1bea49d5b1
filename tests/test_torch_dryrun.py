"""The port's dry runs (``launch/dryrun.py``, ``dryrun_bst.py``, ``perf.py``)
against the JAX package's, and what they stand on: ``SHAPES``,
``cell_is_runnable``, ``all_configs`` and the kernels' shapes-only route.

A dry run makes a fake default process group, which is process-global, so
each one runs in a subprocess of its own (the port's imports neither JAX
nor the JAX package, which the subprocess checks); the JAX package's side
runs in another, on 8 forced CPU devices.  The tiny cell is the JAX
package's own test's (``tests/test_distributed.py``'s dry-run cell): the
smoke qwen3 in bf16 with remat and logit chunks of 16, mesh (pod 2, data 2,
model 2), sequence 64, global batch 8; the JAX side runs its blockwise
attention, the port its K5 (the shapes-only route).

What the tiny cell holds, for train, prefill and decode:

* ``argument_size_in_bytes``: equal up to the tokens, which differ by
  design and by an exact amount: the port's are int64 and every rank is
  given the global batch (each step cuts its rows), where the JAX
  package's are int32 and cut per device; and its decode state holds one
  int32 position where the JAX package's caches hold one int32 length a
  layer.
* every collective kind the port reports appears in the JAX package's
  partitioned HLO (their counts and bytes are printed side by side: XLA
  all-reduces the bf16 activations in fp32 and fuses some sums);
* the port's matrix-product FLOPs equal an analytic count written here;
  XLA's FLOPs are printed beside them, not held (XLA counts elementwise
  work too, and a scanned layer's once).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.config import SHAPES as J_SHAPES  # noqa: E402
from repro.models.config import cell_is_runnable as j_cell_is_runnable  # noqa: E402
from repro_torch.configs import ARCH_IDS, all_configs  # noqa: E402
from repro_torch.core import delta as delta_lib  # noqa: E402
from repro_torch.core.tree import build_tree  # noqa: E402
from repro_torch.data.keysets import make_tree_data  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.config import SHAPES, cell_is_runnable  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def _start(code: str, *args: str, forced_devices: int = 0, **env_extra) -> subprocess.Popen:
    """``code`` in a fresh interpreter with the repo's ``src`` on the path,
    started (``_result`` waits for it): every subprocess of the file runs
    at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env_extra)
    if forced_devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={forced_devices}"
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    """The one JSON object a started run prints as its last line."""
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert proc.returncode == 0, f"STDOUT:\n{stdout[-4000:]}\nSTDERR:\n{stderr[-4000:]}"
    return json.loads(stdout.strip().splitlines()[-1])


# The port's side ends every run with this: what it imported of JAX and of
# the JAX package (nothing), and the kernels' launch counts (none).
_PORT_EPILOGUE = """
from repro_torch.kernels import bst_search, flash_attention, queue_dispatch
out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
out["launches"] = sum(sum(d.values()) for d in (bst_search.LAUNCHES, flash_attention.LAUNCHES,
                                                queue_dispatch.LAUNCHES))
print(json.dumps(out))
"""


def _port_checks(out: dict) -> None:
    assert out["imported"] == [], out["imported"]
    assert out["launches"] == 0


# ------------------------------------------------------ shapes and configs
def test_shapes_runnable_cells_and_all_configs_match_jax():
    """``SHAPES`` field for field, ``cell_is_runnable`` (flag and reason) for
    all 10 x 4 cells, and ``all_configs`` (every field the port keeps;
    ``attention_impl`` names each package's own kernels)."""
    assert list(SHAPES) == list(J_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(J_SHAPES[name])
    assert ARCH_IDS == J_ARCH_IDS
    ported, reference = all_configs(), j_all_configs()
    assert list(ported) == list(reference)
    for arch, cfg in ported.items():
        jcfg = reference[arch]
        for f in dataclasses.fields(cfg):
            if f.name != "attention_impl":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (arch, f.name)
        for name, shape in SHAPES.items():
            assert cell_is_runnable(cfg, shape) == j_cell_is_runnable(jcfg, J_SHAPES[name]), (
                arch, name)


# ------------------------------------------------- the shapes-only route
def _tree_operands():
    keys, values = make_tree_data(127, seed=0)
    tree = build_tree(keys, values, device="cpu")
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.choice(np.concatenate([keys, keys + 1]), 96).astype(np.int32))
    return tree, q


def _k1(ordered, delta):
    def call():
        tree, q = _tree_operands()
        fn = ops.bst_ordered_forest if ordered else ops.bst_search_forest
        d = delta_lib.operands(delta_lib.empty(16, "cpu")) if delta else None
        return fn, (tree.keys[None], tree.values[None], q[None], tree.height), {"delta": d}
    return call


def _k3(ordered, mapping):
    def call():
        tree, q = _tree_operands()
        return ops.bst_hybrid_forest, (tree.keys, tree.values, q, tree.height, 2), {
            "mapping": mapping, "capacity": 16, "ordered": ordered}
    return call


def _k4():
    dest = torch.from_numpy(np.random.default_rng(1).integers(-1, 8, (3, 100)).astype(np.int32))
    return ops.queue_dispatch, (dest, 8, 20), {}


def _k5(grad):
    def call():
        gen = torch.Generator().manual_seed(2)
        q = torch.randn(6, 20, 16, generator=gen, requires_grad=grad)
        k = torch.randn(3, 24, 16, generator=gen, requires_grad=grad)
        v = torch.randn(3, 24, 16, generator=gen, requires_grad=grad)
        return ops.flash_attention, (q, k, v), {"causal": True, "window": 7}
    return call


# name -> (the call's builder, the plain versions it must reach on real
# tensors, the entry point's first, the kernels the shapes-only route
# records, whether to run the backward too)
ROUTES = {
    "K1 membership": (_k1(False, False), ("bst_search_ref",), ("forest_descend",), False),
    "K1 ordered": (_k1(True, False), ("bst_ordered_ref",), ("forest_descend",), False),
    "K2 forest": (_k1(True, True), ("bst_ordered_ref",), ("forest_descend_delta",), False),
    "K3 queue": (_k3(True, "queue"), ("bst_hybrid_ref",), ("hybrid_descend",), False),
    "K3 direct membership": (_k3(False, "direct"), ("bst_hybrid_ref",), ("hybrid_descend",),
                             False),
    "K4": (_k4, ("queue_dispatch_ref",), ("queue_dispatch",), False),
    "K5 serving": (_k5(False), ("flash_attention_ref",), ("flash_attention",), False),
    "K5 and its backward": (_k5(True), ("flash_attention_lse_ref", "flash_attention_bwd_ref"),
                            ("flash_attention", "flash_attention_bwd"), True),
}
_PLAIN = ("bst_search_ref", "bst_ordered_ref", "bst_hybrid_ref", "queue_dispatch_ref",
          "flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref")


def _outputs(fn, args, kwargs, backward):
    out = fn(*args, **kwargs)
    outs = list(out) if isinstance(out, tuple) else [out]
    if backward:
        out.float().sum().backward()
        outs += [a.grad for a in args[:3]]
    return outs


@pytest.mark.parametrize("route", list(ROUTES))
def test_shapes_only_route_gives_the_plain_versions_shapes(route, monkeypatch):
    """On fake tensors each entry point returns exactly the shapes and
    dtypes the plain version returns on the same real CPU tensors, runs no
    plain version and records its kernel's work; on the real tensors it
    runs the plain version (no fallback either way)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    build, plain, kernels, backward = ROUTES[route]
    calls = []
    for name in _PLAIN:
        real = getattr(ref, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(ref, name, counted)

    fn, args, kwargs = build()
    want = _outputs(fn, args, kwargs, backward)
    assert calls[0] == plain[0] and set(plain) <= set(calls), calls  # (one plain version calls another)
    assert all(not isinstance(t, FakeTensor) for t in want)
    calls.clear()
    ops.reset_shape_work()
    fn, args, kwargs = build()
    with FakeTensorMode() as mode:
        fake_args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args)
        if "delta" in kwargs and kwargs["delta"] is not None:
            kwargs["delta"] = tuple(mode.from_tensor(t) for t in kwargs["delta"])
        got = _outputs(fn, fake_args, kwargs, backward)
    assert calls == []
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(isinstance(t, FakeTensor) for t in got)
    assert sorted(ops.SHAPE_WORK) == sorted(kernels)
    assert all(row["calls"] == 1 and row["bytes"] > 0 for row in ops.SHAPE_WORK.values())


# ----------------------------------------------------------- the tiny cell
_TINY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")

_PORT_TINY = """
import dataclasses, json, sys
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.models.config import SHAPES
cfg = dataclasses.replace(smoke_config("qwen3_1p7b"), dtype="bfloat16", remat=True,
                          logit_chunk=16)
out = {}
for name in %r:
    shape = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=8)
    out[name] = DR.trace_cell(cfg, shape, {"pod": 2, "data": 2, "model": 2})
""" % (_TINY_SHAPES,) + _PORT_EPILOGUE

_JAX_TINY = """
import dataclasses, json
from repro.launch import dryrun as DR
from repro.configs import smoke_config
from repro.models.config import SHAPES
from repro.sharding.compat import make_mesh
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = dataclasses.replace(smoke_config("qwen3_1p7b"), dtype="bfloat16",
                          attention_impl="blockwise", remat=True, logit_chunk=16)
out = {}
for name in %r:
    shape = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=8)
    with mesh:
        c = DR.build_lowered(cfg, shape, mesh).compile()
    out[name] = {"memory_analysis": DR._mem_analysis(c), "cost_analysis": DR._cost_analysis(c),
                 "collectives": DR.collective_bytes(c.as_text())}
print(json.dumps(out))
""" % (_TINY_SHAPES,)


@pytest.fixture(scope="module")
def tiny_cell(runs):
    port = runs["port tiny"]
    _port_checks(port)
    return port, runs["jax tiny"]


def _tiny_counts(name: str):
    """The tiny cell's analytic matrix-product FLOPs a rank, and the bytes
    by which the port's arguments exceed the JAX package's."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config("qwen3_1p7b")
    D, H, KV, hd, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                             cfg.d_ff, cfg.vocab_size, cfg.n_layers)
    m, ndp, B, S = 2, 4, 8, 64  # model axis, data-parallel ranks, global batch, sequence
    rows = B // ndp  # each rank's rows (the batch splits over pod x data)
    # a layer's products on a rank (heads, kv heads and FFN split over model;
    # the odd vocab of 503 is not, so the head is whole): q, k, v in, o out,
    # then gate, up and down
    per_token = 2 * (D * (H // m) * hd + 2 * D * (KV // m) * hd + (H // m) * hd * D
                     + 3 * D * (F // m))
    down = 2 * (F // m) * D
    if name == "train_4k":
        T = rows * S
        # forward, remat's recompute (which stops before the last product, the
        # down projection: nothing after it is saved), and two products a
        # product in the backward; the tied head in chunks of 16, each
        # chunk's logits recomputed too
        layers = L * T * (4 * per_token - down)
        head = 4 * 2 * T * D * V
        extra = 2 * (B * S * 8 - rows * S * 4)  # tokens and labels
        return layers + head, extra
    if name == "prefill_32k":
        # the layers over the prompt, the head at the last position
        return L * rows * S * per_token + 2 * rows * D * V, B * S * 8 - rows * S * 4
    # decode: one token; the cache's attention is two batched products over
    # the S slots of each of this rank's kv heads (group 1)
    attn = 2 * 2 * rows * (KV // m) * S * hd
    return L * (rows * per_token + attn) + 2 * rows * D * V, (B * 8 - rows * 4) + (4 - 4 * L)


@pytest.mark.parametrize("name", _TINY_SHAPES)
def test_tiny_cell_matches_the_jax_packages(name, tiny_cell):
    """The JAX package's dry-run test cell through both packages: the
    arguments equal up to the tokens (the difference stated and computed
    in ``_tiny_counts``), every collective kind the port makes present in
    XLA's, the matrix products' FLOPs equal the analytic count."""
    port, jax_out = tiny_cell
    got, want = port[name], jax_out[name]
    flops, extra = _tiny_counts(name)
    assert (got["memory_analysis"]["argument_size_in_bytes"]
            - want["memory_analysis"]["argument_size_in_bytes"]) == extra
    kinds = [k for k, v in got["collectives"].items() if isinstance(v, dict)
             and "count" in v and v["count"]]
    assert kinds, got["collectives"]
    for kind in kinds:
        print(f"{name} {kind}: port {got['collectives'][kind]}, "
              f"JAX {want['collectives'][kind]}")
        assert want["collectives"][kind]["count"] > 0, (kind, want["collectives"])
    assert got["cost_analysis"]["matmul_flops"] == flops
    print(f"{name}: port FLOPs {got['cost_analysis']['flops']} ({flops} in matrix products), "
          f"XLA's {want['cost_analysis'].get('flops')}; peak a rank: port "
          f"{got['memory_analysis']['peak_per_device_bytes']}, "
          f"JAX {want['memory_analysis']['peak_per_device_bytes']}")


# --------------------------------------------- full-width production cells
# One cell a family, each cheap to trace (the SSD families' train and prefill
# cells loop over hundreds of scan chunks a layer).
FAMILY_CELLS = {
    "dense": ("qwen3_1p7b", "decode_32k"),
    "moe": ("mixtral_8x7b", "long_500k"),
    "ssm": ("mamba2_1p3b", "long_500k"),
    "hybrid": ("hymba_1p5b", "long_500k"),
    "encdec": ("seamless_m4t_medium", "long_500k"),
    "vlm": ("internvl2_2b", "decode_32k"),
}

_PORT_CELLS = """
import json, sys
from repro_torch.launch import dryrun as DR
cells = json.loads(sys.argv[1])
out = {}
with DR.fake_group(DR.world_of("single")):
    for family, (arch, shape) in cells.items():
        out[family] = DR.run_cell(arch, shape, "single", save=False)
""" + _PORT_EPILOGUE


@pytest.fixture(scope="module")
def production_cells(runs):
    out = runs["port cells"]
    _port_checks(out)
    return out


@pytest.mark.parametrize("family", list(FAMILY_CELLS))
def test_production_cell_per_family(family, production_cells):
    """A full-width cell of each family on the 256-rank single mesh ends ok
    or skipped as the JAX package's ``cell_is_runnable`` says, an ok one
    with a peak, FLOPs and its arguments a rank."""
    arch, shape = FAMILY_CELLS[family]
    rec = production_cells[family]
    runnable, reason = j_cell_is_runnable(jget_config(arch), J_SHAPES[shape])
    assert rec["status"] == ("ok" if runnable else "skipped"), rec.get("traceback")
    if not runnable:
        assert rec["skip_reason"] == reason
        return
    ma = rec["memory_analysis"]
    assert ma["peak_per_device_bytes"] >= ma["argument_size_in_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collectives"]["total_count"] > 0


# ------------------------------------------------------------ the BST lookup
_PORT_BST = """
import json, sys
from repro_torch.launch import dryrun as DR, dryrun_bst
from repro_torch.launch.mesh import make_host_mesh
out = {}
with DR.fake_group(8):
    mesh = make_host_mesh(model=4, device_type="cpu")
    for frac in (1.0, 0.5):
        out[str(frac)] = dryrun_bst.lookup_record(mesh, "host", 32767, 1024, frac)
""" + _PORT_EPILOGUE

_JAX_BST = """
import json
from repro.launch import dryrun as DR
from repro.launch import dryrun_bst
from repro.sharding.compat import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for frac in (1.0, 0.5):
    with mesh:
        lowered, _, _ = dryrun_bst.build_lookup_lowered(mesh, 32767, 1024, frac)
        out[str(frac)] = DR.collective_bytes(lowered.compile().as_text())
print(json.dumps(out))
"""


def test_dryrun_bst_all_to_alls_match_jax_plus_the_drain_round(runs):
    """The BST lookup at 32,767 nodes and 1,024 keys a rank on mesh (data 2,
    model 4): at a capacity of the local batch the port's all-to-all bytes
    equal the JAX package's (one round: the keys, their live mask, the
    values and the found flags, each (M, C) int32); at half of it the
    JAX package's dry run runs its one capped round, the port its sharded
    server's rounds: the capped one, its stall round at the same depth,
    and the drain round at the local batch, which the port always runs
    behind a capped round (the JAX package's server only when a key is
    left: ``src/repro/core/distributed.py``'s ``lax.cond``)."""
    from repro_torch.core.distributed import STALL_ROUNDS

    port, jax_out = runs["port bst"], runs["jax bst"]
    _port_checks(port)
    M, B = 4, 1024
    for frac in ("1.0", "0.5"):
        got = port[frac]["collectives"]["all-to-all"]
        want = jax_out[frac]["all-to-all"]
        cap = int(B * float(frac))
        round_bytes = 4 * M * cap * 4
        assert want == {"count": 4, "bytes": round_bytes}, want
        if cap == B:
            assert got == want
            assert port[frac]["rounds"] == [B]
        else:
            drain = 4 * M * B * 4
            assert port[frac]["rounds"] == [cap] * (1 + STALL_ROUNDS) + [B]
            assert got == {"count": 4 * (2 + STALL_ROUNDS),
                           "bytes": want["bytes"] * (1 + STALL_ROUNDS) + drain}
        assert port[frac]["kernels"]["queue_dispatch"]["calls"] == len(port[frac]["rounds"])
        assert port[frac]["kernels"]["forest_descend"]["calls"] == len(port[frac]["rounds"])
        assert port[frac]["keys_per_sec_bound"] > 0


# ----------------------------------------------------------------- perf.py
_PORT_PERF = """
import dataclasses, json, os, sys
from repro_torch.launch import dryrun as DR, perf
# the reduced shape: the cell's config at 2 layers, a 256-token sequence
# (the global batch, 256, still splits over the 16 data ranks and the 32
# dispatch groups)
DR.SHAPES["train_4k"] = dataclasses.replace(DR.SHAPES["train_4k"], seq_len=256)
full = DR.get_config
DR.get_config = lambda arch: dataclasses.replace(full(arch), n_layers=2)
records = perf.main(["--iter", "1"])
with open(os.path.join(DR.RESULT_DIR, "mixtral_8x7b_train_4k_single__moegroups32.json")) as f:
    saved = json.load(f)
out = {"records": records, "saved": saved}
""" + _PORT_EPILOGUE


def test_perf_iteration_runs_at_a_reduced_shape(runs):
    """``launch/perf.py --iter 1`` (its table key for key the JAX package's)
    traces mixtral-8x7b's train cell with 32 dispatch groups at a reduced
    shape and writes the tagged record."""
    from repro.launch import perf as jperf
    from repro_torch.launch import perf

    assert perf.ITERATIONS == jperf.ITERATIONS
    out = runs["port perf"]
    _port_checks(out)
    (rec,) = out["records"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["tag"] == "moegroups32" and rec["variant"] == {"moe_groups": "32"}
    assert rec["seq_len"] == 256
    assert out["saved"] == rec
    assert rec["cost_analysis"]["kernels"]["queue_dispatch"]["calls"] > 0


# ---------------------------------------------------------------- the runs
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the file, started at once and waited for."""
    started = {
        "port tiny": _start(_PORT_TINY),
        "jax tiny": _start(_JAX_TINY, forced_devices=8),
        "port cells": _start(_PORT_CELLS, json.dumps(FAMILY_CELLS)),
        "port bst": _start(_PORT_BST),
        "jax bst": _start(_JAX_BST, forced_devices=8),
        "port perf": _start(_PORT_PERF, DRYRUN_OUT=str(tmp_path_factory.mktemp("dryrun"))),
    }
    return {name: _result(proc) for name, proc in started.items()}
