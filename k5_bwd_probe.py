"""K5's backward with dQ in a fixed order, against the parent's, on the card.

Builds the parent commit's ``flash_attention_bwd.cu`` (its ``csrc/`` under
``--parent``, e.g. a ``git archive`` of the parent unpacked into
``build/parent``) into a library of its own beside this tree's, and:

1. times both bf16 backwards at ``chip_smoke.BWD_TIMED``'s shapes (qwen3-1.7b's
   and hymba-1.5b's training attention), and this tree's with the dQ
   writer's wait for its turn cut out (``NO_WAIT``: what the waits cost),
   the whole call and the main kernel alone, in turns parent, new, no-wait,
   no-wait, new, parent (``chip_smoke.ColdTimer``: CUDA events, L2
   flushed), with each one's error against the plain version and whether
   four calls give the same bits;
2. runs one eager bf16 train step of qwen3-1.7b (4 x 2048) and of mixtral-8x7b
   cut to 2 layers (4 x 512) under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` and lists what torch warns of, then restores the setting;
3. runs each of those steps twice from the seed-0 state on the default
   algorithms and compares the metrics and every parameter bit for bit, and
   where they differ, the gradients of one forward and backward pass, by name;
4. calls the backward of ``index_select`` with repeated indices (attention's
   head gather where a block cuts a head) five times at hymba-1.5b's shapes
   and compares the bits.

    python3 k5_bwd_probe.py --parent build/parent/src/repro_torch/kernels/csrc

Prints one JSON line last; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
import warnings
from pathlib import Path

import chip_smoke as cs  # the repo's smoke: its timer, operands and shapes
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import model as lm
from repro_torch.training.train_loop import init_train_state, make_train_step

_P, _I = ctypes.c_void_p, ctypes.c_int


# This tree's backward without dQ's order: the dQ writer no longer waits
# for its turn (the adds land in whatever order the CTAs reach them).  Its
# time beside this tree's is what the waits cost.
NO_WAIT = ("        if (lane == 0) wait_turn(sem, kv_tile - first_kv_tile(qt, kBwdN, offset, "
           "window));\n")


def bwd_library(csrc: Path, name: str, drop: str = "") -> tuple:
    """``csrc``'s ``flash_attention_bwd.cu`` alone (``drop`` cut out of it
    once), built with this tree's flags: (the library, whether its C entry
    takes dQ's semaphores)."""
    out = Path(cs.ROOT) / "build" / "k5_probe" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in ("flash_attention_bwd.cu", "hopper.cuh"):
        text = (csrc / f).read_text()
        if drop and f.endswith(".cu"):
            assert text.count(drop) == 1, f"{name}: the line to drop is not in the source once"
            text = text.replace(drop, "")
        (out / f).write_text(text)
    cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-shared", "-o", str(out / "lib.so"), str(out / "flash_attention_bwd.cu")]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{run.stdout}\n{run.stderr}")
    resources = cs.ptxas_resources(run.stdout + run.stderr)
    cs.log(f"ptxas, {name}: { {k: v for k, v in resources.items() if 'bf16' in k} }")
    with_sems = "void* sems" in (out / "flash_attention_bwd.cu").read_text()
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.flash_attention_bwd.argtypes = [_P] * (11 + with_sems) + [_I] * 8 + [ctypes.c_float, _I, _P]
    lib.flash_attention_bwd.restype = _I
    return lib, with_sems


def c_call(built, q, k, v, out, dout, lse, causal, window):
    """A built backward's C entry on one launch, with the scratch its
    source takes: (dq, dk, dv, launch(stages))."""
    lib, with_sems = built
    BH, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if with_sems:
        scratch = FA.bwd_scratch(q, dq)
    else:  # the parent's: dq_acc shaped as q, delta
        scratch = (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                   torch.empty((BH, 2 * -(-Sq // 64) * 64), dtype=torch.float32, device=q.device))

    def launch(stages):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(t.data_ptr() for t in scratch), BH, BHkv, Sq, Skv, d, 1, int(causal), window or 0,
            d ** -0.5, stages, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    return dq, dk, dv, launch


def rel_norm(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def time_backwards(libs: dict, timer) -> list:
    """Per BWD_TIMED shape: each library's backward (``libs``: name ->
    ``bwd_library``) and this tree's through its wrapper, whole and the
    main kernel alone, in turns; errors against the plain version; whether
    four calls give the same bits."""
    rows = []
    for idx, label in cs.BWD_TIMED:
        shape = cs.FLASH_SHAPES[idx]
        _, _, _, _, _, causal, window = shape
        q, k, v, dout = cs.bwd_operands(shape, torch.bfloat16, seed=98)
        out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window)
        whole, main, grads = {}, {}, {}
        for name, built in libs.items():
            *g, launch = c_call(built, q, k, v, out, dout, lse, causal, window)
            launch(7)
            grads[name] = [[t.clone() for t in g]]
            for _ in range(3):
                launch(7)
                grads[name].append([t.clone() for t in g])
            whole[name], main[name] = functools.partial(launch, 7), functools.partial(launch, 2)
        new = functools.partial(FA.flash_attention_bwd_cuda, q, k, v, out, dout, lse,
                                causal=causal, window=window)
        grads["new"] = [new() for _ in range(4)]
        _, stages = FA.bwd_stage_calls(q, k, v, out, dout, lse, causal=causal, window=window)
        whole["new"], main["new"] = new, stages["main"]
        order = ["parent", "new", "no_wait"]
        times = {f"{n}{part}": [] for n in order for part in ("", "_main")}
        for name in order + order[::-1]:
            times[name].append(timer(whole[name]))
            times[f"{name}_main"].append(timer(main[name]))
        row = {"config": label, "shape": list(shape), "times_ms": times,
               "ratio": min(times["new"]) / min(times["parent"]),
               "main_ratio": min(times["new_main"]) / min(times["parent_main"]),
               "wait_ms": min(times["new_main"]) - min(times["no_wait_main"]),
               "rel_norm_err": {name: {n: rel_norm(a, w) for n, a, w in zip("qkv", g[0], want)}
                                for name, g in grads.items()},
               "repeats_equal": {name: all(torch.equal(a, b) for r in g[1:] for a, b in zip(r, g[0]))
                                 for name, g in grads.items()}}
        cs.log(f"  {label} {shape}: {json.dumps(row)}")
        rows.append(row)
    return rows


def step_inputs(cfg, batch: int, seq: int):
    pipe = TokenPipeline(cfg.vocab_size, seq, batch)
    return [cs.batch_on_card(pipe, s) for s in range(2)]


def deterministic_warnings(cfg, batches) -> list:
    """What torch warns of over one eager step under its deterministic mode."""
    tcfg = cs.train_tcfg()
    state = init_train_state(cfg, tcfg, seed=0, device="cuda")
    step = make_train_step(cfg, tcfg, eager=True)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(state, *batches[0])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    del state, step
    torch.cuda.empty_cache()
    return sorted({str(w.message).strip().splitlines()[0][:300] for w in caught})


def rerun_bits(cfg, batches) -> dict:
    """Two eager runs of two steps from the seed-0 state, and where they
    differ, two forward and backward passes' gradients by name."""
    tcfg = cs.train_tcfg()
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, tcfg, seed=0, device="cuda")
        step = make_train_step(cfg, tcfg, eager=True)
        metrics = []
        for b in batches:
            state, m = step(state, *b)
            metrics.append({k: float(x) for k, x in m.items()})
        runs.append((metrics, cs.host_copies(state.params.parameters())))
        del state, step
        torch.cuda.empty_cache()
    out = {"metrics": [r[0] for r in runs], "metrics_equal": runs[0][0] == runs[1][0],
           "params_equal": all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))}
    if not (out["metrics_equal"] and out["params_equal"]):
        model = lm.init_params(cfg, seed=0, device="cuda", trainable=True)
        grads = []
        for _ in range(2):
            loss, _ = lm.forward_train(cfg, model, *batches[0])
            loss.backward()
            grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
            for p in model.parameters():
                p.grad = None
        out["grads_differ"] = [n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]
        del model
        torch.cuda.empty_cache()
    return out


def head_gather_bits() -> dict:
    """``index_select`` over kv heads with repeated indices (a block that cuts
    a head gathers each kv head for its group's q heads) at hymba-1.5b's
    shapes (4 x 2048, 5 kv heads of 64, group 5): its backward five times."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    k = torch.randn(4, 2048, 5, 64, generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.arange(0, 13, device="cuda") // 5
    g = torch.randn(4, 2048, 13, 64, generator=gen, device="cuda").to(torch.bfloat16)
    grads = []
    for _ in range(5):
        kk = k.detach().requires_grad_()
        kk.index_select(2, idx).backward(g)
        grads.append(kk.grad)
    return {"equal": all(torch.equal(a, grads[0]) for a in grads[1:])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="the parent commit's src/repro_torch/kernels/csrc")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k5_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.log(f"card: {smi}; torch {torch.__version__}")
    built = _build.library()
    resources = cs.ptxas_resources(built.log)
    cs.log(f"ptxas, this tree: { {k: v for k, v in resources.items() if k.startswith('flash_bwd')} }")
    libs = {"parent": bwd_library(args.parent, "parent"),
            "no_wait": bwd_library(Path(_build.CSRC), "no_wait", drop=NO_WAIT)}
    result = {"card": smi, "timing": time_backwards(libs, cs.ColdTimer())}
    qwen = get_config("qwen3-1.7b")
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=2)
    for cfg, batch, seq in ((qwen, 4, 2048), (mixtral, 4, 512)):
        batches = step_inputs(cfg, batch, seq)
        result[cfg.name] = {"deterministic_mode_warns": deterministic_warnings(cfg, batches),
                            "reruns": rerun_bits(cfg, batches)}
        cs.log(f"  {cfg.name}: {json.dumps(result[cfg.name])}")
    result["head_gather"] = head_gather_bits()
    cs.log(f"  head gather: {result['head_gather']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
