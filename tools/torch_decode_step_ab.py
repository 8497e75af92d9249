"""Decode-lane host cost of two trees of the port, on one card, in turns.

Each arm is a checkout of the repo (a directory holding
``paddle_tpu_torch/`` and ``chip_smoke.py``).  The arms run in turns,
A B B A A B B A for two, each turn a fresh process that imports the
port from its arm's directory and, on ``CUDAPlace(0)``:

1. serves ``chip_smoke.py``'s decode cell (``GPTConfig()``, 16 seeded
   prompts of 8-512 tokens, 32 new tokens each) on one captured
   ``DecodeEngine`` (8 slots, pages of 16, max_len 1024), warmed up
   first, ``--runs`` times: generated tokens/s a run, the program runs'
   host seconds (``step_seconds``: the decode step's p50/p95), and the
   scheduler's whole iteration (``_step_once``, timed from outside) for
   the iterations that ran one decode step and no prefill chunk.  Where
   the arm has request tracing (``observability/reqtrace.py``), the
   runs alternate ``FLAGS_reqtrace`` on and off inside the process and
   each half is reported apart;
2. profiles one more run of it with ``torch.profiler`` (the card's
   activity only: the scheduler thread launches the graphs; tracing at
   its default): summed device ms, and the idle share against the
   profiled wall and against the unprofiled runs' median wall;
3. runs ``chip_smoke.profile_decode_step`` of the arm (the decode step
   run directly on an executor, no engine: the ``decode step`` line of
   phase 6).

Usage (on a machine with the card; the parent commit unpacked into a
directory git ignores)::

    git archive <parent> | tar -x -C <dir>
    python3 tools/torch_decode_step_ab.py parent=<dir> change=. \
        --out ab.json

Prints one JSON line a process (``AB <label> {...}``), then a summary
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_ARM = r"""
import json, os, sys, time
root = os.path.abspath(sys.argv[1]); runs = int(sys.argv[2])
sys.path.insert(0, root)
os.chdir(root)
import numpy as np
import torch
import chip_smoke as cs
from paddle_tpu_torch import fluid
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import DecodeEngine
import paddle_tpu_torch

assert os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__)) == \
    os.path.join(root, "paddle_tpu_torch")
assert torch.cuda.is_available()
cfg = cs._model_config()
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
startup.random_seed = cs.SEED
scope = fluid.Scope()
fluid.Executor(cs._gpu_place()).run(startup, scope=scope)
lens, prompts = cs._lane_workload(cfg)
eng = DecodeEngine(cfg, scope=cs._copy_scope(scope), place=cs._gpu_place(),
                   pool_slots=8, page_size=16, max_len=1024,
                   auto_start=False, max_queue=len(prompts), name="ab")
eng.warmup()
torch.cuda.synchronize()

# the scheduler's whole iteration, timed from outside; kind by what it
# ran: decode-only, prefill (+ maybe decode), or nothing
iters = []
inner = eng._step_once


def timed():
    s0, c0 = eng._steps, eng._chunks
    t0 = time.perf_counter()
    inner()
    dt = time.perf_counter() - t0
    iters.append((dt, eng._steps - s0, eng._chunks - c0))


eng._step_once = timed
eng.start()


def one_run():
    n0 = len(eng.step_seconds)
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    outs = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, eng.step_seconds[n0:]


try:
    from paddle_tpu_torch.observability import reqtrace  # noqa: F401
    traced = True
except ImportError:
    traced = False
q = lambda a: dict(p50_ms=1e3 * float(np.percentile(a, 50)),
                   p95_ms=1e3 * float(np.percentile(a, 95)))
ref, halves = None, {}
for i in range(runs):
    label = ("trace_on" if i % 2 == 0 else "trace_off") if traced else "all"
    if traced:
        fluid.set_flags({"FLAGS_reqtrace": label == "trace_on"})
    del iters[:]
    outs, wall, st = one_run()
    ref = ref or outs
    assert outs == ref, "ids differ between runs"
    h = halves.setdefault(label, {"walls": [], "steps": [], "dec": []})
    h["walls"].append(wall)
    h["steps"].extend(st)
    h["dec"].extend(dt for dt, s, c in iters if s == 1 and c == 0)
if traced:
    fluid.set_flags({"FLAGS_reqtrace": True})
gen = sum(len(o) for o in ref)
out = dict(root=sys.argv[1], runs=runs, generated_tokens=gen,
           decode_steps_a_run=len(st))
for label, h in halves.items():
    med_wall = float(np.median(h["walls"]))
    out[label] = dict(
        generated_tokens_per_s=[gen / w for w in h["walls"]],
        median_generated_tokens_per_s=gen / med_wall,
        median_wall_s=med_wall,
        decode_program_run=q(h["steps"]),
        decode_only_iteration=q(h["dec"]),
        decode_only_iterations=len(h["dec"]),
        host_outside_program_ms_p50=(
            1e3 * float(np.percentile(h["dec"], 50))
            - 1e3 * float(np.percentile(h["steps"], 50))))
med_wall = float(np.median([w for h in halves.values()
                            for w in h["walls"]]))

from torch.profiler import ProfilerActivity, profile
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    outs, _, _ = one_run()
    pwall = time.perf_counter() - t0
assert outs == ref
dev_us = 0.0
for e in prof.key_averages():
    if str(getattr(e, "device_type", "")).endswith("CUDA"):
        dev_us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0) or 0)
out["engine_run_profiled"] = dict(
    wall_ms=1e3 * pwall, device_busy_ms=dev_us / 1e3,
    idle_share=1 - dev_us / 1e3 / (1e3 * pwall),
    idle_share_vs_unprofiled_wall=1 - dev_us / 1e3 / (1e3 * med_wall))
eng.close()
del eng
torch.cuda.empty_cache()
lane = cs.profile_decode_step(cfg, scope)["captured"]
out["lane_decode_step_captured"] = {
    k: lane[k] for k in ("step_wall_ms", "wall_profiled_ms",
                         "device_busy_ms", "device_idle_share")}
print("AB " + json.dumps(out), flush=True)
"""


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arms", nargs="+", help="LABEL=DIR")
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--out", help="write every reading here as JSON")
    args = ap.parse_args(argv)
    arms = [a.split("=", 1) for a in args.arms]
    order = (arms + arms[::-1]) * 2
    smi = _smi()
    results = {lab: [] for lab, _ in arms}
    for lab, d in order:
        env = {k: v for k, v in os.environ.items()
               if k != "PYTHONPATH" and not k.startswith("FLAGS_")}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _ARM, d,
                               str(args.runs)], env=env, text=True,
                              capture_output=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode or not lines:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"arm {lab} ({d}) failed: rc {proc.returncode}")
        got = json.loads(lines[-1][3:])
        got["process_s"] = time.perf_counter() - t0
        print(f"AB {lab} {json.dumps(got)}", flush=True)
        results[lab].append(got)
    summary = {"card": smi}
    for lab, rs in results.items():
        summary[lab] = {}
        for half in ("all", "trace_on", "trace_off"):
            hs = [r[half] for r in rs if half in r]
            if not hs:
                continue
            summary[lab][half] = {
                "tokens_per_s": [h["median_generated_tokens_per_s"]
                                 for h in hs],
                "program_run_p50_p95_ms": [
                    list(h["decode_program_run"].values()) for h in hs],
                "decode_iteration_p50_p95_ms": [
                    list(h["decode_only_iteration"].values()) for h in hs],
                "host_outside_program_ms_p50": [
                    h["host_outside_program_ms_p50"] for h in hs]}
        summary[lab]["engine_idle_share"] = [
            [r["engine_run_profiled"]["idle_share"],
             r["engine_run_profiled"]["idle_share_vs_unprofiled_wall"]]
            for r in rs]
        summary[lab]["lane_step_ms_idle"] = [
            [r["lane_decode_step_captured"]["step_wall_ms"],
             r["lane_decode_step_captured"]["device_idle_share"]]
            for r in rs]
    print("AB summary " + json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "results": results,
                       "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
