#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi).
  2. build: every kernel under paddle_tpu_torch/csrc, one nvcc each, all
     started together, for sm_90a; each kernel's registers, shared
     memory and spills (ptxas), and each flash kernel's tensor-core
     instructions (SASS): the bf16 K1, K2 and K3 (namespace flash_tc)
     are all built, spill nothing and hold HMMA, no SIMT flash kernel
     takes bf16, K7's split instantiations of the int8 decode lane
     (d 64) spill nothing, and no K4 or K6 instantiation spills; the
     SASS instructions an element of each K4 instantiation's main loop
     (cuobjdump), the bf16 one (the train path's) printed alone.
  3. kernels: each kernel's wrapper (K1-K8) on tensors on the card at
     the shapes its path gives it, held against its plain PyTorch
     version; timed against the plain version, its bound and, where one
     PyTorch call computes the same function, that call (library_ms).
     K1-K3 also at a dp replica's shard and at GPT-2 small's causal
     [96, 1024, 64] (both timed; SDPA with is_causal beside the latter)
     and at the bf16 edges: a ragged tile, causal (S 200 and 256), D 32
     and 12, S 1, fully masked rows.  K5 and K7 at the decode step and three prefill
     chunks, each with its split plan and partials workspace, both forms
     held against the plain version and timed in turns, one split
     against split.  K4 also at a dp shard's FFN shape, the MLM
     head's and GPT-2 small's FFN [8192, 3072].  K6 at the Engine path's S 128 and the bucketed arm's S 32
     and 64 (timed, with SDPA beside it), then at D 96 and 128, bf16 at
     D 32 and 64, S 1 and S 1024.  The fp32 K1 (the SIMT kernel) at
     the predictor path's b8 s128, 12 heads, D 64, timed against its
     bound, SDPA in fp32 and the composed matmul / softmax / matmul.
     K8's group
     form over the dp lane's real segment list (BERT-base's 206
     parameters x 4 replicas), held against the plain version member by
     member and timed against the same segments as single launches, its
     bound and torch._fused_adam_ (a yardstick); the word embedding as
     a one-segment group against its single launch, in turns.  The
     launch floor of the timing: a one-cycle device sleep.
  4. train path: BERT-base pretraining (vocab 30528, flash attention,
     hidden dropout 0.1) at b128 s128 under the bf16 dtype policy with
     Adam(1e-4), through the port's fluid.Executor on CUDAPlace(0), in
     its two modes in turns from the same state and feed: captured (the
     default: the step's first run warms up and captures a CUDA graph,
     every later one replays it) and eager (FLAGS_cuda_graph_capture
     off), 2 warm-up and 10 timed steps each.  Losses finite and
     falling; in each mode the card launches exactly 24 (K1: 12 layers,
     forward and the grad op's recompute), 12 (K2, K3) and 13 (K4) per
     step, counted by the kernels themselves (see below); the two modes'
     losses and final state bit-equal; per mode the step p50 / p95,
     MFU against the port's peak table (profiling.device_peaks), peak
     memory and the capture's seconds.  Then a torch.profiler step of
     each mode (device busy, idle share, cudaLaunchKernel and
     cudaGraphLaunch calls) with the step's elementwise device time
     split between the bf16 policy's casts and Adam's kernels, and
     run_steps(10) from the same start: its last loss and state equal
     to the 10th captured run()'s, its kernels launched 10 x a step's
     on the card.
  5. train parity: the same network at full width, 2 layers, b4 s128,
     fp32, dropout 0: 3 Adam steps on the card and on a CPUPlace
     executor from the same parameters.
  6. decode path: GPTConfig() at full width (random weights from the
     port's own startup program, fixed seed) served by DecodeEngine: 16
     seeded requests of 8-512 prompt tokens, 32 new tokens each, on an
     engine whose warmup captures both programs, then on an eager one
     from the same weights: the same ids.  K4 and K5 launch exactly 12
     (layers) x program runs on the card in each, the warmup's
     included.  Decode steps of each mode under
     the profiler, their logprobs bit-equal.
  7. decode parity: the same weights on a CPUPlace executor (plain
     versions): logprobs of prefill chunks and a decode step, and the
     greedy ids of two requests, against the card's.
  8. int8 decode path: phase 6 over the dual-int8 KV pool
     (pool_dtype="int8"): K4 and K7 launch exactly 12 x program runs on
     the card, K5 never; K7's device time summed over whole lane runs,
     one split and split in turns, each run's ids equal to the main
     path's.
  9. int8 decode parity: phase 7 over the int8 pool.
 10. ragged Engine path: the repo's ragged scorer (vocab 8192, hidden
     256, 8 heads, 4 layers, a causal ragged_attention a layer), saved
     with save_inference_model and served by serving.Engine (batch
     bucket 8, sequence buckets 32/64/128) in its ragged and its
     bucketed arm: waves of two requests each of 20, 50, 90 and 126
     tokens, one priming and 10 timed.  Each arm captured (one graph
     the ragged arm, three the bucketed) and then eager: the same
     scores.  K6 launches exactly 4 x the batches each arm ran on the
     card, warmup included; the ragged arm warms one shape and serves with no
     padding rows and no cold run.  Each arm's device busy time over
     one profiled wave, in each mode.
 11. ragged Engine parity: each arm's scores against a CPUPlace engine
     on the same saved model and requests.
 12. data-parallel train path: phase 4's configuration through
     CompiledProgram(...).with_data_parallel(places=[CUDAPlace(0)] * 4)
     with the quantized gradient all-reduce: the global batch b128 s128
     split into four replica shards of b32, 2 warm-up and 5 timed
     steps, captured (the whole lockstep step of the four replicas one
     graph) and eager in turns.  Losses finite and falling; in each
     mode, on the card, K8's group form launches exactly once a
     table-full of the
     plan's group step (the program's fused_adam_quant_grad ops on all
     4 replicas) a step, its per-parameter form never, and K1-K4 4x
     their phase-4 counts; every replica's parameters bit-identical and
     replica 0's the scope's; the two modes' losses and state
     bit-equal; the bucket plan, modeled wire bytes, fused-update bytes
     saved, peak memory and tokens/s (four replicas share one card: not
     a scaling figure); a torch.profiler step of each mode with K8's
     device time against its bound, the beta powers' multi-tensor
     launches and the launch API calls.
 13. data-parallel parity: full width, 2 layers, b8 s128, fp32,
     dropout 0, 3 steps over four replicas on the card and over four
     CPUPlace replicas from the same parameters: the losses, and each
     parameter above the rounding floor by the relative norms of its
     Moment1, Moment2 and change (DP_GRAD_FLOOR); the worst leaf of
     each reading, and the leaves at the floor, are printed.
 14. passes A/B: BERT-base built unfused (use_flash_attention=False, no
     dropout; the reference's passes rung, bench.py:1298-1316) at b128
     s128 under the bf16 policy with Adam(1e-4), one program with
     FLAGS_graph_passes="default" and one with "none", each run by the
     captured and the eager executor, all four in turns from one
     state, 2 warm-up and 6 timed steps.  On arm: the pass report reads
     12 fuse_attention sites (12 with a key bias) and 13
     fuse_bias_act_dropout sites, and K1-K4 launch phase 4's counts a
     step; off arm: none of them.  Each arm's captured and eager losses
     and state bit-equal; per arm and mode the step p50 / p95, peak
     memory, the step's transient memory (eager) and the graph's pool
     (captured), and a profiled step's device busy and idle.  Then full
     width, 2 layers, fp32, b8 s128, 3 steps, passes on against off:
     losses within 1e-4 relative, K1 4, K2 2, K3 2, K4 3 a step on arm.
 15. predictor: BERT-base's encoder built unfused (is_test), saved with
     save_inference_model and served by AnalysisPredictor on the card at
     b8 s128 fp32, passes on and off, each captured and eager, in turns:
     on arm 12 flash_attention ops in the loaded program and K1 and K4
     12 a run on the card (off arm none); captured equal to eager, on
     within 1e-4 of off; run p50 / p95, peak memory, device busy.
 16. int8-weight decode path: phase 6's lane with
     DecodeEngine(int8_weights=True): the weights claimed, the modeled
     bytes saved, ``torch.cuda.memory_allocated()`` an engine adds at
     rest with fp32 and with int8 weights; K4 and K5 12 a program run
     on the card; captured and eager ids equal; the ids equal to phase
     6's counted (not gated); decode steps profiled; logprobs (1e-3) and
     greedy ids against the port's CPU run of the same int8 weights.
 17. GPT train path: GPT-2 small (vocab 50304, hidden 768, 12 layers,
     12 heads, FFN 3072, 1024 positions, hidden dropout 0.1, causal
     flash attention) through build_gpt_lm at b8 s1024 under the bf16
     policy with fp32 masters, AdamW(6e-4, beta2 0.95, weight decay 0.1)
     and GradientClipByGlobalNorm(1.0), the default passes, captured
     and eager in turns from one state and feed, 2 warm-up and 10 timed
     steps each: losses finite and falling, the clip's global norm
     (its sqrt output) finite every step and printed, K1 24, K2 12, K3
     12 and K4 12 launches a step on the card in each mode, the two
     modes' losses, norms and state bit-equal; step p50 / p95,
     tokens/s, MFU (gpt_train_flops_per_step), peak memory, capture
     seconds, one profiled step's busy and idle.  Then the same
     configuration built unfused (use_flash_attention=False), 2 + 3
     steps captured: the pass report reads 12 fuse_attention sites, all
     causal, and K1-K4 launch the counts above.
 18. GPT parity: 2 layers at full width, fp32, dropout 0: the recipe's
     AdamW with the global-norm clip at b2 s1024, then each optimizer
     of the training front end (LarsMomentum, Adagrad, Adamax,
     DecayedAdagrad, Adadelta, RMSProp, Ftrl, Lamb, and Adam with
     L2Decay and GradientClipByValue) at b2 s256, 3 steps on the card
     and on a CPUPlace executor from the same parameters: losses within
     1e-4; Adam's family phase 5's parameter rule, the others each
     parameter's change within 1e-3 of its norm (leaves at the
     gradient's rounding floor printed only); the worst leaf of each.
 19. the serving fleet: two DecodeEngine replicas of phase 6's GPTConfig()
     (pool_slots 8, page 16, max_len 1024; replica 1's scope filled from
     replica 0's arrays; both warmed up, both programs captured, before
     either starts) and a ragged Engine over phase 10's scorer, behind
     one serving.Router and a serving.Frontend on 127.0.0.1 (the OS's
     port).  (1) Phase 6's 16 requests as POST /v1/generate from 4
     client threads: every stream equal to a one-replica generate; a
     model the Engine has not run, loaded then, answers one /v1/infer
     while the decode traffic replays (its graph captured beside the
     live replicas) with the warm model's scores; the HTTP p50 / p99 a
     request (reqtrace), tokens/s through the frontend against the
     one-replica direct generate, and one lone request direct and over
     HTTP.  (2) The failover drill (serving/drill.py) through the
     frontend: replica_kill:replica0 a few decode steps into a loaded
     run; every stream token-exact, failovers and recovery seconds
     booked, no executor-cache miss, the availability SLO's page alert
     fired and cleared, and a failed-over request's trace holds its
     root, serve:replica0 in error and serve:replica1 ok.  (3) The
     hedge drill: two Engines of a small MLP, one slow; the hedge wins
     and every loser is cancelled.  (4) Phase 10's waves as POST
     /v1/infer: scores bit-equal to a direct Engine submit of the same
     feeds.  (5) /healthz, /routerz (the frontend), /servez, /metricsz
     and /tracez (an exposition server) answer 200 with the JAX
     package's top-level keys.  (6) SIGTERM lands in a child process
     (one replica behind a Frontend with install_drain) mid-request:
     the client gets its complete tokens, equal to the child's
     one-replica generate, /healthz answers 503 while draining, and the
     child exits 0 or by SIGTERM.  (7) On the card, K4 and K5 launch
     exactly 12 x the program runs of both replicas (warmups
     included), K6 4 x the Engine's batches, K7 never.

Phases 1-13 also check that this slice's passes (fuse_attention,
fuse_softmax_cross_entropy) match nothing on their programs.  Each
phase's line carries the seconds since the previous one (``phase_s``).

``python3 chip_smoke.py --only k4,k6,k6_contract`` runs phases 1-3 for
the named kernels alone (a quick check of a kernel change; see ONLY);
``--only engine`` adds phases 10-11, ``--only passes,predictor,int8w``
phases 14, 15 and 16 (``predictor`` with phase 3's fp32 K1 at its
shape), ``--only gpt`` phase 3's K1-K4 checks and phases 17-18, and
``--only fleet`` phase 19.

Each path runs with every launch count set to 0 just before it and read
just after; a kernel of the path launched no time fails the run.  Two
counts, both gated exactly: each wrapper's (``.launches``, Python: the
calls that launched its kernel, or recorded it into a graph being
captured; a replay runs no Python, so in the captured mode the wrappers
see each signature's eager warm-up run and its capture only) and each
kernel's own on the card (``kernels.device_launch_counts``: the first
thread of a launch's first block adds one, so it counts every run the
device made, replays included).  The kernels JSON gives both, summed
over each path's two modes (``launches``, ``device_launches``).  The
last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Exits non-zero (and prints no result)
without CUDA or without the package beside it.
"""

import contextlib
import difflib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234

# K5 kernel vs plain: the kernel sums keys page by page with an online
# softmax merged across eight warps and then across splits; the plain
# version takes one softmax over the whole row and one matmul.  Same fp32
# terms, other order.
K5_TOL = dict(atol=2e-5, rtol=1e-4)
# K4 kernel vs plain: the same elementwise formula; erfcf/tanhf in the
# kernel and PyTorch's CUDA erfc/tanh may differ by an ulp.
K4_TOL = dict(atol=1e-6, rtol=1e-6)
# K4 in bf16: kernel and plain version both round the same fp32 value to
# bf16, so they may differ by one bf16 ulp (2^-8 relative)
K4_BF16_TOL = dict(atol=8e-3, rtol=8e-3)
# K1-K3 vs plain: fp32 sums over 64-key (or 64-query) tiles vs one
# matmul; in bf16 both round one fp32 result, so one bf16 ulp apart
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# dBias sums dL over every query: fp32 in both, other order
FLASH_DBIAS_TOL = dict(atol=1e-4, rtol=1e-4)
# full model on the card vs on the CPU: 12 layers of fp32 matmuls summed
# in other orders (cuBLAS vs the CPU BLAS) before a 32000-way log_softmax
PATH_LOGP_ATOL = 1e-3
# BERT training on the card vs the CPU, fp32: per-step losses; and the
# parameters of one layer after 3 Adam steps, where one element's update
# is at most lr in size and its sign can follow a grad that is zero up
# to the two BLAS libraries' rounding: max abs diff within 3 x lr, mean
# abs diff within 1e-6
TRAIN_LOSS_RTOL = 1e-4
TRAIN_LR = 1e-4
TRAIN_PARAM_MAX_ATOL = 3 * TRAIN_LR
TRAIN_PARAM_MEAN_ATOL = 1e-6

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32
# (non-tensor-core) flop/s and bf16 dense tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
GELU_FLOPS_PER_ELEMENT = 10  # add, scale, erfc, mul... as counted in PERF.md
SLEEP_CYCLES = 400_000_000  # ~0.2 s of device sleep ahead of a timed run


def _gpu_place():
    from paddle_tpu_torch import fluid

    return fluid.CUDAPlace(0)


def _model_config():
    """The served model: GPTConfig() at its defaults (vocab 32000, hidden
    768, 12 layers, 12 heads, FFN 3072, 1024 positions)."""
    from paddle_tpu_torch.models import gpt

    return gpt.GPTConfig()


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def launch_floor_ms():
    """What the timing below reads for a kernel that does nothing: a
    one-cycle device sleep, the floor under every small kernel's time."""
    return _time_ms(lambda: torch.cuda._sleep(1), 100)


def _time_ms(fn, iters, flush=None):
    """Mean device time of one fn() call, CUDA events around each call;
    `flush` (run between calls, untimed) evicts L2.  A device sleep is
    queued first, so the host has enqueued every call before the card
    reaches the first: the events then time the card's work, not the
    host's launch overhead (checked: the sleep must outlast the
    enqueueing, so `iters` x the launches of one call must stay within
    the stream's queue of pending work, a few hundred entries)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for a, b in evs:
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if start.elapsed_time(evs[0][0]) <= host_ms:
        raise RuntimeError(f"timing: the device sleep ended before the host "
                           f"finished enqueueing ({host_ms:.2f} ms); raise "
                           f"SLEEP_CYCLES")
    return sum(a.elapsed_time(b) for a, b in evs) / iters


# ---------------------------------------------------------------------------
# the executor's two modes: every path runs captured (the default) and,
# in turns from the same state and feeds, eager
# ---------------------------------------------------------------------------

# (mode, capture): the captured executor replays a CUDA graph per
# signature; the eager one (FLAGS_cuda_graph_capture off) runs the op loop
MODES = (("captured", True), ("eager", False))


@contextlib.contextmanager
def capture_mode(on):
    """Executors made inside (an engine's too) capture their programs
    (FLAGS_cuda_graph_capture on, the default) or run the eager loop."""
    from paddle_tpu_torch import fluid

    old = fluid.get_flags("FLAGS_cuda_graph_capture")
    fluid.set_flags({"FLAGS_cuda_graph_capture": on})
    try:
        yield
    finally:
        fluid.set_flags(old)


def _clone_scope(scope):
    """A scope of copies of ``scope``'s tensors."""
    from paddle_tpu_torch import fluid

    out = fluid.Scope()
    for n in scope.keys():
        out.set(n, scope.get(n).clone())
    return out


def _scope_diff(a, b):
    """Names whose tensors differ (bit for bit) between two scopes."""
    return sorted(n for n in a.keys()
                  if b.get(n) is None or not torch.equal(a.get(n), b.get(n)))


def _snap():
    """Both launch counts so far: the wrappers' ({name: calls that
    launched the kernel or recorded it into a graph being captured})
    and the kernels' own on the card ({name: launches the device ran,
    graph replays included}, ``kernels.device_launch_counts``; it
    synchronizes the device)."""
    from paddle_tpu_torch import kernels

    return kernels.launch_counts(), kernels.device_launch_counts()


def _since(snap, names):
    """(wrapper launches, device launches) of ``names`` since ``snap``."""
    return tuple({k: now[k] - was[k] for k in names}
                 for now, was in zip(_snap(), snap))


def _times(counts, n):
    return {k: n * v for k, v in counts.items()}


def _add(total, delta):
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def _summed(per_mode):
    """{kernel: count} summed over the modes of {mode: {kernel: count}}."""
    out = {}
    for counts in per_mode.values():
        _add(out, counts)
    return out


def _capture_seconds(exe, *programs):
    """Summed capture seconds of the graphs ``exe`` holds for
    ``programs``."""
    return sum(e.graph.capture_seconds for p in programs
               for e in exe.compiled_for(p) if e.graph is not None)


def graph_pools_gb():
    """GB the CUDA graphs' private memory pools hold (segments outside
    the allocator's default pool): a replay's activations live there,
    which ``max_memory_allocated`` does not count once captured."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def _ms_quantiles(secs):
    a = np.asarray(secs)
    return dict(p50_ms=1e3 * float(np.percentile(a, 50)),
                p95_ms=1e3 * float(np.percentile(a, 95)))


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the flash kernels
# ---------------------------------------------------------------------------


def _demangle(names):
    """C++ names of mangled symbols, where a demangler is installed."""
    import shutil

    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


# the bf16 flash kernels of namespace flash_tc: K1, K2, K3
FLASH_TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")


def _ptxas_entries(name):
    """[(mangled name, C++ label, {registers, static_smem_bytes,
    spill_bytes})] of each entry function of kernel library ``name``,
    from its build's -Xptxas -v."""
    import re

    from paddle_tpu_torch.kernels import _build

    found, cur = {}, None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) \
            or re.search(r"Function properties for (\S+)", line)
        if m:
            cur = found.setdefault(m.group(1), {"static_smem_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack_frame_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    out = []
    for mangled, label in zip(found, _demangle(list(found))):
        for a, b in (("(anonymous namespace)::", ""), ("<unnamed>::", ""),
                     ("(bool)0", "false"), ("(bool)1", "true"),
                     ("void ", "")):
            label = label.replace(a, b)  # c++filt's and cu++filt's forms
        out.append((mangled, label.split("(")[0], found[mangled]))
    return out


def flash_build_report():
    """Each flash entry function's registers, static shared memory and
    spill bytes (the build's -Xptxas -v), and the tensor-core (HMMA,
    HGMMA) instructions in its SASS (cuobjdump, where the toolkit has
    it).  The bf16 K1, K2 and K3 (namespace flash_tc) must all be there,
    spill nothing and, where SASS can be read, hold tensor-core
    instructions; no SIMT flash kernel may take bf16."""
    import re
    import shutil

    from paddle_tpu_torch.kernels import _build

    entries = _ptxas_entries("flash_attention")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    hmma = {}
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path("flash_attention"))],
            capture_output=True, text=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n", 1)[0].strip()
            hmma[name] = len(re.findall(r"\bH(?:G)?MMA\b", block))
    report = {}
    for mangled, label, props in entries:
        r = dict(props)
        if mangled in hmma:
            r["tensor_core_instructions"] = hmma[mangled]
        # a function of namespace flash_tc (not one merely taking its
        # Strides)
        r["tensor_cores"] = mangled.startswith("_ZN8flash_tc")
        report[label] = r
    bad = [k for k, r in report.items() if r["tensor_cores"] and (
        r.get("spill_bytes") != 0
        or r.get("tensor_core_instructions", 1) == 0)]
    missing = [k for k in FLASH_TC_KERNELS
               if not any(k in lb and r["tensor_cores"]
                          for lb, r in report.items())]
    simt_bf16 = [k for k, r in report.items()
                 if not r["tensor_cores"] and "__nv_bfloat16" in k]
    if bad or missing or simt_bf16:
        raise AssertionError(f"flash build: tensor-core kernels spilling or "
                             f"without HMMA {bad}, missing {missing}, bf16 "
                             f"SIMT kernels {simt_bf16}: {report}")
    return report


def paged_build_report():
    """Registers, static shared memory and spill bytes of every K5 and
    K7 instantiation (template arguments <query tile, columns a lane,
    int8 pool>).  The split form is held to two CTAs an SM (128
    registers); K7's split instantiations of the int8 decode lane (d 64:
    two columns a lane) must spill nothing."""
    report = {label: props
              for _, label, props in _ptxas_entries("paged_attention")}
    lane = [k for k in report
            if "split_kernel" in k and k.endswith(", 2, true>")]
    bad = [k for k in lane if report[k].get("spill_bytes") != 0]
    if len(lane) != 2 or bad:
        raise AssertionError(f"paged build: K7's lane split instantiations "
                             f"{lane} (2 expected), spilling {bad}: "
                             f"{report}")
    return report


def _sass(name):
    """{mangled entry: ([(address, instruction)], {label: address})} of
    kernel library ``name`` (cuobjdump -sass); {} where the toolkit has
    no cuobjdump."""
    import re
    import shutil

    from paddle_tpu_torch.kernels import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        return {}
    text = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        fname, body = block.split("\n", 1)
        instrs, labels, pending = [], {}, []
        for line in body.splitlines():
            s = line.strip()
            m = re.match(r"(\.L_x_\d+):", s)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"/\*([0-9a-f]+)\*/\s+(.*?)\s*;", s)
            if m:
                addr = int(m.group(1), 16)
                labels.update((lb, addr) for lb in pending)
                pending = []
                instrs.append((addr, m.group(2)))
        out[fname.strip()] = (instrs, labels)
    return out


def _store_bytes(ins):
    """Bytes one SASS global store writes (0 for any other
    instruction)."""
    op = next(t for t in ins.split() if not t.startswith("@"))
    if not op.startswith("STG"):
        return 0
    parts = op.split(".")
    for width, n in (("128", 16), ("64", 8), ("U16", 2), ("S16", 2),
                     ("U8", 1), ("S8", 1)):
        if width in parts:
            return n
    return 4


def _main_loop(instrs, labels, elem_bytes):
    """The loop (a backward branch and the instructions from its target
    to it) that stores the most bytes an iteration: its static
    instruction count, the elements it stores (``elem_bytes`` each) and
    the instructions an element.  None if the function has no loop."""
    import re

    best = None
    for addr, ins in instrs:
        m = re.search(r"\bBRA\s+`?\(?([.\w]+)\)?", ins)
        if not m:
            continue
        tgt = m.group(1)
        start = labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)
        if start is None or start > addr:
            continue
        body = [i for a, i in instrs
                if start <= a <= addr and not i.startswith("NOP")]
        stored = sum(_store_bytes(i) for i in body)
        key = (stored, -len(body))
        if stored and (best is None or key > best[0]):
            best = (key, dict(instructions=len(body),
                              elements=stored // elem_bytes,
                              per_element=len(body) / (stored // elem_bytes)
                              if stored >= elem_bytes else None))
    return best[1] if best else None


def k4_k6_build_report():
    """Registers, static shared memory and spill bytes of every K4 and
    K6 instantiation (ptxas), and for each K4 one its main loop's SASS
    instructions an element stored.  Fails if one spills.  Returns the
    report and the bf16 K4 loop's count (x and bias bf16, no mask,
    exact GeLU: the training path's)."""
    report, spilling, bf16_loop = {}, [], None
    for name in ("fused_bias_act", "ragged_attention"):
        sass = _sass(name) if name == "fused_bias_act" else {}
        for mangled, label, props in _ptxas_entries(name):
            r = dict(props)
            if mangled in sass:
                elem = 2 if "<__nv_bfloat16" in label else 4  # out's
                r["main_loop"] = _main_loop(*sass[mangled], elem)
                if ("__nv_bfloat16, __nv_bfloat16" in label
                        and label.endswith("false, false>")
                        and r["main_loop"]
                        and (bf16_loop is None
                             or r["main_loop"]["elements"]
                             > bf16_loop["elements"])):
                    bf16_loop = dict(r["main_loop"], kernel=label)
            if r.get("spill_bytes", 0) != 0:
                spilling.append(label)
            report[f"{name}: {label}"] = r
    if spilling:
        raise AssertionError(f"K4/K6 build: spilling {spilling}: {report}")
    return report, bf16_loop


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _paged_inputs(dev, b, n, t, d, page_size, max_pages, num_pages,
                  q_start, rng):
    q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                         .astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                         .astype(np.float32)).to(dev)
    # page 0 is the trash page: poison it, so attending it would show
    k[0] = 1e4
    v[0] = 1e4
    return (q, k, v) + _page_table(dev, b, t, page_size, max_pages,
                                   num_pages, q_start, rng)


def _page_table(dev, b, t, page_size, max_pages, num_pages, q_start, rng):
    """(page_table, q_start) on the card: each row's live pages drawn
    without repeats from pages 1.. (never the trash page)."""
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        live = min(max_pages, (q_start[r] + t - 1) // page_size + 1)
        table[r, :live] = perm[r * max_pages:r * max_pages + live]
    return (torch.from_numpy(table).to(dev),
            torch.tensor(q_start, dtype=torch.int32, device=dev))


def _bound(byts, flops, peak=FP32_FLOPS):
    """(least ms on the card, what bounds it): bytes over the HBM rate vs
    flops over the ``peak`` rate (fp32 SIMT unless given)."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _paged_bound(b, n, t, d, page_size, q_start):
    """Least time for one call with these q_start values: each visible
    K/V row, q, out and the live page-table entries moved once; 4·d
    flops per visible (query, key) pair."""
    keys = sum(qs + t for qs in q_start)          # K/V rows per head
    pairs = sum((qs + 1 + qs + t) * t // 2 for qs in q_start)
    live_pages = sum(-(-(qs + t) // page_size) for qs in q_start)
    byts = (keys * n * d * 4 * 2 + 2 * b * n * t * d * 4 + b * 4
            + live_pages * 4)
    return _bound(byts, pairs * n * 4 * d) + (byts,)


def _paged_one_split(quant, args, scale):
    """K5's kernel (K7's with ``quant``) in its one-split form (one CTA a
    query tile, head and row, as before the split), through the same C
    entry: the yardstick of the split form at each case.  ``args`` are
    the wrapper's positional arguments."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.primitives import paged

    lib = _build.load("paged_attention", paged._SIGNATURES)
    q, pool, table = args[0], args[1], args[-2]
    b, n, t, d = q.shape
    out = torch.empty_like(q)
    max_pages = table.shape[1]
    fn = (lib.pt_paged_attention_quant_f32 if quant
          else lib.pt_paged_attention_f32)
    err = fn(*map(_build.ptr, tuple(args) + (out,)), None, None, b, n, t, d,
             pool.shape[1], max_pages, pool.shape[0], max_pages, 1, scale,
             _build.stream_of(q.device))
    _build.check("paged attention (one split)", err)
    return out


def check_paged(dev, rng, quant=False):
    """K5 (K7 with ``quant``, over a dual-int8 pool with a poisoned trash
    page) at the decode lanes' shapes (page 16, 64 logical pages: eight
    splits of eight pages), with each case's split plan and partials
    workspace, both forms held against the plain version and timed in
    turns, one split against split."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.primitives import paged

    warps = _build.load("paged_attention", paged._SIGNATURES).pt_paged_warps()
    n, d, page_size, max_pages, num_pages = 12, 64, 16, 64, 513
    cases = [("decode", 8, 1, [0, 15, 16, 17, 500, 777, 1000, 1023])]
    cases += [(f"prefill@{qs}", 1, 32, [qs]) for qs in (0, 32, 992)]
    if quant:
        pool = _quant_pool(dev, num_pages, page_size, n, d, rng)
        fn, ref = paged.paged_attention_quant, \
            paged.paged_attention_quant_reference
        bound, plain_iters, label = _paged_quant_bound, 10, \
            "paged_attention_quant"
    else:
        fn, ref = paged.paged_attention, paged.paged_attention_reference
        bound, plain_iters, label = _paged_bound, 20, "paged_attention"
    worst, timings = 0.0, {}
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)  # 256 MB > 50 MB L2
    scale = d ** -0.5
    for name, b, t, q_start in cases:
        if quant:
            q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32)
                                 ).to(dev)
            args = (q, *pool, *_page_table(dev, b, t, page_size, max_pages,
                                           num_pages, q_start, rng))
        else:
            args = _paged_inputs(dev, b, n, t, d, page_size, max_pages,
                                 num_pages, q_start, rng)
        got = fn(*args, sm_scale=scale)
        one = _paged_one_split(quant, args, scale)
        want = ref(*args, sm_scale=scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        one_err = (one - want).abs().max().item()
        for form, out in (("", got), (" (one split)", one)):
            if not torch.allclose(out, want, **K5_TOL) \
                    or not torch.isfinite(out).all():
                raise AssertionError(
                    f"{label}{form} {name}: max abs err "
                    f"{(out - want).abs().max().item()} outside {K5_TOL}")
        worst = max(worst, err, one_err)
        flush = flush_buf.zero_

        def one_split():
            return _paged_one_split(quant, args, scale)

        def split():
            return fn(*args, sm_scale=scale)

        # in turns: one split, split, split, one split
        in_turns = [_time_ms(f, 50, flush)
                    for f in (one_split, split, split, one_split)]
        plain_ms = _time_ms(lambda: ref(*args, sm_scale=scale), plain_iters,
                            flush)
        bound_ms, bound_by, byts = bound(b, n, t, d, page_size, q_start)
        plan = paged.split_plan(b, n, t, d, max_pages, page_size, warps)
        timings[name] = dict(ms=(in_turns[1] + in_turns[2]) / 2,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=byts,
                             max_abs_err=err, one_split_max_abs_err=one_err,
                             q_start=q_start,
                             one_split_ms=(in_turns[0] + in_turns[3]) / 2,
                             in_turns_ms=in_turns,
                             pages_per_split=plan.pages_per_split,
                             splits=plan.splits,
                             workspace=plan.workspace,
                             workspace_bytes=4 * int(np.prod(
                                 plan.workspace or (0,))),
                             library_ms=None)
    del flush_buf
    return worst, timings


def _quant_pool(dev, num_pages, page_size, n, d, rng):
    """A dual-int8 pool (hi, lo, scale for K and V) quantized from random
    fp32 by the port's codec; the trash page's scales poisoned, so
    attending it would show."""
    from paddle_tpu_torch.kernels.primitives import int8

    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                             .astype(np.float32)).to(dev)
        hi, lo, sc = int8.quantize_lastdim(x)
        sc[0] = 1e4
        out += [hi, lo, sc]
    return out


def _paged_quant_bound(b, n, t, d, page_size, q_start):
    """Least time for one K7 call: as K5's, with each visible K/V row
    read as 2 bytes a code (hi + lo) and a 4-byte scale."""
    keys = sum(qs + t for qs in q_start)
    pairs = sum((qs + 1 + qs + t) * t // 2 for qs in q_start)
    live_pages = sum(-(-(qs + t) // page_size) for qs in q_start)
    byts = (keys * n * (2 * d + 4) * 2 + 2 * b * n * t * d * 4 + b * 4
            + live_pages * 4)
    return _bound(byts, pairs * n * 4 * d) + (byts,)


def _ragged_bound(h, s, d, lengths, causal):
    """Least time for one K6 call: q and o of every row, and K/V rows
    below each row's length, moved once; 4·d flops per live (query, key)
    pair — j < length (and j <= i when causal) — at the fp32 rate
    without tensor cores (exact fp32 products)."""
    pairs, kv_rows = 0, 0
    for ln in lengths:
        n_keys = min(max(ln, 0), s)
        kv_rows += n_keys
        pairs += (sum(min(i + 1, n_keys) for i in range(s)) if causal
                  else s * n_keys)
    byts = (2 * len(lengths) * h * s * d + 2 * h * kv_rows * d) * 4 \
        + 4 * len(lengths)
    return _bound(byts, h * pairs * 4 * d) + (byts,)


def _sdpa_ragged_ms(q, k, v, lengths, causal, scale):
    """The library yardstick: scaled_dot_product_attention with the same
    boolean key mask (a length-0 row gives NaN there; timing only)."""
    import torch.nn.functional as F

    s = q.shape[2]
    j = torch.arange(s, device=q.device)
    mask = j.view(1, 1, 1, s) < lengths.view(-1, 1, 1, 1)
    if causal:
        mask = mask & (j.view(1, 1, 1, s) <= j.view(1, 1, s, 1))
    return _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), 50)


def check_ragged(dev, rng):
    """K6 at the ragged Engine path's shapes: q/k/v [8, 8, S, 32] fp32
    transposed views of [8, S, 8, 32], S = 128 with the wave's lengths
    (timed) and with a row of length 0, the bucketed arm's S = 32 and 64
    whose padding rows carry length 0; and S = 200, D = 64, causal on
    and off."""
    from paddle_tpu_torch.kernels.primitives import ragged

    wave = [20, 20, 50, 50, 90, 90, 126, 126]
    cases = [("path", 8, 8, 128, 32, True, wave),
             ("len0", 8, 8, 128, 32, True, [20, 50, 90, 126, 0, 126, 3, 128]),
             ("bucket32", 8, 8, 32, 32, True, [20, 20, 0, 0, 0, 0, 0, 0]),
             ("bucket64", 8, 8, 64, 32, True, [50, 50, 0, 0, 0, 0, 0, 0]),
             ("s200_causal", 4, 4, 200, 64, True, [200, 150, 7, 0]),
             ("s200", 4, 4, 200, 64, False, [200, 150, 7, 0])]
    worst, timings = 0.0, {}
    for name, b, h, s, d, causal, lens in cases:
        q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(dev).transpose(1, 2) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        got = ragged.ragged_attention(q, k, v, lengths, causal, scale)
        want = ragged.ragged_attention(q, k, v, lengths, causal, scale,
                                       force="reference")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **FLASH_TOL[torch.float32]) \
                or not torch.isfinite(got).all() \
                or got.stride() != q.stride():
            raise AssertionError(f"ragged_attention {name}: max abs err "
                                 f"{err} outside {FLASH_TOL[torch.float32]}")
        worst = max(worst, err)
        if name not in ("path", "bucket32", "bucket64"):
            continue
        bound_ms, bound_by, byts = _ragged_bound(h, s, d, lens, causal)
        timings[name] = dict(
            ms=_time_ms(lambda: ragged.ragged_attention(
                q, k, v, lengths, causal, scale), 50),
            plain_ms=_time_ms(lambda: ragged.ragged_attention(
                q, k, v, lengths, causal, scale, force="reference"), 20),
            bound_ms=bound_ms, bound_by=bound_by, bytes=byts,
            library_ms=_sdpa_ragged_ms(q, k, v, lengths, causal, scale),
            max_abs_err=err, shape=[b, h, s, d], lengths=lens)
    return worst, timings


# (name, b, h, s, d, dtype, causal, strided, lengths): the contract the
# redesigned K6 takes beyond the serving path's shape: D 96 and 128,
# bf16 at D 32 and 64, causal and not, transposed views, a length 0 and
# one past S, S 1, and a row of length 1000 at S 1024 (32 key tiles)
RAGGED_CONTRACT_CASES = (
    ("d96", 2, 3, 150, 96, torch.float32, True, True, [150, 0]),
    ("d128", 2, 3, 150, 128, torch.float32, False, True, [97, 300]),
    ("d128_causal", 2, 2, 64, 128, torch.float32, True, False, [64, 31]),
    ("bf16_d32", 8, 8, 128, 32, torch.bfloat16, True, True,
     [20, 20, 50, 50, 90, 90, 126, 0]),
    ("bf16_d64", 2, 3, 200, 64, torch.bfloat16, False, True, [200, 77]),
    ("bf16_d64_causal", 2, 3, 200, 64, torch.bfloat16, True, False,
     [0, 500]),
    ("s1", 3, 2, 1, 32, torch.float32, True, True, [1, 0, 5]),
    ("s1024", 1, 2, 1024, 64, torch.float32, True, True, [1000]),
)


def check_ragged_contract(dev, rng):
    """K6 at RAGGED_CONTRACT_CASES against its plain version (FLASH_TOL
    of the dtype; the plain version computes in fp32 and rounds once to
    q's dtype); the output keeps q's dtype and layout."""
    from paddle_tpu_torch.kernels.primitives import ragged

    worst = {}
    for name, b, h, s, d, dtype, causal, strided, lens in \
            RAGGED_CONTRACT_CASES:
        q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(dev, dtype).transpose(1, 2) for _ in range(3))
        if not strided:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = ragged.ragged_attention(q, k, v, lengths, causal)
        want = ragged.ragged_attention(q, k, v, lengths, causal,
                                       force="reference")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = FLASH_TOL[dtype]
        if got.dtype != dtype or got.stride() != q.stride() \
                or not torch.isfinite(got).all() \
                or not torch.allclose(got.float(), want.float(), **tol):
            raise AssertionError(f"ragged_attention {name}: max abs err "
                                 f"{err} outside {tol} (dtype {got.dtype}, "
                                 f"strides {got.stride()})")
        worst[name] = err
    return max(worst.values()), worst


def _bias_gelu_bound(r, h, with_mask):
    byts = r * h * 4 * 2 + h * 4 + (r * h if with_mask else 0)
    return _bound(byts, r * h * GELU_FLOPS_PER_ELEMENT) + (byts,)


def check_bias_gelu(dev, rng):
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    worst, timings = 0.0, {}
    for r in (8, 32, 37):
        h = 3072
        x = torch.from_numpy(rng.randn(r, h).astype(np.float32) * 3).to(dev)
        bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(dev)
        mask = torch.from_numpy((rng.rand(r, h) > 0.1).astype(np.uint8)).to(dev)
        for with_mask in (False, True):
            for approx in (False, True):
                kw = dict(mask=mask if with_mask else None,
                          scale=1 / 0.9 if with_mask else 1.0,
                          approximate=approx)
                got = fba.fused_bias_gelu(x, bias, **kw)
                want = fba.fused_bias_gelu_reference(x, bias, **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, **K4_TOL):
                    raise AssertionError(
                        f"fused_bias_gelu [{r},{h}] mask={with_mask} "
                        f"approximate={approx}: max abs err {err} outside "
                        f"{K4_TOL}")
                worst = max(worst, err)
                if not approx:
                    ms = _time_ms(lambda: fba.fused_bias_gelu(x, bias, **kw),
                                  100)
                    plain_ms = _time_ms(
                        lambda: fba.fused_bias_gelu_reference(x, bias, **kw),
                        30)
                    bound_ms, bound_by, byts = _bias_gelu_bound(
                        r, h, with_mask)
                    timings[f"[{r},{h}] mask={with_mask}"] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, bytes=byts, max_abs_err=err)
    return worst, timings


def check_bias_gelu_bf16(dev, rng):
    """K4 on bf16 input at the training path's two shapes, the 12 FFN
    fc_0 outputs [b*s, 3072] and the MLM head [b*s/8, 768], the FFN's
    at a dp replica's shard [b*s/4, 3072], and GPT-2 small's FFN at b8
    s1024 [8192, 3072]."""
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    worst, timings = 0.0, {}
    for r, h in ((16384, 3072), (2048, 768), (4096, 3072), (8192, 3072)):
        x = torch.from_numpy(rng.randn(r, h).astype(np.float32) * 3).to(
            dev, torch.bfloat16)
        bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(
            dev, torch.bfloat16)
        got = fba.fused_bias_gelu(x, bias)
        want = fba.fused_bias_gelu_reference(x, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != torch.bfloat16 \
                or not torch.allclose(got.float(), want.float(),
                                      **K4_BF16_TOL):
            raise AssertionError(f"fused_bias_gelu bf16 [{r},{h}]: max abs "
                                 f"err {err} outside {K4_BF16_TOL}")
        worst = max(worst, err)
        ms = _time_ms(lambda: fba.fused_bias_gelu(x, bias), 50)
        plain_ms = _time_ms(lambda: fba.fused_bias_gelu_reference(x, bias),
                            20)
        # what the card reaches moving the same bytes: PyTorch's device
        # copy of x into a tensor of its shape (a yardstick, not the
        # function)
        dst = torch.empty_like(x)
        copy_ms = _time_ms(lambda: dst.copy_(x), 50)
        byts = r * h * 2 * 2 + h * 2
        bound_ms, bound_by = _bound(byts, r * h * GELU_FLOPS_PER_ELEMENT)
        timings[f"[{r},{h}] bf16"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=byts, max_abs_err=err, copy_ms=copy_ms)
    return worst, timings


def _flash_inputs(dev, b, h, s, d, dtype, rng, bias_mode="pads"):
    """q, k, v, dO as the BERT and GPT programs hand them to the op:
    [B, H, S, D] transposed views of [B, S, H, D] activations; a key
    bias [B*H, S] with -1e4 pads on a quarter of the rows' tails
    ("pads"), or with every key of batch 1's heads at -1e30 on top
    ("masked": fully masked rows), or zero (GPT's op has no bias, and
    the op hands the kernels zero rows)."""
    def t():
        a = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
        return a.to(dev, dtype).transpose(1, 2)

    q, k, v, do = t(), t(), t(), t()
    bias = np.zeros((b, s), np.float32)
    if bias_mode != "zero":
        bias[::4, s - s // 4:] = -1e4
    if bias_mode == "masked":
        bias[1] = -1e30
    rows = torch.from_numpy(np.repeat(bias, h, axis=0)).to(dev)
    return q, k, v, do, rows


def _flash_bounds(bh, s, d, elem, causal):
    """(ms, bound_by) of K1, K2, K3: each operand read once and each
    output written once at HBM rate vs the products' flops (2 per
    multiply-add over the live (query, key) pairs) at the bf16
    tensor-core rate."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    mat = elem * bh * s * d      # one [BH, S, D] operand
    row = 4 * bh * s             # one fp32 [BH, S] row vector
    k1 = _bound(3 * mat + row + mat + row, 2 * 2 * pairs * d, BF16_TC_FLOPS)
    k2 = _bound(4 * mat + 3 * row + mat, 3 * 2 * pairs * d, BF16_TC_FLOPS)
    k3 = _bound(4 * mat + 3 * row + 2 * mat + row, 4 * 2 * pairs * d,
                BF16_TC_FLOPS)
    return k1, k2, k3


def _sdpa_ms(q, k, v, do, rows, scale, causal=False):
    """The library yardstick: scaled_dot_product_attention with the same
    float key mask (causal: ``is_causal=True`` and no mask, the same
    function over zero bias rows), forward, and its backward (dQ, dK, dV
    together)."""
    import torch.nn.functional as F

    b, h, s, _ = q.shape
    kw = dict(scale=scale)
    if causal:
        kw["is_causal"] = True
    else:
        kw["attn_mask"] = rows.reshape(b, h, 1, s).to(q.dtype)
    fwd = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw),
                   20)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    bwd = _time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                               retain_graph=True), 20)
    return fwd, bwd


# (name, b, h, s, d, dtype, causal, bias mode (_flash_inputs), timed):
# the BERT path's shape, a dp replica's shard and GPT-2 small's causal
# b8 s1024 (all timed), then the edges of the bf16 tensor-core K1-K3 (a
# ragged last tile, causal, four key tiles a causal row, D < 64, rows
# that are not 16-byte multiples, one token, rows whose keys are all
# masked) and the fp32 SIMT cases
FLASH_CASES = (
    ("path", 128, 12, 128, 64, torch.bfloat16, False, "pads", True),
    ("dp_shard", 32, 12, 128, 64, torch.bfloat16, False, "pads", True),
    ("gpt", 8, 12, 1024, 64, torch.bfloat16, True, "zero", True),
    ("bf16_ragged", 4, 12, 200, 64, torch.bfloat16, False, "pads", False),
    ("bf16_ragged_causal", 4, 12, 200, 64, torch.bfloat16, True, "pads",
     False),
    ("bf16_s256_causal", 4, 12, 256, 64, torch.bfloat16, True, "pads",
     False),
    ("bf16_d32", 4, 12, 96, 32, torch.bfloat16, False, "pads", False),
    ("bf16_d12_causal", 4, 12, 77, 12, torch.bfloat16, True, "pads",
     False),
    ("bf16_s1", 4, 12, 1, 64, torch.bfloat16, False, "pads", False),
    ("bf16_masked_rows", 4, 12, 128, 64, torch.bfloat16, False, "masked",
     False),
    ("ragged", 4, 12, 200, 64, torch.float32, False, "pads", False),
    ("ragged_causal", 4, 12, 200, 64, torch.float32, True, "pads", False),
    ("masked_rows", 4, 12, 128, 64, torch.float32, False, "masked", False),
)


def check_flash(dev, rng):
    """K1, K2, K3 against their plain versions at FLASH_CASES; bf16 ones
    run on the tensor cores, fp32 ones on the SIMT units.
    Timed at the BERT path's shape (BH = 1536, S = 128, D = 64, bf16),
    at a dp replica's shard (BH = 384) and at GPT-2 small's (BH = 96,
    S = 1024, causal; SDPA with ``is_causal`` beside it)."""
    from paddle_tpu_torch.kernels.primitives import flash

    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    by_dtype, by_case = {}, {}
    timings = {}
    for name, b, h, s, d, dtype, causal, bias_mode, timed in FLASH_CASES:
        q, k, v, do, rows = _flash_inputs(dev, b, h, s, d, dtype, rng,
                                          bias_mode)
        scale = d ** -0.5
        o, lse = flash.flash_fwd(q, k, v, rows, causal, scale)
        o_ref, lse_ref = flash.flash_fwd(q, k, v, rows, causal, scale,
                                         force="reference")
        lse_rows = lse_ref.reshape(b * h, s)
        delta = (do.float() * o_ref.float()).sum(-1).reshape(b * h, s)
        bargs = (q, k, v, rows, do, lse_rows, delta, causal, scale)
        dq = flash.flash_bwd_dq(*bargs)
        dk, dv, db = flash.flash_bwd_dkv(*bargs)
        dq_ref = flash.flash_bwd_dq(*bargs, force="reference")
        dk_ref, dv_ref, db_ref = flash.flash_bwd_dkv(*bargs,
                                                     force="reference")
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        errs = by_dtype.setdefault(str(dtype).split(".")[-1], {})
        case_errs = by_case.setdefault(name, {})
        for kern, got, want, t in (
                ("flash_fwd", o, o_ref, tol),
                ("flash_fwd", lse, lse_ref, FLASH_TOL[torch.float32]),
                ("flash_bwd_dq", dq, dq_ref, tol),
                ("flash_bwd_dkv", dk, dk_ref, tol),
                ("flash_bwd_dkv", dv, dv_ref, tol),
                ("flash_bwd_dkv", db, db_ref, FLASH_DBIAS_TOL)):
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), **t) \
                    or not torch.isfinite(got).all():
                raise AssertionError(f"{kern} {name}: max abs err {err} "
                                     f"outside {t}")
            worst[kern] = max(worst[kern], err)
            errs[kern] = max(errs.get(kern, 0.0), err)
            case_errs[kern] = max(case_errs.get(kern, 0.0), err)
        if bias_mode == "masked":  # uniform weights: O of batch 1 is the
            # mean of V
            mean_v = v[1].float().mean(dim=1, keepdim=True).expand_as(v[1])
            if not torch.allclose(o[1].float(), mean_v, **tol):
                raise AssertionError(f"flash_fwd {name}: fully masked rows "
                                     f"are not the mean of V")
        if not timed:
            continue
        k1, k2, k3 = _flash_bounds(b * h, s, d, 2, causal)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do, rows, scale,
                                    causal=bias_mode == "zero")
        shape = {}
        for kern, fn, plain, (bound_ms, bound_by), lib in (
                ("flash_fwd",
                 lambda: flash.flash_fwd(q, k, v, rows, causal, scale),
                 lambda: flash.flash_fwd(q, k, v, rows, causal, scale,
                                         force="reference"), k1, lib_fwd),
                ("flash_bwd_dq", lambda: flash.flash_bwd_dq(*bargs),
                 lambda: flash.flash_bwd_dq(*bargs, force="reference"), k2,
                 lib_bwd),
                ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(*bargs),
                 lambda: flash.flash_bwd_dkv(*bargs, force="reference"), k3,
                 lib_bwd)):
            shape[kern] = dict(
                ms=_time_ms(fn, 30), plain_ms=_time_ms(plain, 10),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                shape=[b * h, s, d], dtype="bfloat16")
        if name == "path":
            timings.update(shape)
        else:
            timings[name] = shape
    timings["max_abs_err_by_dtype"] = by_dtype
    timings["max_abs_err_by_case"] = by_case
    timings["sdpa_note"] = ("library_ms: flash_fwd against SDPA forward; "
                            "flash_bwd_dq and flash_bwd_dkv each against "
                            "SDPA's whole backward")
    return worst, timings


def check_flash_fp32_predictor(dev, rng):
    """K1 in fp32 (the SIMT kernel of csrc/flash_attention.cu) at the
    predictor path's shape, b8 s128, 12 heads, D 64 ([96, 128, 64] fp32,
    a key bias with pads): held against its plain version, and timed
    against its bound (fp32 products at the SIMT rate), SDPA in fp32 with
    the same float mask, and the composed matmul / softmax / matmul that
    the passes-off predictor runs.  Measurement only."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.primitives import flash

    b, h, s, d = 8, 12, 128, 64
    q, k, v, _, rows = _flash_inputs(dev, b, h, s, d, torch.float32, rng)
    scale = d ** -0.5
    mask = rows.reshape(b, h, 1, s)

    def composed():
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale
                          + mask, dim=-1)
        return torch.matmul(p, v)

    o, lse = flash.flash_fwd(q, k, v, rows, False, scale)
    o_ref, lse_ref = flash.flash_fwd(q, k, v, rows, False, scale,
                                     force="reference")
    tol = FLASH_TOL[torch.float32]
    err = 0.0
    for got, want in ((o, o_ref), (lse, lse_ref), (o, composed())):
        e = (got - want).abs().max().item()
        if not torch.allclose(got, want, **tol):
            raise AssertionError(f"flash_fwd fp32 predictor shape: max abs "
                                 f"err {e} outside {tol}")
        err = max(err, e)
    bh, elem = b * h, 4
    mat, row = elem * bh * s * d, 4 * bh * s
    bound_ms, bound_by = _bound(3 * mat + row + mat + row,
                                2 * 2 * bh * s * s * d, FP32_FLOPS)
    return err, dict(
        shape=[bh, s, d], dtype="float32",
        ms=_time_ms(lambda: flash.flash_fwd(q, k, v, rows, False, scale),
                    30),
        plain_ms=_time_ms(lambda: flash.flash_fwd(
            q, k, v, rows, False, scale, force="reference"), 10),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), 20),
        composed_ms=_time_ms(composed, 20),
        max_abs_err=err)


K8_BLOCK = 256
# K8 kernel vs plain: the kernel spells every operation in the plain
# version's order with round-to-nearest intrinsics (no fused
# multiply-add), so the two should agree bit for bit; 1e-6 relative is
# the gate in case the card's sqrt or division rounds otherwise, and
# the requant codes must be equal
K8_RTOL = 1e-6
# (name, numel): BERT-base's word embedding (30528 x 768), an FFN weight
# (768 x 3072), a 768 bias (launch-bound), and a numel that is not a
# multiple of the block
K8_SHAPES = (("word_embedding", 30528 * 768), ("ffn_weight", 768 * 3072),
             ("bias", 768), ("ragged", 1000003))
# (kind, use_nesterov) of every K8 kind
K8_KINDS = (("adam", False), ("adamw", False), ("momentum", False),
            ("momentum", True), ("sgd", False))


def _k8_case(dev, numel, rng, offset_blocks=3):
    """Parameter state and a gradient bucket slice for one K8 call: the
    member's blocks start ``offset_blocks`` into a wire image quantized
    by the port's codec from random fp32 (zero in the member's padding),
    with two blocks after it."""
    from paddle_tpu_torch.kernels import quantized_collectives as qc

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    nb = -(-numel // K8_BLOCK)
    bucket = rng.randn((offset_blocks + nb + 2) * K8_BLOCK)
    # the member's alignment padding is zero, as coalesce_tensor pads it
    bucket[offset_blocks * K8_BLOCK + numel:(offset_blocks + nb) * K8_BLOCK] = 0
    hi, lo, sc = qc.quantize_block_scaled(f32(bucket), K8_BLOCK)
    state = dict(p=f32(rng.randn(numel) * 0.1),
                 m1=f32(rng.randn(numel) * 0.01),
                 m2=f32(np.abs(rng.randn(numel)) * 0.01),
                 lr=f32([1e-3]), b1p=f32([0.9 ** 3]), b2p=f32([0.999 ** 3]))
    return state, (hi, lo, sc, offset_blocks, numel)


def _k8_call(kind, nesterov, s, grad, requant, force=None):
    """One fused update through the public entry; returns every tensor
    it wrote (the state is updated in place)."""
    from paddle_tpu_torch.kernels import fused_update as fu

    pad = K8_BLOCK if requant else None
    kw = dict(block_size=K8_BLOCK, requant_pad=pad, force=force)
    if kind in ("adam", "adamw"):
        fn = fu.fused_adam_update if kind == "adam" else fu.fused_adamw_update
        out = fn(s["p"], grad, s["m1"], s["m2"], s["lr"], s["b1p"],
                 s["b2p"], **kw)
    elif kind == "momentum":
        out = fu.fused_momentum_update(s["p"], grad, s["m1"], s["lr"],
                                       use_nesterov=nesterov, **kw)
    else:
        out = fu.fused_sgd_update(s["p"], grad, s["lr"], **kw)
    return out if isinstance(out, tuple) else (out,)


def _k8_bytes(kind, numel):
    """Bytes one K8 call must move: p (and each moment) read and
    written, hi and lo read, one scale a block, lr and the powers."""
    state = {"adam": 3, "adamw": 3, "momentum": 2, "sgd": 1}[kind]
    return numel * (8 * state + 2) + 4 * -(-numel // K8_BLOCK) + 12


def check_fused_update(dev, rng):
    """K8 against its plain version for every kind, in the fp32 and the
    requant form, at K8_SHAPES; the adam form timed at each shape."""
    from paddle_tpu_torch.kernels import fused_update as fu

    worst, timings = 0.0, {}
    for name, numel in K8_SHAPES:
        for kind, nesterov in K8_KINDS:
            for requant in (False, True):
                state, grad = _k8_case(dev, numel, rng)
                ref = {k: v.clone() for k, v in state.items()}
                got = _k8_call(kind, nesterov, state, grad, requant)
                want = _k8_call(kind, nesterov, ref, grad, requant,
                                force="reference")
                torch.cuda.synchronize()
                label = (f"{kind}{'-nesterov' if nesterov else ''} {name} "
                         f"requant={requant}")
                # the requant form writes p as the payload's dequantized
                # image on the kernel's path: its codes and scales are
                # what to compare
                for g, w in list(zip(got, want))[1 if requant else 0:]:
                    if g.dtype == torch.int8:
                        bad = int((g != w).sum())
                        if bad:
                            raise AssertionError(f"fused_update {label}: "
                                                 f"{bad} codes differ")
                        continue
                    err = (g - w).abs().max().item()
                    if not torch.allclose(g, w, rtol=K8_RTOL,
                                          atol=K8_RTOL * w.abs().max()) \
                            or not torch.isfinite(g).all():
                        raise AssertionError(f"fused_update {label}: max abs "
                                             f"err {err}")
                    worst = max(worst, err)
        state, grad = _k8_case(dev, numel, rng)
        s = state
        ms = _time_ms(lambda: fu.fused_update_kernel(
            "adam", s["p"], grad, s["m1"], s["m2"], s["lr"], s["b1p"],
            s["b2p"], fu._consts("adam"), K8_BLOCK),
            50 if numel > 1e6 else 200)
        # the plain version launches some 30 kernels a call: few calls at
        # the large shapes, so the host finishes enqueueing within the
        # device sleep
        plain_ms = _time_ms(lambda: _k8_call("adam", False, s, grad, False,
                                             force="reference"),
                            3 if numel > 1e6 else 20)
        byts = _k8_bytes("adam", numel)
        bound_ms, bound_by = _bound(byts, 0)
        timings[name] = dict(numel=numel, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bytes=byts, library_ms=None)
    return worst, timings


def _dp_group_members(dev):
    """The data-parallel lane's K8 segments: phase 12's BERT-base program
    transpiled for DP_REPLICAS replicas, its plan's one group step (every
    fused_adam_quant_grad op, in order), and for each member on each
    replica (replica-major, as the executor hands them over) seeded fp32
    state and its bucket's wire image, quantized by the port's codec
    from seeded data of the bucket's padded size.  Returns (members,
    hyper, block size, ops a replica)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import executor as ex
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.kernels import quantized_collectives as qc
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.data_parallel import DataParallelRunner

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, _, loss = _bert_program(cfg, bf16=True)
    strategy = fluid.BuildStrategy()
    strategy.quant_allreduce = True
    prog = DataParallelRunner(main, loss.name, build_strategy=strategy,
                              places=[_gpu_place()] * DP_REPLICAS).program
    plan = ex._Plan(prog, list(bert.make_fake_batch(cfg, 1, 8)),
                    [loss.name])
    (group,) = [g for g in plan.steps if isinstance(g, ex._Group)]
    attrs = group.ops[0].attrs
    bs = int(attrs["block_size"])
    hyper = dict(beta1=attrs["beta1"], beta2=attrs["beta2"],
                 epsilon=attrs["epsilon"])
    block = prog.global_block()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def randn(n, scale):
        return torch.randn(n, generator=gen, device=dev) * scale

    members = []
    for _ in range(DP_REPLICAS):
        images = {}
        lr = torch.tensor([1e-4], device=dev)
        for op in group.ops:
            name = op.inputs["QHi"][0]
            if name not in images:
                images[name] = qc.quantize_block_scaled(
                    randn(block.var(name).shape[0], 1e-3), bs)
            hi, lo, sc = images[name]
            numel = int(op.attrs["numel"])
            members.append(fu.GroupMember(
                randn(numel, 0.02), (hi, lo, sc, int(op.attrs["offset_blocks"]),
                                     numel),
                lr, randn(numel, 1e-4), randn(numel, 1e-4).abs(),
                torch.tensor([0.9 ** 3], device=dev),
                torch.tensor([0.999 ** 3], device=dev)))
    return members, hyper, bs, len(group.ops)


def check_fused_update_group(dev):
    """K8's group form over the dp lane's real segment list (206
    parameters x 4 replicas): held against the plain version member by
    member under the per-parameter gate, with the launches it takes;
    its kernels' device time (torch.profiler) against the same segments
    as 824 single launches and against its bound, both entries' whole
    device time (the beta powers included), and torch._fused_adam_ over
    the same tensors with an fp32 gradient (a yardstick only: another
    function); and the word embedding alone as a one-segment group
    against its single launch, in turns."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_update as fu

    members, hyper, bs, n_ops = _dp_group_members(dev)
    cap = _build.load("fused_update",
                      fu._SIGNATURES).pt_fused_update_group_capacity()
    ref = [fu.GroupMember(*(t.clone() if isinstance(t, torch.Tensor) else t
                            for t in m)) for m in members]
    before = (fu.fused_update_group.launches, fu.fused_update_kernel.launches)
    fu.fused_update_group("adam", members, hyper, bs)
    launches = (fu.fused_update_group.launches - before[0],
                fu.fused_update_kernel.launches - before[1])
    fu.fused_update_group("adam", ref, hyper, bs, force="reference")
    torch.cuda.synchronize()
    if launches != (-(-len(members) // cap), 0):
        raise AssertionError(f"fused_update_group: {launches} (group, "
                             f"single) launches over {len(members)} "
                             f"members, table of {cap}")
    worst, differing = 0.0, 0
    for i, (m, r) in enumerate(zip(members, ref)):
        for g, w in zip(m, r):
            if not isinstance(g, torch.Tensor) or g.dtype != torch.float32 \
                    or g is m.lr:
                continue
            err = (g - w).abs().max().item()
            differing += int((g != w).sum())
            if not torch.allclose(g, w, rtol=K8_RTOL,
                                  atol=K8_RTOL * w.abs().max()) \
                    or not torch.isfinite(g).all():
                raise AssertionError(f"fused_update_group member {i}: max "
                                     f"abs err {err}")
            worst = max(worst, err)
    del ref
    consts = fu._consts("adam", **hyper)

    def singles():
        for m in members:
            fu.fused_update_kernel("adam", m.p, m.grad, m.m1, m.m2, m.lr,
                                   m.b1p, m.b2p, consts, bs)

    def per_op_entries():
        for m in members:
            fu.fused_adam_update(m.p, m.grad, m.m1, m.m2, m.lr, m.b1p,
                                 m.b2p, **hyper, block_size=bs)

    group = _profile(lambda: fu.launch_group("adam", members, hyper, bs), 3,
                     match="fused_update_group_kernel")
    single = _profile(singles, 1, match="fused_update_kernel")
    group_entry = _profile(lambda: fu.fused_update_group(
        "adam", members, hyper, bs), 3)
    single_entry = _profile(per_op_entries, 1)
    grads = [torch.randn_like(m.p) for m in members]
    steps = [torch.ones((), device=dev) for _ in members]
    fused_adam = _profile(lambda: torch._fused_adam_(
        [m.p for m in members], grads, [m.m1 for m in members],
        [m.m2 for m in members], [], steps, lr=1e-4, beta1=hyper["beta1"],
        beta2=hyper["beta2"], weight_decay=0.0, eps=hyper["epsilon"],
        amsgrad=False, maximize=False), 3)
    del grads, steps
    plain = _profile(lambda: fu.fused_update_group(
        "adam", members, hyper, bs, force="reference"), 1)
    we = max(members[:n_ops], key=lambda m: m.grad[4])

    def we_single():
        fu.fused_update_kernel("adam", we.p, we.grad, we.m1, we.m2, we.lr,
                               we.b1p, we.b2p, consts, bs)

    def we_group():
        fu.launch_group("adam", [we], hyper, bs)

    we_turns = [_time_ms(f, 50) for f in (we_single, we_group, we_group,
                                          we_single)]
    byts = sum(_k8_bytes("adam", m.grad[4]) for m in members)
    bound_ms, bound_by = _bound(byts, 0)
    return worst, dict(
        members=len(members), ops_a_replica=n_ops, table=cap,
        launches=launches[0], differing_elements=differing,
        ms=group["fused_update_group_kernel_device_ms"],
        group_kernel_events=group["fused_update_group_kernel_events"],
        single_launches_ms=single["fused_update_kernel_device_ms"],
        single_launch_events=single["fused_update_kernel_events"],
        group_entry_device_ms=group_entry["device_busy_ms"],
        group_entry_device_events=group_entry["device_events"],
        per_op_entries_device_ms=single_entry["device_busy_ms"],
        per_op_entries_device_events=single_entry["device_events"],
        fused_adam_fp32_grad_ms=fused_adam["device_busy_ms"],
        fused_adam_note=("torch._fused_adam_ over the same tensors with an "
                         "fp32 gradient: another function, a yardstick "
                         "only"),
        plain_ms=plain["device_busy_ms"], bound_ms=bound_ms,
        bound_by=bound_by, bytes=byts, library_ms=None,
        word_embedding=dict(numel=we.grad[4], in_turns_ms=we_turns,
                            single_ms=(we_turns[0] + we_turns[3]) / 2,
                            group_ms=(we_turns[1] + we_turns[2]) / 2))


# ---------------------------------------------------------------------------
# phases 4-5: BERT-base training at full width, and its CPU parity
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 128, 128
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
CHAIN_STEPS = 10  # run_steps on the train step


def _bert_program(cfg, bf16):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, loss


def _executors():
    """{mode: an executor on the card} of MODES: the captured one and
    the eager one (FLAGS_cuda_graph_capture as each is made)."""
    from paddle_tpu_torch import fluid

    out = {}
    for m, c in MODES:
        with capture_mode(c):
            out[m] = fluid.Executor(_gpu_place())
    return out


def _train_step_launches(cfg, replicas=1):
    """{kernel: launches} of one BERT train step over ``replicas``."""
    return {"flash_fwd": 2 * cfg.num_layers * replicas,
            "flash_bwd_dq": cfg.num_layers * replicas,
            "flash_bwd_dkv": cfg.num_layers * replicas,
            "fused_bias_act": (cfg.num_layers + 1) * replicas}


def _gate_launches(what, launches, on_card, per_run, runs, first_runs):
    """The exact launch gates of a path run in both modes: on the card
    (the kernels' own counters) every program run of either mode
    launches ``per_run``, ``runs`` runs a mode; the wrappers see every
    eager run, and of the captured mode only its ``first_runs`` (each a
    signature's eager warm-up and its capture: a replay runs no
    Python)."""
    want_card = _times(per_run, runs)
    want = {"captured": _times(per_run, 2 * first_runs),
            "eager": want_card}
    if any(on_card[m] != want_card for m in on_card) or launches != want:
        raise AssertionError(
            f"{what}: launches {launches} (wrappers) and {on_card} (on the "
            f"card), expected {want} and {want_card} a mode")


def run_train_path(counters):
    """BERT-base, b128 s128, bf16 policy, Adam, flash, hidden dropout
    0.1, on the card: the captured executor and the eager one in turns
    (a step each), from the same state and feed, TRAIN_WARMUP +
    TRAIN_STEPS steps each.  Each mode's launches exact, on the card and
    in the wrappers; the two modes' losses and final state bit-equal.
    The captured state after CHAIN_STEPS steps is kept for
    run_train_chain."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.observability import profiling

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=True)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    start = _clone_scope(scope)  # run_train_chain starts from here
    exes = _executors()
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    snap = None
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for i in range(steps):
        for m, exe in exes.items():  # in turns
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)  # the fetch syncs
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            if i >= TRAIN_WARMUP:
                peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append(float(lv))
        if i == CHAIN_STEPS - 1:
            snap = _clone_scope(scopes["captured"])
    total = {k: w.launches for k, w in counters.items()}
    _gate_launches("train path", launches, on_card,
                   _train_step_launches(cfg), steps, 1)
    sites = check_no_new_sites("train path", main)
    if total != {k: launches["captured"][k] + launches["eager"][k]
                 for k in total}:
        raise AssertionError(f"train path: the wrappers read {total}, the "
                             f"runs {launches}")
    loss_c = losses["captured"]
    if not all(np.isfinite(loss_c)) or not loss_c[-1] < loss_c[0]:
        raise AssertionError(f"train path losses not finite and falling: "
                             f"{loss_c}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"train path: captured and eager differ: "
                             f"losses {losses}, state {diff[:5]}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = bert.train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    _, peak_flops, _, _ = profiling.device_peaks()
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][TRAIN_WARMUP:])
        modes[m] = dict(
            tokens_per_s=tokens * TRAIN_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * float(np.percentile(timed, 50)),
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0],
            mfu=flops / float(np.median(timed)) / peak_flops,
            peak_memory_gb=peak[m] / 1e9, launches=launches[m],
            device_launches=on_card[m])
    held = [h.graph for h in exes["captured"].compiled_for(main)]
    if exes["captured"].capture and held == [None]:
        raise AssertionError("train path: the captured executor holds no "
                             "graph")
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    path = dict(model="BertConfig.base(vocab_size=30528)", batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, dtype_policy="bf16", steps=TRAIN_STEPS,
                warmup_steps=TRAIN_WARMUP, losses=loss_c,
                captured_eager_bit_equal=True, model_flops_per_step=flops,
                mfu_peak_flops=peak_flops, modes=modes, launches=total,
                device_launches=_summed(on_card), new_pass_sites=sites)
    state = dict(exes=exes, main=main, scopes=scopes, feed=feed, loss=loss,
                 cfg=cfg, start=start, snap=snap, losses=loss_c)
    return state, path


def time_lookup_grads(dev):
    """The train step's three lookup_table reads and derived grads (the
    word [30528, 768], position [512, 768] and token-type [2, 768]
    tables, b128 s128 ids, bf16 as the policy casts them): the port's
    lowering (an exact integer index-add, ops/tensor_ops.py
    ``index_add_exact``) against the library's forms it replaces, each
    forward and backward timed and each grad checked for equality over
    eight repeats: ``index_select`` (the lowering before the captured
    executor), ``F.embedding``, indexing, and a one-hot product for the
    tables of at most 1,024 rows (the port uses none of them).  The
    lowering's grad must be equal run to run: captured and eager steps
    agree on it."""
    from paddle_tpu_torch.fluid import registry

    lower = registry.get_op("lookup_table").lower
    ctx = registry.LowerContext(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = {"word": torch.randint(0, 30528, shape, generator=g, device=dev),
           "position": torch.arange(TRAIN_SEQ, device=dev).repeat(
               TRAIN_BATCH, 1),
           "token_type": torch.randint(0, 2, shape, generator=g,
                                       device=dev)}
    rows = {"word": 30528, "position": 512, "token_type": 2}
    forms = {"lowering": lambda w, i: lower(ctx, w, i, attrs={}),
             "index_select": lambda w, i: torch.index_select(
                 w, 0, i.reshape(-1)),
             "embedding": lambda w, i: torch.nn.functional.embedding(
                 i.reshape(-1), w),
             "indexing": lambda w, i: w[i.reshape(-1)],
             "one_hot": lambda w, i: torch.nn.functional.one_hot(
                 i.reshape(-1), w.shape[0]).to(w.dtype) @ w}
    out = {}
    for name, i in ids.items():
        w = (0.02 * torch.randn(rows[name], 768, generator=g, device=dev)
             ).to(torch.bfloat16).requires_grad_()
        dout = torch.randn(TRAIN_BATCH * TRAIN_SEQ, 768, generator=g,
                           device=dev).to(torch.bfloat16)
        out[name] = {}
        for form in forms:
            if form == "one_hot" and rows[name] > 1024:
                continue

            def grad():
                o = forms[form](w, i).reshape(-1, 768)
                return torch.autograd.grad(o, w, dout)[0]

            ref = grad()
            same = all(torch.equal(ref, grad()) for _ in range(8))
            if form == "lowering" and not same:
                raise AssertionError(f"lookup_table grad ({name} table) "
                                     f"differs from run to run")
            out[name][form] = dict(ms=_time_ms(grad, 10),
                                   equal_run_to_run=same)
    return out


def run_train_chain(state):
    """run_steps(CHAIN_STEPS) on the train step from the path's start:
    its last loss and final state equal to the path's captured run()
    calls at that step (bit for bit); one graph replayed a step, so the
    card launches CHAIN_STEPS x a step's kernels and the wrappers see
    the first step's warm-up and capture only."""
    from paddle_tpu_torch import fluid

    # the path's executors and the eager state go first: one more
    # graph's pool of activations comes next
    state["exes"].clear()
    state["scopes"].clear()
    torch.cuda.empty_cache()
    exe = fluid.Executor(_gpu_place())
    per = _train_step_launches(state["cfg"])
    before = _snap()
    t0 = time.perf_counter()
    (last,) = exe.run_steps(state["main"], feed=state["feed"],
                            n_steps=CHAIN_STEPS, fetch_list=[state["loss"]],
                            scope=state["start"])
    wall = time.perf_counter() - t0
    got, on_card = _since(before, per)
    want = (_times(per, 2), _times(per, CHAIN_STEPS))
    diff = _scope_diff(state["start"], state["snap"])
    ref = state["losses"][CHAIN_STEPS - 1]
    if float(last) != ref or diff or (got, on_card) != want:
        raise AssertionError(f"run_steps({CHAIN_STEPS}): last loss "
                             f"{float(last)} vs run() {ref}, state diff "
                             f"{diff[:5]}, launches {got} (wrappers) and "
                             f"{on_card} (on the card) vs {want}")
    (handle,) = [h for h in exe.compiled_for(state["main"])
                 if "chain" in h.label]
    return dict(n_steps=CHAIN_STEPS, last_loss=float(last),
                equal_to_run_calls=True, wall_s=wall,
                step_mean_ms=1e3 * wall / CHAIN_STEPS,
                capture_s=_capture_seconds(exe, state["main"]),
                graph_of_one_step=handle.graph is not None, launches=got,
                device_launches=on_card)


def _profile(step, n, match=None, device_only=False, kernels=False):
    """Host wall time vs summed device time of ``n`` calls of ``step``
    (torch.profiler), with the top device and host ops and the launch
    API calls (cudaLaunchKernel and its kin, cudaGraphLaunch) a call;
    with ``match`` (a name or a tuple of names), also the summed device
    time and count a call of the device events whose name contains each;
    with ``kernels``, the profiler itself (``"prof"``) for
    :func:`_kernel_sequence`.  ``device_only`` traces the card alone,
    for a step whose kernels another thread launches (the serving
    Engine's scheduler): a trace with host activity keeps only some of
    them.  Traced alone, the step keeps all of them when it is the
    first trace of its process (``--only engine``), not always after
    earlier ones."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] if device_only else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    dev, host = [], []
    for e in prof.key_averages():
        if e.key in SPLIT_LABELS:
            continue  # a record_function range, mirrored on the device
        # device-side events (kernels, copies) only: a CPU op such as
        # aten::mm also carries the device time of the kernels under it
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            d_us = (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) or 0)
            dev.append((d_us, e.key, e.count))
        else:
            host.append((getattr(e, "self_cpu_time_total", 0) or 0, e.key,
                         e.count))
    dev_us = sum(t for t, _, _ in dev)

    def top(rows, k=8):
        return [[key[:60], round(t / n, 1), c // n]
                for t, key, c in sorted(rows, reverse=True)[:k]]

    out = dict(wall_profiled_ms=1e3 * wall,
               device_busy_ms=dev_us / n / 1e3 if dev_us else None,
               device_events=sum(c for _, _, c in dev) // n,
               launch_api_calls={key: c // n for _, key, c in host
                                 if "LaunchKernel" in key
                                 or "GraphLaunch" in key},
               top_device_us=top(dev), top_host_self_us=top(host))
    if out["device_busy_ms"]:
        out["device_idle_share"] = 1 - out["device_busy_ms"] / out[
            "wall_profiled_ms"]
    for name in (match,) if isinstance(match, str) else (match or ()):
        hits = [(t, c) for t, key, c in dev if name in key]
        out[f"{name}_device_ms"] = sum(t for t, _ in hits) / n / 1e3
        out[f"{name}_events"] = sum(c for _, c in hits) // n
    if kernels:
        out["prof"] = prof
    return out


def _kernel_sequence(prof, labels=()):
    """The device kernels of a trace in start order (copies and sets
    left out): (name, microseconds, label), the label the innermost
    ``record_function`` range of ``labels`` that holds the CPU op that
    launched the kernel (linked by correlation id), else None."""
    from torch.autograd import DeviceType

    def start(e):
        return e.start_ns() if hasattr(e, "start_ns") else 1e3 * e.start_us()

    def dur(e):
        return (e.duration_ns() if hasattr(e, "duration_ns")
                else 1e3 * e.duration_us())

    evs = list(prof.profiler.kineto_results.events())
    ranges = [(start(e), start(e) + dur(e), e.name())
              for e in evs if e.name() in labels]
    ops = {e.correlation_id(): start(e) for e in evs
           if e.device_type() == DeviceType.CPU
           and not e.name().startswith("cuda")}
    out = []
    for e in sorted((e for e in evs if e.device_type() == DeviceType.CUDA
                     and e.name() not in labels
                     and not e.name().startswith(("Memcpy", "Memset"))),
                    key=start):
        t = ops.get(e.linked_correlation_id())
        held = [(b - a, n) for a, b, n in ranges
                if t is not None and a <= t <= b]
        out.append((e.name(), dur(e) / 1e3, min(held)[1] if held else None))
    return out


# record_function ranges of the train step's elementwise split
SPLIT_LABELS = ("pt_bf16_policy_cast", "pt_adam")


@contextlib.contextmanager
def _split_annotations():
    """The bf16 policy's casts (``executor._apply_bf16_policy``) and the
    adam op's lowering each inside a record_function range, for one
    eager profiled step (chip_smoke only: the port carries no
    annotation)."""
    from paddle_tpu_torch.fluid import executor as ex
    from paddle_tpu_torch.fluid import registry

    cast, adam = ex._apply_bf16_policy, registry.get_op("adam")
    lower = adam.lower

    def cast_annotated(op, vals):
        with torch.profiler.record_function(SPLIT_LABELS[0]):
            return cast(op, vals)

    def adam_annotated(*a, **kw):
        with torch.profiler.record_function(SPLIT_LABELS[1]):
            return lower(*a, **kw)

    ex._apply_bf16_policy, adam.lower = cast_annotated, adam_annotated
    try:
        yield
    finally:
        ex._apply_bf16_policy, adam.lower = cast, lower


def _split(seq):
    """Device ms of each label of a labelled kernel sequence."""
    out = {}
    for _, us, label in seq:
        key = label or "other"
        out[key] = out.get(key, 0.0) + us / 1e3
    return out


def profile_train_step(state):
    """One train step of each mode under torch.profiler, and one
    unprofiled: device busy and idle, the launch API calls, and the
    elementwise split of the step's device time between the bf16
    policy's casts and Adam's kernels.  The eager step carries the
    split's ranges; the captured step's kernels (one graph launch: no
    op launches them) take the labels of the eager step's kernels they
    align with, name by name in order (difflib), and any left unaligned
    are counted apart."""
    exes, scopes = state["exes"], state["scopes"]
    main, feed, loss = state["main"], state["feed"], state["loss"]
    out, seqs = {}, {}
    for m, exe in exes.items():
        def step():
            exe.run(main, feed=feed, fetch_list=[loss], scope=scopes[m])

        if m == "eager":
            with _split_annotations():
                r = _profile(step, 1, kernels=True)
        else:
            r = _profile(step, 1, kernels=True)
        seqs[m] = _kernel_sequence(r.pop("prof"), SPLIT_LABELS)
        t0 = time.perf_counter()
        step()
        r["step_wall_ms"] = 1e3 * (time.perf_counter() - t0)
        out[m] = r
    eager, cap = seqs["eager"], seqs["captured"]
    sm = difflib.SequenceMatcher(a=[k[0] for k in eager],
                                 b=[k[0] for k in cap], autojunk=False)
    labelled, aligned = [], 0
    for a, b, size in sm.get_matching_blocks():
        labelled += [(cap[b + i][0], cap[b + i][1], eager[a + i][2])
                     for i in range(size)]
        aligned += size
    unaligned = (sum(us for _, us, _ in cap)
                 - sum(us for _, us, _ in labelled)) / 1e3
    out["elementwise_split_ms"] = {
        "eager": _split(eager), "captured": _split(labelled),
        "captured_unaligned_ms": unaligned,
        "kernels": {"eager": len(eager), "captured": len(cap),
                    "aligned": aligned}}
    return out


def run_train_parity():
    """Full width, 2 layers, b4 s128, fp32, dropout 0: 3 Adam steps on
    the card and on the CPU from the same parameters."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=False)
    feed = bert.make_fake_batch(cfg, 4, 128, seed=1)
    gpu = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=gpu)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    convert.load_params(cpu, {p.name: gpu.get(p.name).cpu().numpy()
                              for p in main.all_parameters()},
                        fluid.CPUPlace(), program=main)
    losses = {}
    for key, scope, place in (("gpu", gpu, _gpu_place()),
                              ("cpu", cpu, fluid.CPUPlace())):
        exe = fluid.Executor(place)
        losses[key] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["gpu"],
                                                  losses["cpu"]))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"train parity: losses {losses}, max rel diff "
                             f"{rel} >= {TRAIN_LOSS_RTOL}")
    layer = [p.name for p in main.all_parameters()
             if p.name.startswith("encoder_layer_1_")]
    worst, mean = 0.0, 0.0
    for n in layer:
        d = np.abs(gpu.get(n).cpu().numpy() - cpu.get(n).numpy())
        worst, mean = max(worst, float(d.max())), max(mean, float(d.mean()))
    if not (worst <= TRAIN_PARAM_MAX_ATOL and mean <= TRAIN_PARAM_MEAN_ATOL):
        raise AssertionError(f"train parity: encoder_layer_1 params differ "
                             f"by max {worst} / mean {mean}")
    return dict(losses=losses, loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, layer="encoder_layer_1",
                layer_params=len(layer), param_max_abs_diff=worst,
                param_mean_abs_diff=mean,
                param_tol=[TRAIN_PARAM_MAX_ATOL, TRAIN_PARAM_MEAN_ATOL])


# ---------------------------------------------------------------------------
# phases 12-13: the data-parallel training lane (four replicas on one
# card, quantized gradient all-reduce, K8), and its CPU parity
# ---------------------------------------------------------------------------

DP_REPLICAS = 4
DP_WARMUP, DP_STEPS = 2, 5
# card vs CPU replicas, fp32, 3 Adam steps.  The losses within 1e-4
# relative.  A leaf (a parameter) whose reference gradient sits at the
# rounding floor — its bias-corrected RMS, read from the CPU run's
# Moment2, under DP_GRAD_FLOOR x the median leaf's, about fp32's
# relative rounding, as for the attention key biases whose true
# gradient is 0 — has no direction to hold.  Every other leaf is held by
# relative norms: Moment1 and Moment2 (which carry the gradient's scale,
# which Adam's step hides) within DP_MOMENT_RTOL, the parameter's change
# within DP_PARAM_RTOL.  The dual-int8 wire resolves 1/(127 x 254) of a
# block's max, so card-vs-CPU rounding that flips a code moves a reduced
# gradient by ~3e-5 of its block; a wrong average or scale index moves
# a leaf's moments by 0.5 or more
DP_GRAD_FLOOR = 1e-6
DP_MOMENT_RTOL = 1e-3
DP_PARAM_RTOL = 1e-2
DP_PARITY_STEPS = 3


def _dp_feed(cfg, batch, seq, seed):
    """The global batch as DP_REPLICAS per-replica batches of
    make_fake_batch, concatenated: each replica's mask_pos (flat
    positions into its own rows) indexes its shard, as a user of the
    data-parallel lane feeds it."""
    from paddle_tpu_torch.models import bert

    shards = [bert.make_fake_batch(cfg, batch // DP_REPLICAS, seq,
                                   seed=seed + r)
              for r in range(DP_REPLICAS)]
    return {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}


def _dp_compiled(main, loss, places):
    """The lane as a user writes it: quantized all-reduce on, the fused
    update and the rest at their flag defaults."""
    from paddle_tpu_torch import fluid

    bs = fluid.BuildStrategy()
    bs.quant_allreduce = True
    return fluid.CompiledProgram(main, build_strategy=bs).with_data_parallel(
        loss_name=loss.name, places=places)


def _counter_value(name):
    from paddle_tpu_torch.observability import metrics

    fam = metrics.snapshot().get(name)
    return sum(fam["samples"].values()) if fam else 0.0


def run_dp_path(counters):
    """BERT-base (phase 4's configuration) over DP_REPLICAS replicas on
    CUDAPlace(0): global batch b128 s128, b32 a replica, the captured
    executor and the eager one in turns (a step each) from the same
    state and feed.  In each mode the card must launch K8's group form
    once a table-full of the plan's group step (every
    fused_adam_quant_grad op on every replica) a step and its
    per-parameter form never, K1-K4 replicas x their phase-4 counts
    (the wrappers: every eager step, and the captured mode's warm-up
    and capture); the replicas' parameters
    bit-identical and the scope's; the two modes' losses and replica
    state bit-equal."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    # a program a mode: the data-parallel transpile rewrites its program
    # in place (the same names: one state serves both)
    progs = {m: _bert_program(cfg, bf16=True) for m, _ in MODES}
    main, startup, loss = progs["captured"]
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    compiled = {m: _dp_compiled(progs[m][0], progs[m][2],
                                [_gpu_place()] * DP_REPLICAS)
                for m in exes}
    feed = _dp_feed(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    saved0 = _counter_value("pt_fused_update_bytes_saved_total")
    names = list(counters) + ["fused_update_kernel"]
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    fu.fused_update_kernel.launches = 0
    steps, n = DP_WARMUP + DP_STEPS, DP_REPLICAS
    for i in range(steps):
        for m, exe in exes.items():  # in turns
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            (lv,) = exe.run(compiled[m], feed=feed, fetch_list=[loss],
                            scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)  # the fetch syncs
            py, dev = _since(before, names)
            _add(launches[m], py)
            _add(on_card[m], dev)
            if i >= DP_WARMUP:
                peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append([float(v) for v in lv])
    total = {k: w.launches for k, w in counters.items()}
    runner = compiled["captured"]._dp_runner
    prog = runner.program
    n_fused = sum(op.type == "fused_adam_quant_grad"
                  for op in prog.global_block().ops)
    (exec_plan,) = runner._plans.values()
    cap = _build.load("fused_update",
                      fu._SIGNATURES).pt_fused_update_group_capacity()
    # the group launches the plan makes: one a table-full of each group
    # step's members on every replica
    group_launches = sum(-(-m * n // cap)
                         for _, m in exec_plan.group_sizes)
    per = dict(_train_step_launches(cfg, n), fused_update=group_launches,
               fused_update_kernel=0)
    per = {k: v for k, v in per.items() if k in names}
    groups = exec_plan.group_sizes
    if groups != [("fused_adam_quant_grad", n_fused)]:
        raise AssertionError(f"dp path: plan groups {groups} ({n_fused} "
                             f"fused_adam_quant_grad ops)")
    _gate_launches("dp path", launches, on_card, per, steps, 1)
    sites = check_no_new_sites("dp path", *(progs[m][0] for m in exes))
    if total != {k: launches["captured"][k] + launches["eager"][k]
                 for k in total}:
        raise AssertionError(f"dp path: the wrappers read {total}, the "
                             f"runs {launches}")
    means = [float(np.mean(x)) for x in losses["captured"]]
    if not np.isfinite(losses["captured"]).all() or not means[-1] < means[0]:
        raise AssertionError(f"dp path losses not finite and falling: "
                             f"{losses['captured']}")
    params = main.all_parameters()
    for m in exes:
        r = compiled[m]._dp_runner
        for p in params:
            vals = r.replica_values(p.name)
            if not all(torch.equal(v, vals[0]) for v in vals[1:]) \
                    or scopes[m].get(p.name) is not vals[0]:
                raise AssertionError(f"dp path ({m}): replicas differ on "
                                     f"{p.name}, or replica 0 is not the "
                                     f"scope's")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"dp path: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    plan = prog._quant_allreduce_plan
    tokens = TRAIN_BATCH * TRAIN_SEQ
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][DP_WARMUP:])
        modes[m] = dict(
            tokens_per_s=tokens * DP_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * float(np.percentile(timed, 50)),
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0], peak_memory_gb=peak[m] / 1e9,
            launches=launches[m], device_launches=on_card[m])
    (graph,) = [e.graph for e in runner._entries.values()]
    if exes["captured"].capture and graph is None:
        raise AssertionError("dp path: the captured executor holds no graph")
    modes["captured"]["capture_s"] = getattr(graph, "capture_seconds", None)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    path = dict(
        model="BertConfig.base(vocab_size=30528)", replicas=n,
        places="[CUDAPlace(0)] x 4", global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, dtype_policy="bf16", steps=DP_STEPS,
        warmup_steps=DP_WARMUP, losses=losses["captured"],
        fused_adam_quant_grad_ops=n_fused, plan_groups=groups,
        group_table=cap, group_launches_per_step=group_launches,
        plain_adam_ops=sum(op.type == "adam"
                           for op in prog.global_block().ops),
        parameters=len(params),
        parameter_elements=int(sum(int(np.prod(p.shape)) for p in params)),
        buckets=[[b["elements"], b["algo"], b["fused_update"]]
                 for b in plan["buckets"]],
        modeled_wire_bytes_per_step=prog._collective_bytes_per_step,
        fused_update_bytes_saved_per_step=prog._fused_update_bytes_saved,
        pt_fused_update_bytes_saved_total=_counter_value(
            "pt_fused_update_bytes_saved_total") - saved0,
        tokens_per_s_note=("global tokens a step over the host-clock step; "
                           "four replicas share one card, so this is not a "
                           "scaling figure"),
        replicas_bit_identical=True, captured_eager_bit_equal=True,
        modes=modes, launches=total, device_launches=_summed(on_card),
        new_pass_sites=sites)
    state = dict(exes=exes, compiled=compiled, scopes=scopes, feed=feed,
                 loss=loss, n_fused=n_fused)
    return state, path


def profile_dp_step(state):
    """One data-parallel step of each mode under torch.profiler: device
    busy and idle, the top kernels, the launch API calls, K8's summed
    device time (its group kernel, and its per-parameter kernel, which
    must not run) against its bound (every fused op's bytes, every
    replica, at the HBM rate), and the multi-tensor kernels that advance
    the beta powers."""
    out = {}
    for m, exe in state["exes"].items():
        def step():
            exe.run(state["compiled"][m], feed=state["feed"],
                    fetch_list=[state["loss"]], scope=state["scopes"][m])

        r = _profile(step, 1, match=("fused_update_group_kernel",
                                     "fused_update_kernel",
                                     "multi_tensor_apply"))
        t0 = time.perf_counter()
        step()
        r["step_wall_ms"] = 1e3 * (time.perf_counter() - t0)
        out[m] = r
    prog = state["compiled"]["captured"]._dp_runner.program
    byts = sum(_k8_bytes("adam", int(op.attrs["numel"]))
               for op in prog.global_block().ops
               if op.type == "fused_adam_quant_grad") * DP_REPLICAS
    out["k8_bound_ms_per_step"] = _bound(byts, 0)[0]
    out["k8_bytes_per_step"] = byts
    return out


def _dp_parity_run(cfg, place, feed, init):
    """DP_PARITY_STEPS steps over DP_REPLICAS replicas on ``place`` from
    the parameters ``init`` (None: the startup's, returned).  Returns the
    losses, ``init`` and {param: (param, Moment1, Moment2)} after the
    run, read from the fused adam ops, with the ops' beta2."""
    from paddle_tpu_torch import convert, fluid

    main, startup, loss = _bert_program(cfg, bf16=False)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if init is None:
        init = {p.name: scope.get(p.name).cpu().numpy().copy()
                for p in main.all_parameters()}
    else:
        convert.load_params(scope, init, place, program=main)
    compiled = _dp_compiled(main, loss, [place] * DP_REPLICAS)
    losses = [exe.run(compiled, feed=feed, fetch_list=[loss],
                      scope=scope)[0].tolist()
              for _ in range(DP_PARITY_STEPS)]
    ops = [op for op in compiled._dp_runner.program.global_block().ops
           if op.type == "fused_adam_quant_grad"]
    state = {op.inputs["Param"][0]: tuple(
        scope.get(op.inputs[slot][0]).cpu().numpy().astype(np.float64)
        for slot in ("Param", "Moment1", "Moment2")) for op in ops}
    return losses, init, state, float(ops[0].attrs["beta2"])


def _dp_leaf_readings(init, gpu, cpu, beta2):
    """Per leaf: the reference gradient's bias-corrected RMS (from the
    CPU Moment2) against the median leaf's, and, card against CPU, the
    relative norms of the Moment1, Moment2 and parameter-change
    differences and the parameter's max abs difference."""
    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    g_rms = {n: float(np.sqrt(cpu[n][2].mean()
                              / (1 - beta2 ** DP_PARITY_STEPS)))
             for n in cpu}
    median = float(np.median(list(g_rms.values())))
    out = {}
    for n, (p, m1, m2) in gpu.items():
        p0 = init[n].astype(np.float64)
        out[n] = dict(grad_rms_to_median=g_rms[n] / median,
                      held=g_rms[n] >= DP_GRAD_FLOOR * median,
                      moment1_rel=rel(m1, cpu[n][1]),
                      moment2_rel=rel(m2, cpu[n][2]),
                      change_rel=rel(p - p0, cpu[n][0] - p0),
                      param_max_abs=float(np.abs(p - cpu[n][0]).max()))
    return out


def run_dp_parity():
    """Full width, 2 layers, b8 s128, fp32, dropout 0: 3 steps over four
    replicas on the card and over four CPUPlace replicas (the plain
    versions) from the same parameters; the losses, and each leaf's
    moments and parameter change above the rounding floor (see
    DP_GRAD_FLOOR)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    feed = _dp_feed(cfg, 8, 128, seed=1)
    gl, init, gpu, beta2 = _dp_parity_run(cfg, _gpu_place(), feed, None)
    cl, _, cpu, _ = _dp_parity_run(cfg, fluid.CPUPlace(), feed, init)
    gl, cl = np.asarray(gl), np.asarray(cl)
    rel = float(np.abs(gl - cl).max() / np.abs(cl).min())
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"dp parity: losses {gl.tolist()} (card) vs "
                             f"{cl.tolist()} (CPU), max rel diff {rel}")
    leaves = _dp_leaf_readings(init, gpu, cpu, beta2)
    held = {n: r for n, r in leaves.items() if r["held"]}
    worst = {}
    for key, tol in (("moment1_rel", DP_MOMENT_RTOL),
                     ("moment2_rel", DP_MOMENT_RTOL),
                     ("change_rel", DP_PARAM_RTOL)):
        name = max(held, key=lambda n: held[n][key])
        worst[key] = dict(leaf=name, **held[name])
        if not held[name][key] <= tol:
            raise AssertionError(f"dp parity: {key} {held[name][key]} > "
                                 f"{tol} on leaf {name}: {held[name]}")
    floor = {n: r for n, r in leaves.items() if not r["held"]}
    return dict(replicas=DP_REPLICAS, losses_gpu=gl.tolist(),
                losses_cpu=cl.tolist(), loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, leaves=len(leaves),
                leaves_held=len(held), worst_held=worst,
                rtol=dict(moments=DP_MOMENT_RTOL, change=DP_PARAM_RTOL),
                floor_leaves=floor, grad_floor_to_median=DP_GRAD_FLOOR,
                least_held_grad_to_median=min(
                    r["grad_rms_to_median"] for r in held.values()),
                param_max_abs_diff=max(r["param_max_abs"]
                                       for r in leaves.values()))


# ---------------------------------------------------------------------------
# phases 6-7: the decode lane at full width, and its CPU parity
# ---------------------------------------------------------------------------


class Lane:
    """The decode lane's two programs run directly on one executor, for
    the parity checks: prefill a token list through pages 1.., then
    decode steps, returning logprobs.  ``int8_weights``: both programs
    through the int8_weight_storage pass and ``scope``'s weights
    quantized, as DecodeEngine(int8_weights=True) does."""

    def __init__(self, cfg, place, scope, pool_slots, page_size, max_len,
                 chunk, pool_dtype="float32", capture=None,
                 int8_weights=False):
        from paddle_tpu_torch import fluid
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.passes import PassManager
        from paddle_tpu_torch.passes.int8_weights import (
            quantize_scope_weights)
        from paddle_tpu_torch.serving.kv_pool import KVPool

        self.cfg, self.scope, self.chunk = cfg, scope, chunk
        self.page_size = page_size
        self.max_pages = max_len // page_size
        num_pages = pool_slots * self.max_pages + 1
        self.pool_slots = pool_slots
        with capture_mode(True if capture is None else capture):
            self.exe = fluid.Executor(place)
        KVPool(cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
               num_pages, page_size, self.max_pages,
               dtype=pool_dtype).install(scope, self.exe.device)
        self.pf, self.dec = fluid.Program(), fluid.Program()
        with fluid.program_guard(self.pf, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, lp = gpt.build_gpt_prefill_chunk(
                cfg, chunk, num_pages, page_size, self.max_pages,
                pool_dtype=pool_dtype)
        self.pf_logp = lp.name
        with fluid.program_guard(self.dec, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, lp = gpt.build_gpt_decode_step(
                cfg, pool_slots, num_pages, page_size, self.max_pages,
                pool_dtype=pool_dtype)
        self.dec_logp = lp.name
        if int8_weights:  # as DecodeEngine(int8_weights=True) does
            for p in (self.pf, self.dec):
                PassManager(["int8_weight_storage"]).run(p)
            quantize_scope_weights(scope, self.dec, book=False)

    def table(self, n_tokens):
        row = np.zeros(self.max_pages, np.int32)
        used = -(-n_tokens // self.page_size)
        row[:used] = np.arange(1, used + 1)
        return row

    def prefill(self, tokens):
        """Logprobs after each chunk of `tokens` (pages 1, 2, ...)."""
        out, c, pgs = [], self.chunk, self.page_size
        table = self.table(len(tokens))
        for s in range(0, len(tokens), c):
            valid = min(c, len(tokens) - s)
            tok = np.zeros((1, c), np.int64)
            tok[0, :valid] = tokens[s:s + valid]
            wp = np.zeros(c // pgs, np.int32)
            for j in range(c // pgs):
                if s + j * pgs < s + valid:
                    wp[j] = table[(s + j * pgs) // pgs]
            feed = {"pf_tok": tok,
                    "pf_pos": np.minimum(s + np.arange(c), 1023)[None, :]
                    .astype(np.int64),
                    "pf_page_table": table[None, :],
                    "pf_write_pages": wp,
                    "pf_qstart": np.asarray([s], np.int32),
                    "pf_last_idx": np.asarray([valid - 1], np.int64)}
            (lp,) = self.exe.run(self.pf, feed=feed,
                                 fetch_list=[self.pf_logp], scope=self.scope)
            out.append(lp[0])
        return out

    def decode(self, token, pos):
        """Logprobs of one decode step with slot 0 active at `pos`."""
        ps = self.pool_slots
        table = np.zeros((ps, self.max_pages), np.int32)
        table[0] = self.table(pos + 1)
        feed = {"dec_tok": np.zeros((ps, 1), np.int64),
                "dec_pos": np.zeros((ps, 1), np.int64),
                "dec_page_table": table,
                "dec_write_page": np.zeros(ps, np.int32),
                "dec_write_off": np.zeros(ps, np.int32)}
        feed["dec_tok"][0, 0] = token
        feed["dec_pos"][0, 0] = pos
        feed["dec_write_page"][0] = table[0, pos // self.page_size]
        feed["dec_write_off"][0] = pos % self.page_size
        (lp,) = self.exe.run(self.dec, feed=feed, fetch_list=[self.dec_logp],
                             scope=self.scope)
        return lp[0]


def _param_names(cfg):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 1, 2, 16, 1)
    return main, [p.name for p in main.all_parameters()]


def _lane_workload(cfg):
    """The decode cell's requests: 16 seeded prompts of 8-512 tokens."""
    rng = np.random.RandomState(SEED)
    lens = [8, 512] + list(rng.randint(8, 513, 14))
    return lens, [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]


def _serve_lane(cfg, scope, prompts, counters, pool_dtype, capture,
                int8_weights=False):
    """One run of the decode workload on a fresh DecodeEngine (warmed
    up: on the captured executor, each program captured there) over
    ``scope``'s weights, with every launch count set to 0 before the
    engine is made and read after the run.  Returns the ids and the
    run's figures; gates each kernel at its count a layer per program
    run on the card (the warmup's runs included), and in the wrappers,
    which see every eager run and of the captured engine only the
    warmup's warm-up runs and captures."""
    from paddle_tpu_torch.serving import DecodeEngine

    for w, _ in counters.values():
        w.launches = 0
    before = _snap()
    start = torch.cuda.memory_allocated()
    with capture_mode(capture):
        eng = DecodeEngine(cfg, scope=scope, place=_gpu_place(),
                           pool_slots=8, page_size=16, max_len=1024,
                           pool_dtype=pool_dtype, int8_weights=int8_weights,
                           name=f"smoke-{pool_dtype}-{int8_weights}-"
                                f"{capture}",
                           auto_start=False, max_queue=len(prompts))
    warmed = eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.start()
    outs = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, (w, _) in counters.items()}
    _, on_card = _since(before, counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = eng.stats()
    eng.close()
    sites = check_no_new_sites("decode lane", eng._dec_prog, eng._pf_prog)
    if any(len(o) != 32 for o in outs):
        raise AssertionError(f"wrong token counts {[len(o) for o in outs]}")
    runs = stats["prefill_chunks"] + stats["steps"] + warmed
    seen = 2 * warmed if capture else runs
    for k, got in launches.items():
        each = counters[k][1] * cfg.num_layers
        if (got, on_card[k]) != (each * seen, each * runs):
            raise AssertionError(
                f"{k}: {got} launches (wrappers), {on_card[k]} on the card, "
                f"expected {counters[k][1]} x {cfg.num_layers} x {seen} and "
                f"x {runs} program runs ({warmed} at the warmup)")
    gen = sum(len(o) for o in outs)
    prompt_tokens = sum(len(p) for p in prompts)
    figures = dict(
        wall_s=wall, generated_tokens_per_s=gen / wall,
        total_tokens_per_s=(gen + prompt_tokens) / wall,
        prefill_chunks=stats["prefill_chunks"], decode_steps=stats["steps"],
        decode_step_ms=_ms_quantiles(eng.step_seconds),
        prefill_chunk_ms=_ms_quantiles(eng.prefill_seconds),
        evictions=stats["evictions"], peak_memory_gb=peak_gb,
        peak_over_start_gb=peak_gb - start / 1e9, launches=launches,
        device_launches=on_card, new_pass_sites=sites)
    if int8_weights:
        figures["int8_weights"] = stats["int8_weights"]
    if capture:
        figures["capture_s"] = _capture_seconds(eng._exe, eng._dec_prog,
                                                eng._pf_prog)
        figures["graph_pools_gb"] = graph_pools_gb()
    return outs, figures, eng.pool.modeled_bytes()


def run_path(dev, counters, pool_dtype="float32"):
    """The decode lane at full width over a ``pool_dtype`` KV pool,
    captured (the main path) and then eager on a copy of the weights:
    the same ids.  ``counters`` maps each kernel the run reads to the
    launches it must make per layer per program run (1 on the path, 0
    off it)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    cfg = _model_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    lens, prompts = _lane_workload(cfg)
    modes, ids = {}, {}
    for m, capture in MODES:
        ids[m], modes[m], pool_bytes = _serve_lane(
            cfg, _copy_scope(scope), prompts, counters, pool_dtype, capture)
        torch.cuda.empty_cache()
    if ids["captured"] != ids["eager"]:
        raise AssertionError(f"{pool_dtype} decode lane: captured and eager "
                             f"ids differ")
    path = dict(pool_dtype=pool_dtype, pool_bytes=pool_bytes,
                requests=len(prompts), prompt_tokens=int(sum(lens)),
                generated_tokens=sum(len(o) for o in ids["captured"]),
                captured_eager_ids_equal=True, modes=modes,
                launches=_summed({m: r["launches"]
                                  for m, r in modes.items()}),
                device_launches=_summed({m: r["device_launches"]
                                         for m, r in modes.items()}))
    return cfg, scope, prompts, ids["captured"], path


def profile_decode_step(cfg, scope, steps=5, pool_dtype="float32",
                        int8_weights=False):
    """Host wall time vs summed device kernel time of decode steps of
    each mode (torch.profiler), launch API calls and the paged attention
    kernels' device time a step: slot 0 active at positions 65-69, the
    other seven slots on the trash page.  The two modes' logprobs of
    every step bit-equal."""
    out, logp = {}, {}
    for m, capture in MODES:
        torch.cuda.reset_peak_memory_stats()
        lane = Lane(cfg, _gpu_place(), _copy_scope(scope), 8, 16, 1024, 32,
                    pool_dtype, capture=capture, int8_weights=int8_weights)
        got = lane.prefill(list(range(1, 65)))
        got.append(lane.decode(5, 64))
        pos = iter(range(65, 65 + 2 * steps))
        r = _profile(lambda: got.append(lane.decode(5, next(pos))), steps,
                     match="paged")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            got.append(lane.decode(5, next(pos)))
        torch.cuda.synchronize()
        r["step_wall_ms"] = 1e3 * (time.perf_counter() - t0) / steps
        r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if capture:
            r["capture_s"] = _capture_seconds(lane.exe, lane.pf, lane.dec)
        out[m], logp[m] = r, got
        del lane
        torch.cuda.empty_cache()
    if not all(np.array_equal(a, b) for a, b in zip(logp["captured"],
                                                    logp["eager"])):
        raise AssertionError(f"{pool_dtype} decode step: captured and eager "
                             f"logprobs differ")
    out["logprobs_bit_equal"] = len(logp["captured"])
    return out


def _lane_engine(cfg, scope, prompts, pool_dtype, name):
    """A fresh DecodeEngine of the decode lane on a copy of ``scope``,
    warmed up (its programs captured), that queues all of ``prompts``."""
    from paddle_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(cfg, scope=_copy_scope(scope), place=_gpu_place(),
                       pool_slots=8, page_size=16, max_len=1024,
                       pool_dtype=pool_dtype, auto_start=False,
                       max_queue=len(prompts), name=name)
    eng.warmup()
    return eng


def _drive_lane(eng, prompts):
    """Every request queued before the scheduler starts; the ids."""
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.start()
    return [f.result(timeout=900) for f in futs]


def profile_lane_paged(cfg, scope, prompts, pool_dtype="float32",
                       one_split=False):
    """The paged kernels' summed device time over one whole run of the
    decode lane's workload (``run_path``'s requests on a fresh engine,
    warmed up first; torch.profiler), and the ids it generated.  With
    ``one_split`` the wrapper (K5's, or K7's over the int8 pool) plans a
    single split: the kernel's form before the split, through the same
    C entry; the plan is set before the engine's warmup, where its
    programs are captured."""
    from paddle_tpu_torch.kernels.primitives import paged

    form = "one" if one_split else "split"
    plan = paged.split_plan
    if one_split:
        paged.split_plan = lambda b, n, t, d, max_pages, *a: \
            paged.SplitPlan(max_pages, 1, None, 0)
    outs = []
    try:
        eng = _lane_engine(cfg, scope, prompts, pool_dtype,
                           f"lane-{pool_dtype}-{form}")
        try:
            prof = _profile(lambda: outs.extend(_drive_lane(eng, prompts)),
                            1, match="paged")
        finally:
            eng.close()
    finally:
        paged.split_plan = plan
    return dict(one_split=one_split,
                paged_device_ms=prof["paged_device_ms"],
                paged_events=prof["paged_events"],
                device_busy_ms=prof["device_busy_ms"],
                wall_profiled_ms=prof["wall_profiled_ms"]), outs


def lane_paged_bound(cfg, scope, prompts, pool_dtype):
    """The paged kernel's least device time over one whole lane run: a
    run of its own (unprofiled, eager: the recorder reads each call's
    q_start on the host, which a capture cannot) records each call's
    shapes and q_start values, and each call's bytes (``_paged_bound``,
    or ``_paged_quant_bound`` over the int8 pool: the live K/V rows, q
    and out moved once) are summed at the HBM rate.  The decode ops
    reach the wrappers through their module reference, which the run
    points at a recorder (the wrappers themselves, and their launch
    counts, stay as they are)."""
    import types

    from paddle_tpu_torch.ops import decode_ops

    name = ("paged_attention_quant" if pool_dtype == "int8"
            else "paged_attention")
    bound = _paged_quant_bound if pool_dtype == "int8" else _paged_bound
    kernels, calls = decode_ops._paged, []

    def recording(q, pool, *args, **kw):
        calls.append((q.shape, pool.shape[1], args[-1].tolist()))
        return getattr(kernels, name)(q, pool, *args, **kw)

    with capture_mode(False):
        eng = _lane_engine(cfg, scope, prompts, pool_dtype,
                           f"bound-{pool_dtype}")
    decode_ops._paged = types.SimpleNamespace(
        paged_attention=kernels.paged_attention,
        paged_attention_quant=kernels.paged_attention_quant)
    setattr(decode_ops._paged, name, recording)
    try:
        _drive_lane(eng, prompts)
    finally:
        decode_ops._paged = kernels
        eng.close()
    byts = sum(bound(*shape, page, q_start)[2]
               for shape, page, q_start in calls)
    return dict(calls=len(calls), bytes=byts,
                bound_ms=_bound(byts, 0)[0])


def lane_in_turns(cfg, scope, prompts, outs, pool_dtype="float32"):
    """The paged kernel (K5, or K7 over the int8 pool) over the whole
    decode lane, captured, one split and split in turns (one, split,
    split, one): summed device ms of the paged kernels a run, whether
    each run's ids equal the main path's, and the lane-wide bound."""
    runs = []
    for one in (True, False, False, True):
        r, got = profile_lane_paged(cfg, scope, prompts, pool_dtype,
                                    one_split=one)
        r["ids_equal_main_path"] = got == outs
        runs.append(r)
    if not all(r["ids_equal_main_path"] for r in runs):
        raise AssertionError(f"{pool_dtype} lane in turns: ids differ from "
                             f"the main path's: {runs}")

    def mean(rs):
        return sum(r["paged_device_ms"] for r in rs) / len(rs)

    return dict(split_ms=mean(runs[1:3]), one_split_ms=mean(runs[::3]),
                runs=runs, bound=lane_paged_bound(cfg, scope, prompts,
                                                  pool_dtype))


def _copy_scope(scope):
    from paddle_tpu_torch import fluid

    out = fluid.Scope()
    for n in scope.keys():
        if not n.startswith("@KVPOOL@"):
            out.set(n, scope.get(n))
    return out


def run_parity(cfg, scope, prompts, outs, pool_dtype="float32",
               int8_weights=False):
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.serving import DecodeEngine

    main, names = _param_names(cfg)
    cpu_scope = fluid.Scope()
    convert.load_params(cpu_scope,
                        {n: scope.get(n).cpu().numpy() for n in names},
                        fluid.CPUPlace(), program=main)
    rng = np.random.RandomState(SEED + 1)
    tokens = rng.randint(1, cfg.vocab_size, 40).tolist()
    lanes = {"gpu": Lane(cfg, _gpu_place(), _copy_scope(scope), 2, 16,
                         1024, 32, pool_dtype, int8_weights=int8_weights),
             "cpu": Lane(cfg, fluid.CPUPlace(), cpu_scope, 2, 16, 1024, 32,
                         pool_dtype, int8_weights=int8_weights)}
    res = {}
    for k, lane in lanes.items():
        chunks = lane.prefill(tokens)
        nxt = int(np.argmax(chunks[-1]))
        res[k] = chunks + [lane.decode(nxt, len(tokens))]
    logp_err = max(float(np.abs(a - b).max())
                   for a, b in zip(res["gpu"], res["cpu"]))
    if not logp_err < PATH_LOGP_ATOL:
        raise AssertionError(f"card vs CPU logprobs: max abs err {logp_err} "
                             f">= {PATH_LOGP_ATOL}")

    # greedy ids of the two shortest requests, card vs CPU
    order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
    eng = DecodeEngine(cfg, scope=cpu_scope, place=fluid.CPUPlace(),
                       pool_slots=2, page_size=16, max_len=1024,
                       pool_dtype=pool_dtype, int8_weights=int8_weights,
                       name="cpu-parity")
    try:
        cpu_outs = eng.generate([prompts[i] for i in order],
                                max_new_tokens=32, timeout=900)
    finally:
        eng.close()
    cpu_lane = lanes["cpu"]
    ids = []
    for i, cpu_ids in zip(order, cpu_outs):
        gpu_ids = outs[i]
        k = next((j for j, (a, b) in enumerate(zip(gpu_ids, cpu_ids))
                  if a != b), None)
        entry = dict(request=i, prompt_tokens=len(prompts[i]),
                     first_mismatch=k)
        if k is not None:
            # allowed only at a near-tie: the CPU's top-two gap there must
            # be below the logprob tolerance
            lp = cpu_lane.prefill(prompts[i] + gpu_ids[:k])[-1]
            top2 = np.sort(lp)[-2:]
            gap = float(top2[1] - top2[0])
            entry["top2_gap"] = gap
            if not gap < PATH_LOGP_ATOL:
                raise AssertionError(
                    f"request {i}: greedy ids differ at step {k} with a "
                    f"top-two gap {gap} >= {PATH_LOGP_ATOL}")
        ids.append(entry)
    return dict(pool_dtype=pool_dtype, int8_weights=int8_weights,
                logprob_max_abs_err=logp_err, logprob_atol=PATH_LOGP_ATOL,
                greedy=ids)


# ---------------------------------------------------------------------------
# phases 10-11: the ragged serving.Engine lane over a saved inference
# model, both arms, and its CPU parity (phases 8-9 are phases 6-7 over
# the int8 pool)
# ---------------------------------------------------------------------------

# the repo's ragged-serving model at its "base" size (bench.py :985-1017)
RAGGED_VOCAB, RAGGED_HIDDEN, RAGGED_HEADS, RAGGED_LAYERS = 8192, 256, 8, 4
RAGGED_SEQ_BUCKETS = [32, 64, 128]
RAGGED_WAVE = (20, 50, 90, 126)  # two requests of each length a wave
RAGGED_BATCH = 2 * len(RAGGED_WAVE)
RAGGED_WAVES = 10
# card vs CPU scores: 4 layers of fp32 products summed in other orders
RAGGED_SCORE_ATOL = 1e-4


def save_ragged_model(dirname):
    """Build the ragged scorer with the port's front end (ids [-1, -1]
    int64, lens [-1] int32; a causal ragged_attention per layer), give it
    seeded random weights and save it with save_inference_model."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import layers as L

    head_dim = RAGGED_HIDDEN // RAGGED_HEADS
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("ids", [-1, -1], False, dtype="int64")
        lens = fluid.data("lens", [-1], False, dtype="int32")
        x = L.embedding(ids, size=[RAGGED_VOCAB, RAGGED_HIDDEN])
        for _ in range(RAGGED_LAYERS):
            qkv = [L.reshape(L.fc(x, size=RAGGED_HIDDEN, num_flatten_dims=2),
                             shape=[0, 0, RAGGED_HEADS, head_dim])
                   for _ in range(3)]
            q, k, v = [L.transpose(t, perm=[0, 2, 1, 3]) for t in qkv]
            ctx = L.ragged_attention(q, k, v, lens, causal=True)
            ctx = L.reshape(L.transpose(ctx, perm=[0, 2, 1, 3]),
                            shape=[0, 0, RAGGED_HIDDEN])
            x = L.elementwise_add(x, L.fc(ctx, size=RAGGED_HIDDEN,
                                          num_flatten_dims=2))
        score = L.reshape(L.reduce_mean(x, dim=[1, 2]), shape=[-1, 1])
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ["ids", "lens"], [score], exe,
                                  main_program=main, scope=scope)
    return score.name


def ragged_waves(n_waves):
    """The traffic: waves of two requests of each RAGGED_WAVE length,
    seeded; the first wave primes."""
    rng = np.random.RandomState(SEED + 2)
    return [[{"ids": rng.randint(1, RAGGED_VOCAB, (1, ln)).astype(np.int64),
              "lens": np.full((1,), ln, np.int32)}
             for ln in RAGGED_WAVE for _ in range(2)]
            for _ in range(n_waves)]


def _serve_rows(model, kind):
    from paddle_tpu_torch.observability import metrics

    fam = metrics.snapshot().get("pt_serve_rows_total")
    return fam["samples"].get((model, kind), 0.0) if fam else 0.0


def run_ragged_arm(model_dir, fetch, ragged, place, waves, counter=None,
                   capture=True):
    """One Engine arm serving ``waves`` (the first primes), its programs
    captured (on the card, at the warmup) or, without ``capture``, run
    by the eager loop.  Returns the served scores of every request and
    the arm's figures; with a ``counter`` (K6's wrapper) its launches
    are zeroed before the arm, and on the card K6 must launch 4 x the
    batches the arm executed, warmup included, and the wrapper 4 x the
    eager ones (the warmup's warm-up runs and captures on the captured
    engine, every batch on the eager one)."""
    from paddle_tpu_torch import serving

    name = "ragged" if ragged else "bucketed"
    if counter is not None:
        counter.launches = 0
        before = _snap()
    eng = serving.Engine(batch_buckets=[RAGGED_BATCH],
                         seq_buckets=RAGGED_SEQ_BUCKETS, max_wait_ms=5,
                         auto_start=False, name=f"smoke_{name}_{capture}",
                         place=place)
    try:
        with capture_mode(capture):  # the model's predictor's executor
            eng.load_model(name, model_dir, ragged=ragged)
        warmed = eng.warmup()[name]
        eng.start()

        def wave(feeds):
            futs = [eng.submit(name, f) for f in feeds]
            return [float(f.result(timeout=300)[fetch].reshape(-1)[0])
                    for f in futs]

        def cold():
            return eng.stats()["models"][name]["executable_cache"]["cold"]

        scores = [wave(waves[0])]
        pad0, real0 = _serve_rows(name, "padding"), _serve_rows(name, "real")
        cold0 = cold()
        on_card = place.torch_device().type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wave_s = []
        for feeds in waves[1:]:
            t1 = time.perf_counter()
            scores.append(wave(feeds))
            wave_s.append(time.perf_counter() - t1)
        dt = time.perf_counter() - t0
        timed = len(waves) - 1
        arm = dict(arm=name, capture=capture, warmed_shapes=warmed,
                   real_tokens_per_s=timed * 2 * sum(RAGGED_WAVE) / dt,
                   timed_waves=timed, wall_s=dt,
                   wave_ms=_ms_quantiles(wave_s) if wave_s else None,
                   real_rows=int(_serve_rows(name, "real") - real0),
                   padding_rows=int(_serve_rows(name, "padding") - pad0),
                   steady_state_cold=int(cold() - cold0))
        if on_card:
            pred = eng._lanes[name].predictor
            arm["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            arm["capture_s"] = _capture_seconds(pred._exe, pred._program)
            arm["graph_pools_gb"] = graph_pools_gb()
            arm["graphs"] = sum(h.graph is not None for h in
                                pred._exe.compiled_for(pred._program))
        prof = None
        if counter is not None:  # one more wave, under the profiler
            prof = _profile(lambda: wave(waves[1]), 1,
                            match="ragged_fwd_kernel", device_only=True)
            if prof["device_busy_ms"]:
                prof["device_idle_share"] = (1 - prof["device_busy_ms"]
                                             / prof["wall_profiled_ms"])
        stats = eng.stats()["models"][name]
    finally:
        eng.close()
    arm.update(batches=stats["batches"],
               warmup_batches=stats["warmup_batches"],
               executable_cache=stats["executable_cache"])
    if counter is not None:
        _, on_card = _since(before, ("ragged_attention",))
        arm["launches"] = counter.launches
        arm["device_launches"] = on_card["ragged_attention"]
        executed = stats["batches"] + stats["warmup_batches"]
        seen = 2 * stats["warmup_batches"] if capture else executed
        if (counter.launches, arm["device_launches"]) != (
                RAGGED_LAYERS * seen, RAGGED_LAYERS * executed):
            raise AssertionError(
                f"{name} arm: ragged_attention launched {counter.launches} "
                f"times (wrapper) and {arm['device_launches']} on the card, "
                f"expected {RAGGED_LAYERS} x {seen} and x {executed} "
                f"batches")
        arm["profile_one_wave"] = prof
    return scores, arm


def run_ragged_path(counter):
    """Both arms on the card, then each against a CPUPlace engine on the
    same saved model and requests."""
    import tempfile

    from paddle_tpu_torch import fluid

    waves = ragged_waves(1 + RAGGED_WAVES)
    arms, parity = {}, {}
    with tempfile.TemporaryDirectory(prefix="pt_ragged_model_") as d:
        fetch = save_ragged_model(d)
        for ragged in (True, False):
            scores, arm = run_ragged_arm(d, fetch, ragged, _gpu_place(),
                                         waves, counter)
            name = arm["arm"]
            if not np.isfinite(scores).all():
                raise AssertionError(f"{name} arm: non-finite scores")
            if ragged and (arm["warmed_shapes"] != 1
                           or arm["steady_state_cold"] != 0
                           or arm["padding_rows"] != 0):
                raise AssertionError(f"ragged arm: {arm}")
            eager_scores, eager = run_ragged_arm(
                d, fetch, ragged, _gpu_place(), waves, counter,
                capture=False)
            graphs = (arm.get("graphs"), eager.get("graphs"))
            if graphs != (1 if ragged else len(RAGGED_SEQ_BUCKETS), 0):
                raise AssertionError(f"{name} arm: the captured and the "
                                     f"eager engine hold {graphs} graphs")
            if eager_scores != scores:
                raise AssertionError(f"{name} arm: captured and eager "
                                     f"scores differ")
            arm["eager"] = eager
            arm["captured_eager_scores_equal"] = True
            arms[name] = arm
            cpu_scores, _ = run_ragged_arm(d, fetch, ragged,
                                           fluid.CPUPlace(), waves[:1])
            err = float(np.abs(np.asarray(scores[0])
                               - np.asarray(cpu_scores[0])).max())
            if not err < RAGGED_SCORE_ATOL:
                raise AssertionError(f"{name} arm: card vs CPU scores differ "
                                     f"by {err} >= {RAGGED_SCORE_ATOL}")
            parity[name] = dict(score_max_abs_err=err,
                                atol=RAGGED_SCORE_ATOL,
                                requests=len(scores[0]))
    return arms, parity


def wave_readings(arms):
    """Each Engine arm's profiled wave, captured and eager: device busy
    time and events, the launch API calls, and K6's share of them."""
    keys = ("device_busy_ms", "device_events", "wall_profiled_ms",
            "device_idle_share", "launch_api_calls",
            "ragged_fwd_kernel_device_ms", "ragged_fwd_kernel_events")
    out = {}
    for name, a in arms.items():
        for mode, arm in (("captured", a), ("eager", a.get("eager"))):
            if arm is not None:
                prof = arm["profile_one_wave"]
                out[f"{name}_{mode}"] = {k: prof[k] for k in keys
                                         if k in prof}
    return out


# ---------------------------------------------------------------------------
# phases 14-16: the default graph passes on the unfused BERT-base step
# (fuse_attention sends the composed attention to K1-K3), the predictor
# over a saved unfused BERT-base encoder, and the decode lane with int8
# weights
# ---------------------------------------------------------------------------

# (arm, FLAGS_graph_passes): the reference's passes A/B rung
PASS_ARMS = (("on", "default"), ("off", "none"))
AB_WARMUP, AB_STEPS = 2, 6
# the passes the train, decode, Engine and dp paths must not match (they
# are built fused, or run paged and ragged attention)
NEW_PASSES = ("fuse_attention", "fuse_softmax_cross_entropy")
PRED_BATCH, PRED_SEQ, PRED_RUNS = 8, 128, 10
# the predictor with the passes on vs off, fp32: K1's tiles against
# cuBLAS's products, 12 layers deep
PRED_ATOL = 1e-4


@contextlib.contextmanager
def graph_passes(spec):
    """FLAGS_graph_passes = ``spec`` inside: a program's passes are
    chosen at its first run, and every run reads the flag again (a
    changed selection warns and rewrites nothing)."""
    from paddle_tpu_torch import fluid

    old = fluid.get_flags("FLAGS_graph_passes")
    fluid.set_flags({"FLAGS_graph_passes": spec})
    try:
        yield
    finally:
        fluid.set_flags(old)


def check_no_new_sites(what, *programs):
    """The paths of phases 1-13 match none of this slice's passes."""
    for p in programs:
        sites = {e["pass"]: e["sites"]
                 for e in getattr(p, "_pass_report", None) or ()}
        hit = {k: sites[k] for k in NEW_PASSES if sites.get(k)}
        if hit:
            raise AssertionError(f"{what}: the passes matched {hit}")
    return {k: 0 for k in NEW_PASSES}


def _unfused_base(**kw):
    """BertConfig.base as the reference's passes A/B rung builds it
    (bench.py:1298-1316): no flash attention, no dropout."""
    from paddle_tpu_torch.models import bert

    return bert.BertConfig.base(vocab_size=30528, attn_dropout=0.0,
                                hidden_dropout=0.0, use_flash_attention=False,
                                **kw)


def _no_launches(names):
    return dict.fromkeys(names, 0)


def run_passes_ab(counters):
    """Unfused BERT-base, b128 s128, bf16 policy, Adam: a program an arm
    (passes on and off), each run by the captured and the eager
    executor, all four in turns from one starting state.  On arm: the
    pass report reads 12 attention sites (12 with a key bias) and 13
    bias-GeLU sites, and every run launches K1-K4 as phase 4's step;
    off arm: none.  Each arm's captured and eager losses and state
    bit-equal."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = _unfused_base()
    progs = {a: _bert_program(cfg, bf16=True) for a, _ in PASS_ARMS}
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(progs["on"][1], scope=scope)
    scopes = {(a, m): _clone_scope(scope) for a, _ in PASS_ARMS
              for m, _ in MODES}
    del scope
    exes = {a: _executors() for a, _ in PASS_ARMS}
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    per_run = {"on": _train_step_launches(cfg),
               "off": _no_launches(counters)}
    cells = [(a, spec, m) for a, spec in PASS_ARMS for m, _ in MODES]
    losses = {c[::2]: [] for c in cells}
    secs = {c[::2]: [] for c in cells}
    peak = {c[::2]: 0 for c in cells}
    transient = {c[::2]: 0 for c in cells}
    pools = {}
    launches = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    on_card = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    steps = AB_WARMUP + AB_STEPS
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for i in range(steps):
        for a, spec, m in cells:  # in turns
            main, _, loss = progs[a]
            pool0 = graph_pools_gb() if i == 0 else None
            torch.cuda.reset_peak_memory_stats()
            rest = torch.cuda.memory_allocated()
            before = _snap()
            t0 = time.perf_counter()
            with graph_passes(spec):
                (lv,) = exes[a][m].run(main, feed=feed, fetch_list=[loss],
                                       scope=scopes[a, m])
            secs[a, m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[a][m], py)
            _add(on_card[a][m], dev)
            if i == 0 and m == "captured":
                pools[a] = graph_pools_gb() - pool0
            if i >= AB_WARMUP:
                hi = torch.cuda.max_memory_allocated()
                peak[a, m] = max(peak[a, m], hi)
                transient[a, m] = max(transient[a, m], hi - rest)
            losses[a, m].append(float(lv))
    out = {}
    for a, spec in PASS_ARMS:
        main = progs[a][0]
        _gate_launches(f"passes {a}", launches[a], on_card[a], per_run[a],
                       steps, 1)
        types = [op.type for op in main.global_block().ops]
        report = getattr(main, "_pass_report", None)
        if a == "on":
            sites = {e["pass"]: (e["sites"], e.get("bias_sites"))
                     for e in report}
            want = {"fuse_attention": (12, 12),
                    "fuse_bias_act_dropout": (13, None),
                    "fuse_softmax_cross_entropy": (0, None)}
            if sites != want or types.count("flash_attention") != 12 \
                    or types.count("flash_attention_grad") != 12:
                raise AssertionError(f"passes on: report {sites}, "
                                     f"{types.count('flash_attention')} "
                                     f"flash_attention ops")
        elif report is not None or "flash_attention" in types:
            raise AssertionError("passes off: the program was rewritten")
        for m, _ in MODES:
            if not all(np.isfinite(losses[a, m])) \
                    or not losses[a, m][-1] < losses[a, m][0]:
                raise AssertionError(f"passes {a} {m}: losses not finite "
                                     f"and falling: {losses[a, m]}")
        diff = _scope_diff(scopes[a, "captured"], scopes[a, "eager"])
        if losses[a, "captured"] != losses[a, "eager"] or diff:
            raise AssertionError(f"passes {a}: captured and eager differ: "
                                 f"state {diff[:5]}")
        modes = {}
        for m, _ in MODES:
            timed = np.asarray(secs[a, m][AB_WARMUP:])
            modes[m] = dict(
                step_p50_ms=1e3 * float(np.percentile(timed, 50)),
                step_p95_ms=1e3 * float(np.percentile(timed, 95)),
                tokens_per_s=(TRAIN_BATCH * TRAIN_SEQ * AB_STEPS
                              / float(timed.sum())),
                first_step_s=secs[a, m][0],
                peak_memory_gb=peak[a, m] / 1e9,
                step_transient_gb=transient[a, m] / 1e9,
                launches=launches[a][m], device_launches=on_card[a][m])
        modes["captured"]["graph_pool_gb"] = pools[a]
        out[a] = dict(flags=spec, pass_report=report, ops=len(types),
                      losses=losses[a, "captured"],
                      captured_eager_bit_equal=True, modes=modes,
                      launches=_summed(launches[a]),
                      device_launches=_summed(on_card[a]))
    rel = max(abs(x - y) / abs(y) for x, y in zip(
        losses["on", "captured"], losses["off", "captured"]))
    path = dict(model="BertConfig.base(vocab_size=30528, "
                "use_flash_attention=False, dropout 0)",
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, dtype_policy="bf16",
                steps=AB_STEPS, warmup_steps=AB_WARMUP, arms=out,
                on_off_loss_max_rel_diff_bf16=rel)
    state = dict(progs=progs, exes=exes, scopes=scopes, feed=feed)
    return state, path


def profile_passes_ab(state):
    """One profiled step of each arm in each mode: device busy, idle,
    events, launch API calls and the top device kernels."""
    out = {}
    for a, spec in PASS_ARMS:
        main, _, loss = state["progs"][a]
        for m, _ in MODES:
            exe, scope = state["exes"][a][m], state["scopes"][a, m]

            def step():
                exe.run(main, feed=state["feed"], fetch_list=[loss],
                        scope=scope)

            with graph_passes(spec):
                r = _profile(step, 1)
            out[f"{a}_{m}"] = {k: r[k] for k in (
                "device_busy_ms", "device_idle_share", "wall_profiled_ms",
                "device_events", "launch_api_calls", "top_device_us")
                if k in r}
    return out


def run_passes_parity(counters):
    """Full width, 2 layers, b8 s128, fp32, 3 Adam steps on the card,
    passes on against off from one state: losses within 1e-4 relative;
    on the card K1 4, K2 2, K3 2, K4 3 a step on arm, none off arm."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = _unfused_base(num_layers=2)
    progs = {a: _bert_program(cfg, bf16=False) for a, _ in PASS_ARMS}
    start = fluid.Scope()
    fluid.Executor(_gpu_place()).run(progs["on"][1], scope=start)
    feed = bert.make_fake_batch(cfg, 8, 128, seed=1)
    want = {"on": _train_step_launches(cfg), "off": _no_launches(counters)}
    losses, on_card = {}, {}
    for a, spec in PASS_ARMS:
        main, _, loss = progs[a]
        scope = _clone_scope(start)
        exe = fluid.Executor(_gpu_place())
        before = _snap()
        with graph_passes(spec):
            losses[a] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]) for _ in range(3)]
        on_card[a] = _since(before, counters)[1]
        if on_card[a] != _times(want[a], 3):
            raise AssertionError(f"passes parity {a}: {on_card[a]} on the "
                                 f"card, expected 3 x {want[a]}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses["on"],
                                                  losses["off"]))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"passes parity: losses {losses}, max rel diff "
                             f"{rel} >= {TRAIN_LOSS_RTOL}")
    return dict(losses=losses, loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, device_launches=on_card)


def save_unfused_encoder(dirname):
    """BERT-base's encoder built unfused (is_test: no dropout), seeded
    random weights made on the card, saved with save_inference_model."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = _unfused_base()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds = [fluid.data(n, [-1, -1], False, dtype=dt)
                 for n, dt in (("src_ids", "int64"), ("pos_ids", "int64"),
                               ("sent_ids", "int64"),
                               ("input_mask", "float32"))]
        enc = bert.bert_encoder(*feeds, cfg, is_test=True)
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, [f.name for f in feeds], [enc],
                                  exe, main_program=main, scope=scope)
    feed = bert.make_fake_batch(cfg, PRED_BATCH, PRED_SEQ, seed=2)
    return cfg, {f.name: feed[f.name] for f in feeds}


def run_predictor_path(counters):
    """The saved unfused BERT-base encoder through the port's
    AnalysisPredictor on the card, b8 s128 fp32: a predictor an arm
    (passes on and off) and mode (captured and eager), all four run in
    turns.  On arm: 12 flash_attention ops in the loaded program, K1 and
    K4 12 a run on the card, K2/K3 none; off arm: none.  Captured equal
    to eager, on within 1e-4 of off."""
    import tempfile

    from paddle_tpu_torch import inference as inf

    cells = [(a, spec, m, c) for a, spec in PASS_ARMS for m, c in MODES]
    layers = 12
    per_run = {"on": {**_no_launches(counters), "flash_fwd": layers,
                      "fused_bias_act": layers},
               "off": _no_launches(counters)}
    with tempfile.TemporaryDirectory(prefix="pt_unfused_bert_") as d:
        cfg, feed = save_unfused_encoder(d)
        tensors = [inf.PaddleTensor(v, name=k) for k, v in feed.items()]
        preds = {}
        for a, spec, m, capture in cells:
            with graph_passes(spec), capture_mode(capture):
                preds[a, m] = inf.create_paddle_predictor(
                    inf.AnalysisConfig(d), place=_gpu_place())
    outs = {c[::2]: [] for c in cells}
    secs = {c[::2]: [] for c in cells}
    peak = {c[::2]: 0 for c in cells}
    launches = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    on_card = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    for w in counters.values():
        w.launches = 0
    runs = 1 + PRED_RUNS
    for i in range(runs):
        for a, spec, m, _ in cells:
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            with graph_passes(spec):
                (out,) = preds[a, m].run(tensors)
            secs[a, m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[a][m], py)
            _add(on_card[a][m], dev)
            peak[a, m] = max(peak[a, m], torch.cuda.max_memory_allocated())
            outs[a, m].append(out.as_ndarray())
    result = {}
    for a, spec in PASS_ARMS:
        _gate_launches(f"predictor {a}", launches[a], on_card[a],
                       per_run[a], runs, 1)
        types = [op.type for op in preds[a, "captured"]._program
                 .global_block().ops]
        if types.count("flash_attention") != (layers if a == "on" else 0):
            raise AssertionError(f"predictor {a}: "
                                 f"{types.count('flash_attention')} "
                                 f"flash_attention ops")
        ref = outs[a, "captured"][0]
        if ref.shape != (PRED_BATCH, PRED_SEQ, cfg.hidden_size) \
                or not np.isfinite(ref).all():
            raise AssertionError(f"predictor {a}: output {ref.shape}")
        if not all(np.array_equal(ref, o) for m, _ in MODES
                   for o in outs[a, m]):
            raise AssertionError(f"predictor {a}: runs or modes differ")
        modes = {}
        for m, _ in MODES:
            timed = np.asarray(secs[a, m][1:])
            with graph_passes(spec):
                prof = _profile(lambda: preds[a, m].run(tensors), 1)
            modes[m] = dict(
                run_p50_ms=1e3 * float(np.percentile(timed, 50)),
                run_p95_ms=1e3 * float(np.percentile(timed, 95)),
                first_run_s=secs[a, m][0], peak_memory_gb=peak[a, m] / 1e9,
                launches=launches[a][m], device_launches=on_card[a][m],
                **{k: prof[k] for k in ("device_busy_ms",
                                        "device_idle_share",
                                        "launch_api_calls") if k in prof})
        result[a] = dict(flags=spec, flash_attention_ops=types.count(
            "flash_attention"), ops=len(types), modes=modes,
            launches=_summed(launches[a]),
            device_launches=_summed(on_card[a]))
    err = float(np.abs(outs["on", "captured"][0]
                       - outs["off", "captured"][0]).max())
    if not err < PRED_ATOL:
        raise AssertionError(f"predictor: passes on vs off differ by {err} "
                             f">= {PRED_ATOL}")
    preds.clear()
    return dict(model="BertConfig.base(vocab_size=30528) encoder, unfused",
                batch=PRED_BATCH, seq_len=PRED_SEQ, dtype="float32",
                runs=PRED_RUNS, on_off_max_abs_err=err, atol=PRED_ATOL,
                captured_eager_equal=True, arms=result)


def int8w_at_rest(cfg, scope):
    """``torch.cuda.memory_allocated()`` an engine adds at rest (its
    pool and its own copy of the weights), with fp32 weights and with
    int8 weights, built on a private copy of ``scope``'s tensors so the
    fp32 originals do not count; and what the pass and the conversion
    report."""
    from paddle_tpu_torch.serving import DecodeEngine

    out = {}
    for key, int8 in (("fp32_weights", False), ("int8_weights", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        eng = DecodeEngine(cfg, scope=_clone_scope(scope), place=_gpu_place(),
                           pool_slots=8, page_size=16, max_len=1024,
                           int8_weights=int8, auto_start=False,
                           name=f"rest-{key}")
        torch.cuda.synchronize()
        out[f"{key}_at_rest_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        out["pool_gb"] = eng.pool.modeled_bytes() / 1e9
        if int8:
            out.update(eng.int8_weights)
        eng.close()
        del eng
    out["measured_saving_gb"] = (out["fp32_weights_at_rest_gb"]
                                 - out["int8_weights_at_rest_gb"])
    return out


def run_int8w_path(counters, fp32_outs):
    """Phase 6's decode lane with int8 weights (DecodeEngine(...,
    int8_weights=True)), captured then eager on copies of the same
    weights: the same ids; K4 and K5 12 a program run on the card.  The
    ids that agree with the fp32-weight lane's (``fp32_outs``) are
    counted, not gated: random full-width weights can flip a near-tie."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    cfg = _model_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    lens, prompts = _lane_workload(cfg)
    rest = int8w_at_rest(cfg, scope)
    modes, ids = {}, {}
    for m, capture in MODES:
        ids[m], modes[m], _ = _serve_lane(
            cfg, _copy_scope(scope), prompts, counters, "float32", capture,
            int8_weights=True)
        torch.cuda.empty_cache()
    if ids["captured"] != ids["eager"]:
        raise AssertionError("int8-weight decode lane: captured and eager "
                             "ids differ")
    agree = [sum(a == b for a, b in zip(x, y))
             for x, y in zip(ids["captured"], fp32_outs)]
    path = dict(int8_weights=True, requests=len(prompts),
                prompt_tokens=int(sum(lens)), at_rest=rest,
                generated_tokens=sum(len(o) for o in ids["captured"]),
                captured_eager_ids_equal=True,
                ids_equal_to_fp32_weight_lane=dict(
                    requests=sum(a == 32 for a in agree),
                    tokens=int(sum(agree)), of=32 * len(prompts)),
                modes=modes,
                launches=_summed({m: r["launches"]
                                  for m, r in modes.items()}),
                device_launches=_summed({m: r["device_launches"]
                                         for m, r in modes.items()}))
    return cfg, scope, prompts, ids["captured"], path


# ---------------------------------------------------------------------------
# phases 17-18: GPT-2 small causal-LM training (causal K1-K3 at S 1024,
# global-norm clipping, AdamW's decoupled weight decay), and its CPU parity
# with every optimizer of the training front end
# ---------------------------------------------------------------------------

GPT_BATCH, GPT_SEQ = 8, 1024
GPT_WARMUP, GPT_STEPS = 2, 10
GPT_UNFUSED_WARMUP, GPT_UNFUSED_STEPS = 2, 3
# the usual GPT-2 pretraining recipe (Radford et al. 2019; the
# Megatron and nanoGPT settings): AdamW, beta2 0.95, decoupled weight
# decay 0.1, the gradients' global norm clipped at 1.0
GPT_LR, GPT_BETA2, GPT_WEIGHT_DECAY, GPT_CLIP_NORM = 6e-4, 0.95, 0.1, 1.0
# card vs CPU, fp32, 3 steps (phase 5's rules): losses within 1e-4
# relative; for Adam's family the parameters within 3 x lr max and 1e-6
# mean abs difference (an element's update is at most about lr in size,
# and its sign can follow a gradient that is zero up to the two BLAS
# libraries' rounding); for the other optimizers, whose steps scale with
# the gradient, each parameter's change within 1e-3 of its norm.  A leaf
# whose gradient sits at the rounding floor (DP_GRAD_FLOOR of the median
# leaf's RMS: the attention key biases, whose true gradient is 0) has no
# direction to hold and is printed only
GPT_PARITY_STEPS = 3
GPT_CHANGE_RTOL = 1e-3
# the parity runs' batch and sequence: the recipe's, then each optimizer's
GPT_PARITY_SHAPE, GPT_PARITY_OPT_SHAPE = (2, 1024), (2, 256)


def gpt_config(**kw):
    """GPT-2 small (Radford et al. 2019, the 124M model; ``bench.py``'s
    gpt-base): vocab 50304 (50257 padded to a multiple of 64), hidden
    768, 12 layers, 12 heads, FFN 3072, 1024 positions, hidden dropout
    0.1, causal flash attention."""
    from paddle_tpu_torch.models import gpt

    d = dict(vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
             intermediate_size=3072, max_position=1024, hidden_dropout=0.1,
             use_flash_attention=True)
    d.update(kw)
    return gpt.GPTConfig(**d)


def gpt_train_flops_per_step(cfg, batch, seq):
    """Model FLOPs of one training step (forward and backward, 6 a
    multiply-add of the weights), T = batch x seq tokens: 6·T·(12·L·H² +
    V·H) for the layers' and the tied head's matmuls, plus 6·L·T·S·H for
    the causal attention's two products (half of the S x S pairs)."""
    t, L, h = batch * seq, cfg.num_layers, cfg.hidden_size
    return 6 * t * (12 * L * h * h + cfg.vocab_size * h) \
        + 6 * L * t * seq * h


def _gpt_program(cfg, bf16, make_opt=None):
    """build_gpt_lm with ``make_opt(fluid)`` minimizing it (default: the
    recipe's AdamW with the global-norm clip); returns (main, startup,
    loss, the clip's global-norm var name or None)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import gpt

    if make_opt is None:
        def make_opt(fl):
            return fl.optimizer.AdamW(
                learning_rate=GPT_LR, beta2=GPT_BETA2,
                weight_decay=GPT_WEIGHT_DECAY,
                grad_clip=fl.clip.GradientClipByGlobalNorm(GPT_CLIP_NORM))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss = gpt.build_gpt_lm(cfg)
        make_opt(fluid).minimize(loss)
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    norms = [op.outputs["Out"][0] for op in main.global_block().ops
             if op.type == "sqrt" and op.attrs.get("op_role") == "backward"]
    return main, startup, loss, (norms[0] if norms else None)


def _gpt_step_launches(cfg):
    """{kernel: launches} of one GPT train step: K1 twice a layer (the
    forward and the derived grad's recompute), K2 and K3 once, K4 once a
    layer (the FFN's bias + GeLU; no MLM head)."""
    L = cfg.num_layers
    return {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "fused_bias_act": L}


def _gpt_feed(cfg, batch, seq, seed=0):
    from paddle_tpu_torch.models import gpt

    return gpt.make_fake_lm_batch(cfg, batch, seq, seed=seed)


def run_gpt_train_path(counters):
    """GPT-2 small, b8 s1024, bf16 policy with fp32 masters, AdamW with
    the global-norm clip, hidden dropout 0.1, on the card: the captured
    and the eager executor in turns from the same state and feed,
    GPT_WARMUP + GPT_STEPS steps each.  Each mode's launches exact (on
    the card and in the wrappers); the two modes' losses, global norms
    and final state bit-equal; the losses finite and falling, the global
    norm finite at every step."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.observability import profiling

    cfg = gpt_config()
    main, startup, loss, gnorm = _gpt_program(cfg, bf16=True)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    feed = _gpt_feed(cfg, GPT_BATCH, GPT_SEQ)
    steps = GPT_WARMUP + GPT_STEPS
    losses = {m: [] for m in exes}
    norms = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for _ in range(steps):
        for m, exe in exes.items():  # in turns
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            lv, nv = exe.run(main, feed=feed, fetch_list=[loss, gnorm],
                             scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)  # the fetch syncs
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append(float(lv))
            norms[m].append(float(np.asarray(nv).reshape(())))
    total = {k: w.launches for k, w in counters.items()}
    _gate_launches("gpt train path", launches, on_card,
                   _gpt_step_launches(cfg), steps, 1)
    sites = check_no_new_sites("gpt train path", main)
    report = {e["pass"]: e["sites"] for e in main._pass_report}
    loss_c, norm_c = losses["captured"], norms["captured"]
    if not all(np.isfinite(loss_c)) or not loss_c[-1] < loss_c[0]:
        raise AssertionError(f"gpt train path losses not finite and "
                             f"falling: {loss_c}")
    if not all(np.isfinite(norm_c)):
        raise AssertionError(f"gpt train path: global norms {norm_c}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or norms["captured"] \
            != norms["eager"] or diff:
        raise AssertionError(f"gpt train path: captured and eager differ: "
                             f"losses {losses}, norms {norms}, state "
                             f"{diff[:5]}")
    tokens = GPT_BATCH * GPT_SEQ
    flops = gpt_train_flops_per_step(cfg, GPT_BATCH, GPT_SEQ)
    _, peak_flops, _, _ = profiling.device_peaks()
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][GPT_WARMUP:])
        modes[m] = dict(
            tokens_per_s=tokens * GPT_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * float(np.percentile(timed, 50)),
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0],
            mfu=flops / float(np.median(timed)) / peak_flops,
            peak_memory_gb=peak[m] / 1e9, launches=launches[m],
            device_launches=on_card[m])
    held = [h.graph for h in exes["captured"].compiled_for(main)]
    if held == [None]:
        raise AssertionError("gpt train path: the captured executor holds "
                             "no graph")
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    types = [op.type for op in main.global_block().ops]
    path = dict(model="GPTConfig(vocab 50304, hidden 768, 12 layers, 12 "
                "heads, FFN 3072, 1024 positions, hidden dropout 0.1, "
                "flash)", batch=GPT_BATCH, seq_len=GPT_SEQ,
                dtype_policy="bf16",
                optimizer=f"AdamW(lr {GPT_LR}, beta2 {GPT_BETA2}, weight "
                f"decay {GPT_WEIGHT_DECAY}), GradientClipByGlobalNorm("
                f"{GPT_CLIP_NORM})", steps=GPT_STEPS,
                warmup_steps=GPT_WARMUP, losses=loss_c, global_norms=norm_c,
                clip_engaged_steps=sum(n > GPT_CLIP_NORM for n in norm_c),
                captured_eager_bit_equal=True, model_flops_per_step=flops,
                mfu_peak_flops=peak_flops, ops=len(types),
                clip_ops={t: types.count(t) for t in (
                    "squared_l2_norm", "sqrt", "clip", "elementwise_div",
                    "elementwise_mul", "fill_constant")},
                pass_report=report, modes=modes, launches=total,
                device_launches=_summed(on_card), new_pass_sites=sites)
    state = dict(exes=exes, main=main, scopes=scopes, feed=feed,
                 fetch=[loss, gnorm])
    return state, path


def run_gpt_unfused(counters):
    """The same configuration built unfused (use_flash_attention=False:
    matmul, softmax_mask_fuse_upper_triangle, matmul a layer), the
    default passes on, GPT_UNFUSED_WARMUP + GPT_UNFUSED_STEPS steps
    captured: the pass report reads 12 fuse_attention sites, all causal,
    and K1-K4 launch the flash build's counts a step."""
    from paddle_tpu_torch import fluid

    cfg = gpt_config(use_flash_attention=False)
    main, startup, loss, gnorm = _gpt_program(cfg, bf16=True)
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    feed = _gpt_feed(cfg, GPT_BATCH, GPT_SEQ)
    per = _gpt_step_launches(cfg)
    steps = GPT_UNFUSED_WARMUP + GPT_UNFUSED_STEPS
    losses, norms, secs = [], [], []
    torch.cuda.synchronize()
    before = _snap()
    for _ in range(steps):
        t0 = time.perf_counter()
        lv, nv = exe.run(main, feed=feed, fetch_list=[loss, gnorm],
                         scope=scope)
        secs.append(time.perf_counter() - t0)
        losses.append(float(lv))
        norms.append(float(np.asarray(nv).reshape(())))
    got, on_card = _since(before, counters)
    report = {e["pass"]: e for e in main._pass_report}
    att = report["fuse_attention"]
    types = [op.type for op in main.global_block().ops]
    want = (_times(per, 2), _times(per, steps))
    if (att["sites"], att.get("causal_sites"), att.get("bias_sites")) \
            != (cfg.num_layers, cfg.num_layers, 0) \
            or types.count("flash_attention") != cfg.num_layers \
            or "softmax_mask_fuse_upper_triangle" in types \
            or (got, on_card) != want:
        raise AssertionError(f"gpt unfused: report {att}, launches {got} "
                             f"(wrappers) and {on_card} (on the card) vs "
                             f"{want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt unfused: losses {losses}, global norms "
                             f"{norms}")
    timed = np.asarray(secs[GPT_UNFUSED_WARMUP:])
    return dict(model="GPTConfig as phase 17, use_flash_attention=False",
                pass_report=main._pass_report, losses=losses,
                global_norms=norms,
                step_p50_ms=1e3 * float(np.percentile(timed, 50)),
                launches=got, device_launches=on_card)


def profile_gpt_step(state):
    """One train step of each mode under torch.profiler (the path's own
    fetches, so the captured step replays its graph): device busy and
    idle, the launch API calls and the top device kernels."""
    out = {}
    for m, exe in state["exes"].items():
        out[m] = _profile(lambda: exe.run(
            state["main"], feed=state["feed"], fetch_list=state["fetch"],
            scope=state["scopes"][m]), 1)
    return out


def _gpt_parity_run(cfg, place, feed, init, make_opt, steps):
    """``steps`` fp32 steps of the GPT program minimized by
    ``make_opt(fluid)`` on ``place`` from ``init`` (None: the startup's,
    returned).  Returns the losses, ``init``, the parameters after the
    run and, with ``grads``, each parameter's first-step gradient."""
    from paddle_tpu_torch import convert, fluid

    main, startup, loss, _ = _gpt_program(cfg, bf16=False,
                                          make_opt=make_opt)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if init is None:
        init = {p.name: scope.get(p.name).cpu().numpy().copy()
                for p in main.all_parameters()}
    else:
        convert.load_params(scope, init, place, program=main)
    grads = dict(main._params_grads)
    losses, first = [], None
    for i in range(steps):
        fetch = [loss] + (list(grads.values()) if i == 0 else [])
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        if i == 0:
            first = {p: np.asarray(g, np.float64)
                     for p, g in zip(grads, out[1:])}
    final = {n: scope.get(n).cpu().numpy().astype(np.float64)
             for n in init}
    return losses, init, final, first


def _gpt_parity(cfg, batch, seq, make_opt, adam_family, lr):
    """One card-vs-CPU parity reading (see GPT_PARITY_STEPS)."""
    from paddle_tpu_torch import fluid

    feed = _gpt_feed(cfg, batch, seq, seed=1)
    gl, init, gpu, _ = _gpt_parity_run(cfg, _gpu_place(), feed, None,
                                       make_opt, GPT_PARITY_STEPS)
    cl, _, cpu, grads = _gpt_parity_run(cfg, fluid.CPUPlace(), feed, init,
                                        make_opt, GPT_PARITY_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"gpt parity: losses {gl} (card) vs {cl} "
                             f"(CPU), max rel diff {rel}")
    g_rms = {n: float(np.sqrt(np.mean(g * g))) for n, g in grads.items()}
    median = float(np.median(list(g_rms.values())))
    leaves = {}
    for n, p in gpu.items():
        p0 = init[n].astype(np.float64)
        d = np.abs(p - cpu[n])
        change = np.linalg.norm(cpu[n] - p0)
        leaves[n] = dict(
            grad_rms_to_median=g_rms[n] / median,
            held=g_rms[n] >= DP_GRAD_FLOOR * median,
            max_abs=float(d.max()), mean_abs=float(d.mean()),
            change_rel=float(np.linalg.norm((p - p0) - (cpu[n] - p0))
                             / max(change, 1e-30)))
    held = {n: r for n, r in leaves.items() if r["held"]}
    if adam_family:
        checks = (("max_abs", 3 * lr), ("mean_abs", TRAIN_PARAM_MEAN_ATOL))
    else:
        checks = (("change_rel", GPT_CHANGE_RTOL),)
    worst = {}
    for key, tol in checks:
        name = max(held, key=lambda n: held[n][key])
        worst[key] = dict(leaf=name, tol=tol, **held[name])
        if not held[name][key] <= tol:
            raise AssertionError(f"gpt parity: {key} {held[name][key]} > "
                                 f"{tol} on leaf {name}: {held[name]}")
    return dict(losses_gpu=gl, losses_cpu=cl, loss_max_rel_diff=rel,
                leaves=len(leaves), leaves_held=len(held), worst_held=worst,
                floor_leaves=sorted(set(leaves) - set(held)))


def _adam_l2_value_clip(fl):
    """Adam with L2Decay and GradientClipByValue set as every
    parameter's clip (``set_gradient_clip``: the caller clears it)."""
    fl.clip.set_gradient_clip(fl.clip.GradientClipByValue(1e-3))
    return fl.optimizer.Adam(TRAIN_LR,
                             regularization=fl.regularizer.L2Decay(1e-2))


# {name: (make_opt(fluid), Adam's family, lr)}: every optimizer the
# training front end adds, and Adam with L2Decay and GradientClipByValue;
# Adam's family at phase 5's lr
GPT_PARITY_OPTIMIZERS = {
    "LarsMomentum": (lambda fl: fl.optimizer.LarsMomentum(0.1, 0.9), False,
                     0.1),
    "Adagrad": (lambda fl: fl.optimizer.Adagrad(0.01), False, 0.01),
    "Adamax": (lambda fl: fl.optimizer.Adamax(TRAIN_LR), True, TRAIN_LR),
    "DecayedAdagrad": (lambda fl: fl.optimizer.DecayedAdagrad(0.01), False,
                       0.01),
    "Adadelta": (lambda fl: fl.optimizer.Adadelta(1.0), False, 1.0),
    "RMSProp": (lambda fl: fl.optimizer.RMSProp(1e-3, momentum=0.9), False,
                1e-3),
    "Ftrl": (lambda fl: fl.optimizer.Ftrl(0.1, l1=1e-4, l2=1e-4), False,
             0.1),
    "Lamb": (lambda fl: fl.optimizer.Lamb(TRAIN_LR), True, TRAIN_LR),
    "Adam+L2Decay+ClipByValue": (_adam_l2_value_clip, True, TRAIN_LR),
}


def run_gpt_parity():
    """2 layers at full width (hidden 768, vocab 50304), fp32, dropout
    0: the recipe's AdamW with the global-norm clip at b2 s1024, then
    each optimizer of the training front end at b2 s256, 3 steps on the
    card and on a CPUPlace executor from the same parameters."""
    from paddle_tpu_torch import fluid

    cfg = gpt_config(num_layers=2, hidden_dropout=0.0)
    out = {"adamw_global_norm_clip": dict(
        batch_seq=GPT_PARITY_SHAPE, **_gpt_parity(
            cfg, *GPT_PARITY_SHAPE, None, True, GPT_LR))}
    for name, (make, adam_family, lr) in GPT_PARITY_OPTIMIZERS.items():
        try:
            out[name] = dict(batch_seq=GPT_PARITY_OPT_SHAPE, lr=lr,
                             **_gpt_parity(cfg, *GPT_PARITY_OPT_SHAPE, make,
                                           adam_family, lr))
        finally:
            fluid.clip.set_gradient_clip(None)
    return out


# ---------------------------------------------------------------------------
# phase 19: the serving fleet
# ---------------------------------------------------------------------------

FLEET_CLIENTS = 4          # client threads posting /v1/generate
FLEET_NEW_TOKENS = 32      # phase 6's budget a request
FLEET_KILL_AFTER = 4       # decode steps of the loaded failover run
FLEET_HEDGE_REQUESTS = 12
FLEET_CHILD_PROMPT = 512   # the SIGTERM child's one request
FLEET_CHILD_NEW = 200
FLEET_CHILD_KILL_AT = 16   # decode steps of it before the SIGTERM
# the reference's top-level keys of each page
FLEET_PAGE_KEYS = {
    "/healthz": ["draining", "frontend", "ok"],
    "/routerz": ["failovers", "hedge_ms", "hedges", "replicas", "retries",
                 "retry_times", "router"],
    "/servez": ["decode", "engines", "reqtrace"],
}

# The SIGTERM drill in a child process (the counterpart of the JAX
# package's test_frontend_sigterm_drain_completes_inflight_subprocess):
# one replica of phase 6's weights behind a Frontend with install_drain;
# SIGTERM lands once FLEET_CHILD_KILL_AT decode steps of the one request
# ran.  The child prints its one-replica baseline, the HTTP response,
# and /healthz as polled after the signal.
_FLEET_CHILD = r"""
import json, os, signal, threading, time, urllib.error, urllib.request
import numpy as np
import chip_smoke as cs
from paddle_tpu_torch import fluid, serving
from paddle_tpu_torch.models import gpt

place = cs._gpu_place()
cfg = cs._model_config()
plen, new = cs.FLEET_CHILD_PROMPT, cs.FLEET_CHILD_NEW
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
startup.random_seed = cs.SEED
scope = fluid.Scope()
fluid.Executor(place).run(startup, scope=scope)
eng = serving.DecodeEngine(cfg, scope=scope, place=place, pool_slots=8,
                           page_size=16, max_len=1024, auto_start=False,
                           name="child")
eng.warmup()
eng.start()
prompt = np.random.RandomState(cs.SEED + 7).randint(
    1, cfg.vocab_size, plen).tolist()
base = eng.generate([prompt], new, timeout=600)[0]
fe = serving.Frontend(eng)
fe.install_drain(timeout=300, poll_s=0.02)
url = f"http://{fe.host}:{fe.port}"
out = {"baseline": base}


def client():
    req = urllib.request.Request(
        url + "/v1/generate",
        data=json.dumps({"prompt": prompt, "max_new_tokens": new}).encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        out["status"] = resp.status
        out["tokens"] = json.loads(resp.read())["tokens"]


t = threading.Thread(target=client)
steps0 = eng.stats()["steps"]
t.start()
at = steps0 + cs.FLEET_CHILD_KILL_AT
while eng.stats()["steps"] < at and t.is_alive():
    time.sleep(0.0005)
out["steps_at_signal"] = eng.stats()["steps"] - steps0
os.kill(os.getpid(), signal.SIGTERM)
health = []
deadline = time.monotonic() + 60
while time.monotonic() < deadline:
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
            health.append(r.status)
    except urllib.error.HTTPError as e:
        health.append(e.code)
        if e.code == 503:
            break
    except OSError:
        health.append("closed")
        break
    time.sleep(0.002)
t.join(timeout=600)
out["healthz"] = health
out["steps_total"] = eng.stats()["steps"] - steps0
out["engine_draining"] = eng.stats()["draining"]
out["device"] = str(place.torch_device())
eng.close()
print("FLEET_CHILD " + json.dumps(out), flush=True)
"""


def _http(url, payload=None, timeout=600):
    """(status, body) of a GET (``payload`` None) or a JSON POST; the
    body parsed as JSON where it is JSON, else text."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def _generate_quantiles(reqtrace, n):
    """``reqtrace.request_quantiles``' latency / TTFT / TPOT p50 and p99
    over the completed traces whose root is ``generate`` (the ring also
    holds the /v1/infer request sent beside them), by its nearest-rank
    rule; there must be ``n``."""
    traces = [t for t in reqtrace.completed()
              if t["name"] == "generate" and t["status"] == "ok"]
    if len(traces) != n:
        raise AssertionError(f"fleet: {len(traces)} completed generate "
                             f"traces, expected {n}")
    out = {"count": len(traces)}
    for key in ("latency_s", "ttft_s", "tpot_s"):
        vs = sorted(t[key] for t in traces if t[key] is not None)
        out[key] = {f"p{int(q * 100)}": vs[min(int(q * (len(vs) - 1)
                                                   + 0.5), len(vs) - 1)]
                    for q in (0.5, 0.99)} if vs else None
    return out


def run_fleet_child():
    """Step 6 of phase 19: the SIGTERM drill in a child process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _FLEET_CHILD], cwd=here,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("FLEET_CHILD ")]
    if not lines:
        raise AssertionError(f"fleet SIGTERM child rc={proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    got = json.loads(lines[-1][len("FLEET_CHILD "):])
    tokens, base = got.pop("tokens", None), got.pop("baseline")
    got.update(returncode=proc.returncode, seconds=time.perf_counter() - t0,
               tokens_equal_baseline=tokens == base,
               tokens=len(tokens or ()))
    if not (got.get("status") == 200 and tokens == base
            and 503 in got["healthz"] and got["engine_draining"]
            and 0 < got["steps_at_signal"] < got["steps_total"]
            and got["device"].startswith("cuda")
            and proc.returncode in (0, -signal.SIGTERM)):
        raise AssertionError(f"fleet SIGTERM child: {got}")
    return got


def run_fleet_path(counters):
    """Phase 19 (see the module docstring): two DecodeEngine replicas of
    GPTConfig() and the ragged Engine behind a Router and a Frontend on
    127.0.0.1, driven over HTTP.  ``counters``: the wrappers of K4, K5,
    K6 and K7, set to 0 before the fleet is built and read after it is
    closed.  Returns the phase's readings; every step is gated."""
    import concurrent.futures as cf
    import tempfile

    from paddle_tpu_torch import fluid, serving
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.observability import exposition, reqtrace
    from paddle_tpu_torch.serving import drill

    t_phase = time.perf_counter()
    place = _gpu_place()
    cfg = _model_config()
    out = {}
    for w in counters.values():
        w.launches = 0
    before = _snap()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope0 = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope0)
    scope1 = fluid.Scope()  # replica 1's: replica 0's arrays, copied
    for p in main.all_parameters():
        scope1.set(p.name, scope0.get(p.name).clone())
    reps = [serving.DecodeEngine(
        cfg, scope=s, place=place, pool_slots=8, page_size=16,
        max_len=min(1024, cfg.max_position), auto_start=False,
        name=f"replica{i}", max_queue=64, drain_on_sigterm=False)
        for i, s in enumerate((scope0, scope1))]
    for r in reps:  # both programs of both captured before either starts
        r.warmup()
    for r in reps:
        r.start()
    r0, r1 = reps
    tmp = tempfile.TemporaryDirectory(prefix="pt_fleet_model_")
    fetch = save_ragged_model(tmp.name)
    eng = serving.Engine(batch_buckets=[RAGGED_BATCH],
                         seq_buckets=RAGGED_SEQ_BUCKETS, max_wait_ms=5,
                         auto_start=False, name="fleet_engine", place=place)
    eng.load_model("scorer", tmp.name, ragged=True)
    eng.warmup()
    eng.start()
    router = serving.Router([r0, r1, eng], name="fleet", hedge_ms=0,
                            probe_interval_ms=20)
    fe = serving.Frontend(router)
    pages = exposition.MetricsServer(port=0)
    base = f"http://{fe.host}:{fe.port}"
    pool = cf.ThreadPoolExecutor(FLEET_CLIENTS)
    wave_pool = cf.ThreadPoolExecutor(RAGGED_BATCH)

    def http_generate(prompt, n):
        """A Future of one /v1/generate's tokens (raises on non-200)."""
        def call():
            code, body = _http(f"{base}/v1/generate",
                               {"prompt": prompt, "max_new_tokens": n})
            if code != 200:
                raise AssertionError(f"/v1/generate {code}: {body}")
            return body["tokens"]
        return pool.submit(call)

    def http_infer(model, feed):
        def call():
            code, body = _http(f"{base}/v1/infer", {
                "model": model,
                "feed": {k: v.tolist() for k, v in feed.items()}})
            if code != 200:
                raise AssertionError(f"/v1/infer {code}: {body}")
            return np.asarray(body["outputs"][fetch], np.float32)
        return wave_pool.submit(call)

    try:
        # step 1: phase 6's 16 requests over HTTP from 4 client threads,
        # against a one-replica generate of the same prompts
        lens, prompts = _lane_workload(cfg)
        t0 = time.perf_counter()
        baseline = r0.generate(prompts, FLEET_NEW_TOKENS, timeout=900)
        direct_s = time.perf_counter() - t0
        reqtrace.reset()
        waves = ragged_waves(1 + RAGGED_WAVES)
        # a model the Engine has not run yet, loaded now: its first
        # request captures its graph while decode traffic replays
        eng.load_model("scorer_cold", tmp.name, ragged=True)
        steps0 = r0.stats()["steps"] + r1.stats()["steps"]
        t0 = time.perf_counter()
        futs = [http_generate(p, FLEET_NEW_TOKENS) for p in prompts]
        while (r0.stats()["steps"] + r1.stats()["steps"] < steps0 + 8
               and not all(f.done() for f in futs)):
            time.sleep(0.001)
        live = r0.load() + r1.load()
        if live == 0:
            raise AssertionError("fleet: no decode sequence was live when "
                                 "the cold model's request was sent")
        cold = http_infer("scorer_cold", waves[0][0])
        outs = [f.result(timeout=900) for f in futs]
        http_s = time.perf_counter() - t0
        cold_scores = cold.result(timeout=300)
        warm_scores = eng.infer("scorer", waves[0][0], timeout=300)[fetch]
        quant = _generate_quantiles(reqtrace, len(prompts))
        if outs != baseline:
            raise AssertionError("fleet: HTTP streams differ from the "
                                 "one-replica baseline at requests "
                                 f"{[i for i, (a, b) in enumerate(zip(outs, baseline)) if a != b]}")
        if not np.array_equal(cold_scores, warm_scores):
            raise AssertionError("fleet: the lazily captured model's scores "
                                 "differ from the warm model's")
        gen = sum(len(o) for o in outs)
        # the HTTP path's own cost: one request alone, direct and over
        # HTTP, on the same replica (the router's least-loaded pick)
        t0 = time.perf_counter()
        alone = r1.submit(prompts[0], FLEET_NEW_TOKENS).result(timeout=300)
        alone_direct = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone_http = http_generate(prompts[0], FLEET_NEW_TOKENS).result(300)
        alone_http_s = time.perf_counter() - t0
        if alone != baseline[0] or alone_http != baseline[0]:
            raise AssertionError("fleet: a lone request differs from the "
                                 "baseline")
        out["generate"] = dict(
            requests=len(prompts), prompt_tokens=int(sum(lens)),
            generated_tokens=gen, wall_s=http_s,
            tokens_per_s_http=gen / http_s,
            tokens_per_s_one_replica_direct=gen / direct_s,
            request_quantiles=quant, token_equal_baseline=True,
            lone_request_s={"direct": alone_direct, "http": alone_http_s},
            http_added_ms_per_token=1e3 * (alone_http_s - alone_direct)
            / FLEET_NEW_TOKENS,
            cold_capture_beside_live_decode=dict(
                live_sequences=live, scores_equal_warm_model=True))

        # step 2: the failover drill through the frontend
        fail = drill.failover_drill(
            engines=[r0, r1], prompts=prompts,
            max_new_tokens=FLEET_NEW_TOKENS, kill_after=FLEET_KILL_AFTER,
            baseline=baseline, router=router, submit=http_generate,
            timeout_s=900)
        trace = fail["failed_over_trace"]
        if not fail["ok"] or trace["root"] != "generate":
            raise AssertionError(f"fleet failover drill: {fail}")
        # the printed trace: its spans but the decode-step batch spans,
        # which are counted
        trace["batch_spans"] = sum(k == "batch" for k, _, _ in
                                   trace["spans"])
        trace["spans"] = [sp for sp in trace["spans"] if sp[0] != "batch"]
        out["failover"] = fail

        # step 3: the hedge drill (two Engines of a small MLP, one slow)
        hedge = drill.hedge_drill(n_requests=FLEET_HEDGE_REQUESTS,
                                  place=place)
        if not hedge["ok"]:
            raise AssertionError(f"fleet hedge drill: {hedge}")
        out["hedge"] = hedge

        # step 4: phase 10's waves over /v1/infer against a direct infer
        def direct_wave(feeds):
            fs = [eng.submit("scorer", f) for f in feeds]
            return [f.result(timeout=300)[fetch] for f in fs]

        t0 = time.perf_counter()
        http_scores = [[f.result(timeout=300) for f in
                        [http_infer("scorer", fd) for fd in feeds]]
                       for feeds in waves]
        infer_s = time.perf_counter() - t0
        direct_scores = [direct_wave(feeds) for feeds in waves]
        same = all(a.dtype == b.dtype and np.array_equal(a, b)
                   for hw, dw in zip(http_scores, direct_scores)
                   for a, b in zip(hw, dw))
        if not same or not np.isfinite(np.concatenate(
                [np.ravel(a) for w in http_scores for a in w])).all():
            raise AssertionError("fleet: /v1/infer scores differ from a "
                                 "direct Engine.infer")
        out["infer"] = dict(waves=len(waves),
                            requests=sum(len(w) for w in waves),
                            wall_s=infer_s, scores_bit_equal=True)

        # step 5: the pages
        got = {}
        for path, url in (("/healthz", base), ("/routerz", base),
                          ("/servez", f"http://127.0.0.1:{pages.port}"),
                          ("/metricsz", f"http://127.0.0.1:{pages.port}"),
                          ("/tracez", f"http://127.0.0.1:{pages.port}")):
            code, body = _http(url + path)
            if code != 200:
                raise AssertionError(f"fleet: {path} answered {code}")
            got[path] = body
        for path, keys in FLEET_PAGE_KEYS.items():
            if sorted(got[path]) != keys:
                raise AssertionError(f"fleet: {path} keys {sorted(got[path])}")
        fams = exposition.parse_text(got["/metricsz"])
        need = ("pt_serve_failovers_total", "pt_serve_recovery_seconds",
                "pt_decode_tokens_total", "pt_serve_request_latency_seconds")
        if not all(n in fams for n in need) \
                or not got["/tracez"].startswith("reqtrace"):
            raise AssertionError("fleet: /metricsz or /tracez incomplete")
        out["pages"] = dict(
            answered=sorted(got), routerz_replicas=[
                (r["name"], r["healthy"], r["breaker"])
                for r in got["/routerz"]["replicas"]],
            servez_decode=[d["engine"] for d in got["/servez"]["decode"]],
            metric_families=len(fams))
        stats_engine = eng.stats()["models"]
    finally:
        pool.shutdown(wait=True)
        wave_pool.shutdown(wait=True)
        fe.close()
        router.close()
        pages.stop()
        for r in reps:
            r.close()
        eng.close()
        tmp.cleanup()
    runs = {r.name: r.stats()["prefill_chunks"] + r.stats()["steps"] + 2
            for r in reps}

    # step 6: SIGTERM in a child process
    out["sigterm_child"] = run_fleet_child()

    # step 7: launches, by the wrappers and by the card
    k6_batches = sum(stats_engine[m]["batches"]
                     + stats_engine[m]["warmup_batches"]
                     for m in ("scorer", "scorer_cold"))
    launches = {k: w.launches for k, w in counters.items()}
    per_layer = cfg.num_layers
    want_dev = {"fused_bias_act": per_layer * sum(runs.values()),
                "paged_attention": per_layer * sum(runs.values()),
                "ragged_attention": RAGGED_LAYERS * k6_batches,
                "paged_attention_quant": 0}
    # the wrappers see each captured signature's warm-up and capture:
    # two programs a replica; the scorer's one warmed shape and the cold
    # model's one
    want_py = {"fused_bias_act": per_layer * 2 * 2 * len(reps),
               "paged_attention": per_layer * 2 * 2 * len(reps),
               "ragged_attention": RAGGED_LAYERS * 2 * 2,
               "paged_attention_quant": 0}
    out["launches"] = launches
    out["program_runs"] = runs
    out["engine_batches"] = k6_batches
    _, dev = _since(before, counters)
    out["device_launches"] = dev
    if dev != want_dev or launches != want_py:
        raise AssertionError(
            f"fleet launches: wrappers {launches} (expected {want_py}), "
            f"on the card {dev} (expected {want_dev})")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# what ``--only`` selects: {key: (kernel libraries, phase-3 checks)};
# "engine" runs phases 10-11 (the ragged Engine, both arms) instead,
# "passes", "predictor" and "int8w" phases 14, 15 and 16 ("predictor"
# with phase 3's fp32 K1 at its shape), "gpt" phase 3's K1-K4 checks
# (GPT-2 small's shapes among them) and phases 17-18, and "fleet" phase
# 19
ONLY = {"k4": (("fused_bias_act",), ("check_bias_gelu",
                                     "check_bias_gelu_bf16")),
        "k6": (("ragged_attention",), ("check_ragged",)),
        "k6_contract": (("ragged_attention",), ("check_ragged_contract",)),
        "engine": (("ragged_attention",), ()),
        "passes": (("flash_attention", "fused_bias_act"), ()),
        "predictor": (("flash_attention", "fused_bias_act"),
                      ("check_flash_fp32_predictor",)),
        "int8w": (("fused_bias_act", "paged_attention"), ()),
        "gpt": (("flash_attention", "fused_bias_act"),
                ("check_flash", "check_bias_gelu_bf16")),
        "fleet": (("fused_bias_act", "paged_attention", "ragged_attention"),
                  ())}
NEW_PHASES = ("passes", "predictor", "int8w", "gpt", "fleet")
# the kernels phase 19 counts: K4, K5 and K6 on its path, K7 off it
FLEET_KERNELS = ("fused_bias_act", "paged_attention", "ragged_attention",
                 "paged_attention_quant")


def run_new_phases(wrappers, train_kernels, fp32_outs, smi, say,
                   keys=NEW_PHASES):
    """Phases 14-19 (those of ``keys``); returns their path readings
    (None for a phase not run).  Phase 16's ids are compared with
    ``fp32_outs``, the fp32-weight lane's, where given (printed, not
    gated)."""
    ab = pred = path_w = gpt = fleet = None
    if "passes" in keys:
        counters = {k: wrappers[k] for k in train_kernels}
        state, ab = run_passes_ab(counters)
        say("passes ab path", {"card": smi, **ab})
        say("passes ab step", {"card": smi, **profile_passes_ab(state)})
        del state
        torch.cuda.empty_cache()
        say("passes ab parity", run_passes_parity(counters))
    if "predictor" in keys:
        pred = run_predictor_path({k: wrappers[k] for k in train_kernels})
        say("predictor path", {"card": smi, **pred})
        torch.cuda.empty_cache()
    if "int8w" in keys:
        counters = {k: (wrappers[k], 1)
                    for k in ("fused_bias_act", "paged_attention")}
        cfg, scope, prompts, outs, path_w = run_int8w_path(
            counters, fp32_outs or [[]] * 16)
        say("int8 weights decode path", {"card": smi, **path_w})
        say("int8 weights decode step", {"card": smi, **profile_decode_step(
            cfg, scope, int8_weights=True)})
        say("int8 weights decode parity",
            run_parity(cfg, scope, prompts, outs, int8_weights=True))
        del scope
        torch.cuda.empty_cache()
    if "gpt" in keys:
        counters = {k: wrappers[k] for k in train_kernels}
        state, gpt = run_gpt_train_path(counters)
        say("gpt train path", {"card": smi, **gpt})
        say("gpt train step", {"card": smi, **profile_gpt_step(state)})
        del state
        torch.cuda.empty_cache()
        gpt["unfused"] = run_gpt_unfused(counters)
        say("gpt unfused path", {"card": smi, **gpt["unfused"]})
        torch.cuda.empty_cache()
        say("gpt parity", run_gpt_parity())
    if "fleet" in keys:
        torch.cuda.empty_cache()
        fleet = run_fleet_path({k: wrappers[k] for k in FLEET_KERNELS})
        g = fleet["generate"]
        say("fleet path", {"card": smi, **fleet})
        say("fleet summary", {
            "card": smi,
            "http_latency_s": g["request_quantiles"]["latency_s"],
            "http_ttft_s": g["request_quantiles"]["ttft_s"],
            "tokens_per_s_http": g["tokens_per_s_http"],
            "tokens_per_s_one_replica_direct":
                g["tokens_per_s_one_replica_direct"],
            "http_added_ms_per_token": g["http_added_ms_per_token"],
            "recovery_s": fleet["failover"]["recovery"],
            "mttr_s": fleet["failover"]["mttr_s"],
            "hedge_win_rate": fleet["hedge"]["hedge_win_rate"],
            "fleet_seconds": fleet["seconds"]})
    return ab, pred, path_w, gpt, fleet


def run_only(keys, dev, smi, say):
    """Phases 2-3 for the kernels of ``keys`` alone: their build, the
    K4/K6 build report and their checks against the plain versions."""
    from paddle_tpu_torch.kernels import _build

    from paddle_tpu_torch.kernels import kernel_wrappers

    libs = sorted({lib for k in keys for lib in ONLY[k][0]})
    say("build", {k: round(v, 2) for k, v in _build.build_all(libs).items()})
    rng = np.random.RandomState(SEED)
    timings = {}
    for k in keys:
        for check in ONLY[k][1]:
            err, timed = globals()[check](dev, rng)
            timings[check] = dict(max_abs_err=err, timings=timed)
    say("kernel timings", {"card": smi, "launch_floor_ms": launch_floor_ms(),
                           **timings})
    if "engine" in keys:
        arms, parity = run_ragged_path(kernel_wrappers()["ragged_attention"])
        say("ragged engine waves", {"card": smi, **wave_readings(arms)})
        say("ragged engine parity", parity)
    new = [k for k in keys if k in NEW_PHASES]
    if new:
        run_new_phases(kernel_wrappers(), ("flash_fwd", "flash_bwd_dq",
                                           "flash_bwd_dkv", "fused_bias_act"),
                       None, smi, say, keys=new)
    report, bf16_loop = k4_k6_build_report()  # fails on a spill
    for label, r in report.items():
        print(f"ptxas {label}: " + json.dumps(r))
    say("K4 bf16 loop", {"sass": bf16_loop})


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module docstring).")
    ap.add_argument("--only", help="comma-separated keys of ONLY (k4, k6, "
                    "k6_contract, engine, passes, predictor, int8w, gpt, "
                    "fleet): phases 1-3 for those kernels alone (engine: "
                    "phases 10-11; passes, predictor, int8w: phases 14, "
                    "15, 16; gpt: K1-K4 and phases 17-18; fleet: phase "
                    "19); the default runs every phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    from paddle_tpu_torch.kernels import _build, kernel_wrappers

    t_main = time.perf_counter()
    t_last = [t_main]

    def say(label, reading):
        """One phase's reading as a JSON line, with the script's
        elapsed seconds (the run must end within its time limit) and
        the seconds since the previous line."""
        now = time.perf_counter()
        print(f"{label} " + json.dumps(
            {**reading, "elapsed_s": now - t_main,
             "phase_s": now - t_last[0]}), flush=True)
        t_last[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = _smi()
    from paddle_tpu_torch.observability import profiling

    platform, peak_flops, peak_bw, peak_link = profiling.device_peaks()
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks ({platform}, the port's table): "
          f"{peak_flops:.4g} flop/s, {peak_bw:.4g} B/s HBM, "
          f"{peak_link:.4g} B/s link", flush=True)

    if args.only:
        run_only(args.only.split(","), dev, smi, say)
        print(smi)
        print(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"{json.dumps({k: round(v, 2) for k, v in took.items()})}",
          flush=True)
    for name in _build.sources():
        if name in ("flash_attention", "paged_attention", "fused_bias_act",
                    "ragged_attention"):
            continue  # reported kernel by kernel below
        for _, label, props in _ptxas_entries(name):
            print(f"ptxas {name}: {label}: " + json.dumps(props))
    for label, r in flash_build_report().items():
        print(f"ptxas flash_attention: {label}: " + json.dumps(r))
    for label, r in paged_build_report().items():
        print(f"ptxas paged_attention: {label}: " + json.dumps(r))
    k4k6_report, k4_loop = k4_k6_build_report()
    for label, r in k4k6_report.items():
        print(f"ptxas {label}: " + json.dumps(r))
    say("K4 bf16 loop", {"sass": k4_loop})

    rng = np.random.RandomState(SEED)
    k5_err, k5_t = check_paged(dev, rng)
    k4_err, k4_t = check_bias_gelu(dev, rng)
    k4b_err, k4b_t = check_bias_gelu_bf16(dev, rng)
    fl_err, fl_t = check_flash(dev, rng)
    k6_err, k6_t = check_ragged(dev, rng)
    k6c_err, k6c_t = check_ragged_contract(dev, rng)
    k7_err, k7_t = check_paged(dev, rng, quant=True)
    k8_err, k8_t = check_fused_update(dev, rng)
    k8g_err, k8g_t = check_fused_update_group(dev)
    k1p_err, k1p_t = check_flash_fp32_predictor(dev, rng)
    torch.cuda.empty_cache()
    for k, timed in (("K5", k5_t), ("K7", k7_t)):
        for name, t in timed.items():
            print(f"{k} {name}: split plan {t['splits']} x "
                  f"{t['pages_per_split']} pages, partials {t['workspace']} "
                  f"= {t['workspace_bytes']} bytes; {t['ms']:.4f} ms (one "
                  f"split {t['one_split_ms']:.4f})", flush=True)
    say("kernel timings", {
        "paged_attention": k5_t, "fused_bias_act": {**k4_t, **k4b_t},
        "flash": fl_t, "ragged_attention": k6_t,
        "ragged_attention_contract": k6c_t, "k4_bf16_loop_sass": k4_loop,
        "paged_attention_quant": k7_t, "fused_update": k8_t,
        "fused_update_group": k8g_t, "flash_fp32_predictor": k1p_t,
        "launch_floor_ms": launch_floor_ms(), "card": smi})

    wrappers = kernel_wrappers()
    train_kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "fused_bias_act")
    state, train = run_train_path({k: wrappers[k] for k in train_kernels})
    say("train path", {"card": smi, **train})
    say("train lookup grads", {"card": smi, **time_lookup_grads(dev)})
    say("train step", {"card": smi, **profile_train_step(state)})
    say("train run_steps", run_train_chain(state))
    del state
    torch.cuda.empty_cache()
    say("train parity", run_train_parity())

    decode_kernels = ("fused_bias_act", "paged_attention")
    cfg, scope, prompts, outs, path = run_path(
        dev, {k: (wrappers[k], 1) for k in decode_kernels})
    say("decode path", {"card": smi, **path})
    say("decode step", {"card": smi, **profile_decode_step(cfg, scope)})
    parity = run_parity(cfg, scope, prompts, outs)
    say("decode parity", parity)
    say("decode lane K5", lane_in_turns(cfg, scope, prompts, outs))
    fp32_outs = outs
    del scope
    torch.cuda.empty_cache()

    # the int8 KV pool: K4 and K7 once a layer per program run, K5 never
    int8_counts = {"fused_bias_act": 1, "paged_attention_quant": 1,
                   "paged_attention": 0}
    cfg, scope, prompts, outs, path8 = run_path(
        dev, {k: (wrappers[k], n) for k, n in int8_counts.items()},
        pool_dtype="int8")
    say("int8 decode path", {"card": smi, **path8})
    say("int8 decode step", {"card": smi, **profile_decode_step(
        cfg, scope, pool_dtype="int8")})
    say("int8 decode parity",
        run_parity(cfg, scope, prompts, outs, pool_dtype="int8"))
    say("int8 decode lane K7",
        lane_in_turns(cfg, scope, prompts, outs, pool_dtype="int8"))
    del scope
    torch.cuda.empty_cache()

    arms, ragged_parity = run_ragged_path(wrappers["ragged_attention"])
    say("ragged engine path", {"card": smi, **arms})
    say("ragged engine waves", {"card": smi, **wave_readings(arms)})
    say("ragged engine parity", ragged_parity)
    torch.cuda.empty_cache()

    dp_kernels = train_kernels + ("fused_update",)
    state, dp = run_dp_path({k: wrappers[k] for k in dp_kernels})
    say("dp train path", {"card": smi, **dp})
    say("dp train step", {"card": smi, **profile_dp_step(state)})
    del state
    torch.cuda.empty_cache()
    say("dp train parity", run_dp_parity())

    ab, pred, path_w, gpt, fleet = run_new_phases(wrappers, train_kernels,
                                                  fp32_outs, smi, say)

    dec = k5_t["decode"]
    k4 = k4b_t["[16384,3072] bf16"]
    # each path's counts over its run in both modes: the wrappers'
    # (eager runs, warm-ups and captures) and the card's (every run)
    by_path = {key: {"train": train[key], "dp_train": dp[key],
                     "decode": path[key], "decode_int8": path8[key],
                     "passes_on": ab["arms"]["on"][key],
                     "passes_off": ab["arms"]["off"][key],
                     "predictor_on": pred["arms"]["on"][key],
                     "predictor_off": pred["arms"]["off"][key],
                     "decode_int8_weights": path_w[key],
                     "gpt_train": gpt[key],
                     "gpt_unfused": gpt["unfused"][key],
                     "fleet": fleet[key],
                     **{f"engine_{k}": {"ragged_attention": a[key]
                                        + a["eager"][key]}
                        for k, a in arms.items()}}
               for key in ("launches", "device_launches")}

    def launches(name, key="launches"):
        return {p: n[name] for p, n in by_path[key].items() if name in n}

    def row(name, source, replaces, err, t, gpt_t=None, pred_t=None):
        runs = launches(name)
        on_card = launches(name, "device_launches")
        out = dict(name=name, route="cuda", source=source,
                   replaces=replaces, launches=sum(runs.values()),
                   launches_by_path=runs,
                   device_launches=sum(on_card.values()),
                   device_launches_by_path=on_card, max_abs_err=err,
                   ms=t["ms"], plain_ms=t["plain_ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                   library_ms=t.get("library_ms"))
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        if gpt_t is not None:  # the same readings at GPT-2 small's shape
            out["at_gpt_shape"] = {k: gpt_t.get(k) for k in keys}
        if pred_t is not None:  # fp32 at the predictor's shape
            out["at_predictor_shape_fp32"] = {
                k: pred_t.get(k) for k in keys + ("composed_ms",)}
        return out

    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    flash_py = "paddle_tpu/kernels/primitives/flash.py"
    kernels = [
        row("flash_fwd", flash_src, f"{flash_py}:78",
            max(fl_err["flash_fwd"], k1p_err), fl_t["flash_fwd"],
            fl_t["gpt"]["flash_fwd"], k1p_t),
        row("flash_bwd_dq", flash_src, f"{flash_py}:130",
            fl_err["flash_bwd_dq"], fl_t["flash_bwd_dq"],
            fl_t["gpt"]["flash_bwd_dq"]),
        row("flash_bwd_dkv", flash_src, f"{flash_py}:167",
            fl_err["flash_bwd_dkv"], fl_t["flash_bwd_dkv"],
            fl_t["gpt"]["flash_bwd_dkv"]),
        row("fused_bias_act", "paddle_tpu_torch/csrc/fused_bias_act.cu",
            "paddle_tpu/kernels/fused_bias_act.py:106", max(k4_err, k4b_err),
            k4, k4b_t["[8192,3072] bf16"]),
        row("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/primitives/paged.py:121", k5_err, dec),
        row("ragged_attention", "paddle_tpu_torch/csrc/ragged_attention.cu",
            "paddle_tpu/kernels/primitives/ragged.py:74", k6_err,
            k6_t["path"]),
        row("paged_attention_quant",
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/primitives/paged.py:241", k7_err,
            k7_t["decode"]),
        row("fused_update", "paddle_tpu_torch/csrc/fused_update.cu",
            "paddle_tpu/kernels/fused_update.py:322", max(k8_err, k8g_err),
            k8g_t),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
